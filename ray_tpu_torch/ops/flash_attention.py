"""Fused (flash) attention: the counterpart of ray_tpu/ops/flash_attention.py.

On a CUDA tensor `flash_attention` and `flash_attention_with_lse` launch the
hand-written Hopper kernels: `csrc/flash_fwd.cu` (the port of the Pallas
`_fwd_kernel`) forward, and `csrc/flash_bwd.cu` (`_dq_kernel` and
`_dkv_kernel`) backward, each on the tensor cores in bfloat16 and on FMAs in
float32, through one `torch.autograd.Function` that takes
the place of JAX's `_flash` and `_flash_lse` custom_vjps. On a CPU tensor
each kernel's plain PyTorch version runs instead. Layouts are the JAX
package's: q/k/v are [batch, seq, heads, head_dim]; lse and the backward's
delta are [batch, heads, seq] fp32.

The kernels take head_dim in {16, 32, 64, 128, 256}, float32 or bfloat16,
any sequence length (they mask the ragged edge), any batch x heads, causal
or not, and GQA. Inputs
they do not take go to the unfused `attention_reference` (plain autograd) on
the CPU, as the JAX package's `_pick_block` sends untileable shapes there;
on CUDA they raise. The kernels' tiles are fixed when they are compiled (64
x 64; the float32 backward's 32 x 32 at head_dim 256), so the JAX
functions' block_q / block_k arguments have no counterpart here.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import torch

NEG_INF = -1e30
KERNEL_HEAD_DIMS = (16, 32, 64, 128, 256)
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _causal_bias(q_len: int, k_len: int, device) -> torch.Tensor:
    q_pos = torch.arange(q_len, device=device)[:, None]
    k_pos = torch.arange(k_len, device=device)[None, :]
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return torch.where(q_pos >= k_pos, zero, torch.full_like(zero, NEG_INF))[None, None]


def attention_reference(q, k, v, *, causal: bool = True, scale: Optional[float] = None):
    """Unfused full attention (ray_tpu/parallel/ring_attention.py
    attention_reference): q/k/v [b, s, h, d] with as many kv heads as q heads."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        s = s + _causal_bias(q.shape[1], k.shape[1], q.device)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return o.to(q.dtype)


def _mask_causal(s):
    """Scores [..., s_q, s_k] with NEG_INF where a query precedes its key."""
    q_pos = torch.arange(s.shape[-2], device=s.device)[:, None]
    k_pos = torch.arange(s.shape[-1], device=s.device)[None, :]
    return torch.where(q_pos >= k_pos, s, torch.full_like(s, NEG_INF))


def reference_attention_with_lse(q, k, v, *, causal: bool, scale: float):
    """Unfused (o, lse) pair, lse [b, h, s_q] fp32, as the JAX package's
    unfused fallback computes it (P/l rounded to v's dtype): for inputs the
    kernels do not take. k/v carry as many heads as q."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        s = _mask_causal(s)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1).clamp_min(1e-30)
    lse = m + torch.log(l)
    o = torch.einsum("bhqk,bkhd->bqhd", (p / l[..., None]).to(v.dtype).float(), v.float())
    return o.to(q.dtype), lse


def _expand_kv(q, k, v):
    rep = q.shape[2] // k.shape[2]
    if rep > 1:  # jnp.repeat(k, rep, axis=2): each kv head repeated in place
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    return k, v


def reference_flash_fwd(q, k, v, *, causal: bool, scale: float, block_k: int = 64):
    """Plain version of the forward kernel (`_fwd_kernel`): (o [b, s, h, d],
    lse [b, h, s] fp32), k/v with h_kv heads. The online softmax runs over
    `block_k`-key blocks as the Pallas kernel's does (flash_attention.py:80-101):
    with m the running max, P = exp(S*scale - m) is summed into l in fp32
    unrounded and rounded to v's dtype only for P.V (:91-92), and o = acc /
    max(l, 1e-30) at the end (:100). So P rounds where the kernels round it,
    which the unfused `reference_attention_with_lse` (P/l rounded) does not."""
    kr, vr = _expand_kv(q, k, v)
    qf, kf, vf = (x.float().transpose(1, 2) for x in (q, kr, vr))  # [b, h, s, d]
    b, h, s, d = qf.shape
    m = torch.full((b, h, s), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, s), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, s, d), dtype=torch.float32, device=q.device)
    pos = torch.arange(s, device=q.device)
    for k0 in range(0, s, block_k):
        k1 = min(k0 + block_k, s)
        # Causal rows before k0 see no key of this block: for them the block
        # leaves m, l and acc exactly as they are, so it skips them.
        r0 = k0 if causal else 0
        sc = qf[:, :, r0:] @ kf[:, :, k0:k1].transpose(-1, -2) * scale
        if causal:
            sc = torch.where(pos[r0:, None] >= pos[None, k0:k1], sc, torch.full_like(sc, NEG_INF))
        m_prev = m[..., r0:]
        m_new = torch.maximum(m_prev, sc.amax(dim=-1))
        p = torch.exp(sc - m_new[..., None])
        alpha = torch.exp(m_prev - m_new)
        l[..., r0:] = l[..., r0:] * alpha + p.sum(dim=-1)
        acc[..., r0:, :] = (acc[..., r0:, :] * alpha[..., None]
                            + p.to(v.dtype).float() @ vf[:, :, k0:k1])
        m[..., r0:] = m_new
    l = l.clamp_min(1e-30)
    o = (acc / l[..., None]).transpose(1, 2).to(q.dtype)
    return o, m + torch.log(l)


def _reference_probs(q, kr, vr, lse, do, delta, causal: bool, scale: float):
    """P = exp(S*scale - lse) and dS = P o (dP - delta) * scale in fp32,
    [b, h, s_q, s_k], as the backward kernels compute them; kr/vr carry as
    many heads as q."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kr.float()) * scale
    if causal:
        s = _mask_causal(s)
    p = torch.exp(s - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), vr.float())
    return p, p * (dp - delta[..., None]) * scale


def _sum_kv_groups(x, h_kv: int):
    """[b, s, h, d] -> [b, s, h_kv, d]: sums the rep query heads of each kv
    head, heads kvh*rep .. kvh*rep+rep-1 (repeat_interleave's mapping)."""
    b, s, h, d = x.shape
    return x.reshape(b, s, h_kv, h // h_kv, d).sum(dim=3)


def reference_flash_bwd_dq(q, k, v, lse, do, delta, *, causal: bool, scale: float):
    """Plain version of the dq kernel (`_dq_kernel`): dq = dS . K with dS
    rounded to k's dtype before the product (flash_attention.py:126)."""
    kr, vr = _expand_kv(q, k, v)
    _, ds = _reference_probs(q, kr, vr, lse, do, delta, causal, scale)
    return torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).float(), kr.float()).to(q.dtype)


def reference_flash_bwd_dkv(q, k, v, lse, do, delta, *, causal: bool, scale: float):
    """Plain version of the dk/dv kernel (`_dkv_kernel`): dV = P^T . dO with P
    rounded to dO's dtype, dK = dS^T . Q with dS rounded to q's dtype
    (flash_attention.py:161, :164), each summed in fp32 over the query heads
    that share a kv head."""
    kr, vr = _expand_kv(q, k, v)
    p, ds = _reference_probs(q, kr, vr, lse, do, delta, causal, scale)
    h_kv = k.shape[2]
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(), do.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).float(), q.float())
    return _sum_kv_groups(dk, h_kv).to(k.dtype), _sum_kv_groups(dv, h_kv).to(v.dtype)


def reference_flash_bwd(q, k, v, o, lse, do, delta, *, causal: bool, scale: float):
    """Plain version of `flash_bwd`, with the same inputs: (dq, dk, dv)."""
    dq = reference_flash_bwd_dq(q, k, v, lse, do, delta, causal=causal, scale=scale)
    dk, dv = reference_flash_bwd_dkv(q, k, v, lse, do, delta, causal=causal, scale=scale)
    return dq, dk, dv


def kernel_takes(q, k, v) -> bool:
    """Whether the CUDA kernels accept these inputs (the role of the JAX
    package's `_pick_block`)."""
    return (
        q.dtype in _KERNEL_DTYPES
        and k.dtype == q.dtype
        and v.dtype == q.dtype
        and q.shape[-1] in KERNEL_HEAD_DIMS
    )


def _check_kernel_inputs(q, k, v, **like_q) -> Tuple[int, int, int, int, int]:
    """Raises on what the kernels do not take; returns (b, s, h, h_kv, d).
    `like_q` names further tensors (do, o, ...) that must match q."""
    if q.device.type != "cuda":
        raise ValueError(f"flash kernels run on cuda tensors, got {q.device}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"want q [b,s,h,d], k/v [b,s,h_kv,d]; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, s, h, d = q.shape
    h_kv = k.shape[2]
    if k.shape[0] != b or k.shape[1] != s or k.shape[3] != d or h % h_kv:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}")
    if not kernel_takes(q, k, v):
        raise ValueError(
            f"flash kernel takes head_dim in {KERNEL_HEAD_DIMS} and one dtype of "
            f"float32/bfloat16; got head_dim {d}, dtypes {q.dtype}/{k.dtype}/{v.dtype}"
        )
    for name, t in like_q.items():
        if t.shape != q.shape or t.dtype != q.dtype:
            raise ValueError(f"{name} must match q {tuple(q.shape)} {q.dtype}; got "
                             f"{tuple(t.shape)} {t.dtype}")
    tensors = (q, k, v, *like_q.values())
    if any(t.device != q.device for t in tensors):
        raise ValueError("flash kernel inputs must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("flash kernel needs contiguous inputs")
    return b, s, h, h_kv, d


def _check_row_stats(q, **stats) -> None:
    """lse / delta: contiguous fp32 [b, h, s] on q's device."""
    b, s, h, _ = q.shape
    for name, t in stats.items():
        if (tuple(t.shape) != (b, h, s) or t.dtype != torch.float32 or t.device != q.device
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous float32 [b, h, s] = {(b, h, s)} "
                             f"tensor on {q.device}; got {tuple(t.shape)} {t.dtype} {t.device}")


def _check_aligned(*tensors) -> None:
    """The bfloat16 kernels, forward and backward, copy rows 16 bytes at a
    time."""
    if tensors[0].dtype == torch.bfloat16 and any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("the bfloat16 flash kernels (forward and backward) need their "
                         "inputs (q, k, v; do for the backward) at 16-byte-aligned addresses")


def _launch(source: str, symbol: str, tensors, dims, dtype, scale: float, causal: bool) -> None:
    """Calls `symbol` of csrc/<source>.cu: its tensor pointers, then
    (B, S, H, HKV, D, dtype, scale, causal, stream), on the current stream."""
    from ._build import load

    fn = getattr(load(source), symbol)
    fn.argtypes = [ctypes.c_void_p] * len(tensors) + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p
    ]
    fn.restype = ctypes.c_int
    dev = tensors[0].device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*(t.data_ptr() for t in tensors), *dims, _KERNEL_DTYPES[dtype], float(scale),
                 int(causal), stream)
    if err != 0:
        raise RuntimeError(f"{symbol} kernel launch failed: cudaError {err}")


_LAUNCH_LOCK = threading.Lock()


def _count_launch(wrapper) -> None:
    """Adds one to `wrapper.launches`, under a lock: concurrent training
    threads (two Tune trials on one card) launch the same kernels."""
    with _LAUNCH_LOCK:
        wrapper.launches += 1


def flash_fwd(q, k, v, *, causal: bool, scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """One flash forward: (o [b, s, h, d], lse [b, h, s] fp32).

    A CUDA tensor launches csrc/flash_fwd.cu (tensor cores for bfloat16,
    FMAs for float32), counted in `flash_fwd.launches`; a CPU tensor runs
    `reference_flash_fwd`.
    """
    if q.device.type == "cpu":
        return reference_flash_fwd(q, k, v, causal=causal, scale=scale)
    b, s, h, h_kv, d = _check_kernel_inputs(q, k, v)
    _check_aligned(q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    _count_launch(flash_fwd)
    _launch("flash_fwd", "flash_fwd", (q, k, v, o, lse), (b, s, h, h_kv, d), q.dtype, scale,
            causal)
    return o, lse


def flash_bwd_dq(q, k, v, lse, do, delta, *, causal: bool, scale: float) -> torch.Tensor:
    """dq [b, s, h, d] in q's dtype: launches csrc/flash_bwd.cu's dq kernel
    (tensor cores for bfloat16, FMAs for float32) on CUDA tensors, counted in
    `flash_bwd_dq.launches`; else runs `reference_flash_bwd_dq`."""
    if q.device.type == "cpu":
        return reference_flash_bwd_dq(q, k, v, lse, do, delta, causal=causal, scale=scale)
    dims = _check_kernel_inputs(q, k, v, do=do)
    _check_row_stats(q, lse=lse, delta=delta)
    _check_aligned(q, k, v, do)
    dq = torch.empty_like(q)
    _count_launch(flash_bwd_dq)
    _launch("flash_bwd", "flash_bwd_dq", (q, k, v, do, lse, delta, dq), dims, q.dtype, scale,
            causal)
    return dq


def flash_bwd_dkv(q, k, v, lse, do, delta, *, causal: bool,
                  scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) [b, s, h_kv, d] in k's dtype: launches csrc/flash_bwd.cu's
    dk/dv kernel (tensor cores for bfloat16, FMAs for float32) on CUDA
    tensors, counted in `flash_bwd_dkv.launches`; else runs
    `reference_flash_bwd_dkv`."""
    if q.device.type == "cpu":
        return reference_flash_bwd_dkv(q, k, v, lse, do, delta, causal=causal, scale=scale)
    dims = _check_kernel_inputs(q, k, v, do=do)
    _check_row_stats(q, lse=lse, delta=delta)
    _check_aligned(q, k, v, do)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _count_launch(flash_bwd_dkv)
    _launch("flash_bwd", "flash_bwd_dkv", (q, k, v, do, lse, delta, dk, dv), dims, q.dtype,
            scale, causal)
    return dk, dv


flash_fwd.launches = 0
flash_bwd_dq.launches = 0
flash_bwd_dkv.launches = 0


# The flash forward as a registered operator, so that a selective-checkpoint
# policy (models/transformer.py, remat "attn" and "hot") sees it and can keep
# its (o, lse) from the forward: the counterpart of JAX naming them
# flash_o/flash_lse in its vjp. An (o, lse) served from that cache launches
# nothing and counts nothing in flash_fwd.launches.
@torch.library.custom_op("ray_tpu_torch::flash_fwd", mutates_args=())
def flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
                 scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    return flash_fwd(q, k, v, causal=causal, scale=scale)


@flash_fwd_op.register_fake
def _(q, k, v, causal, scale):
    b, s, h, _ = q.shape
    return torch.empty_like(q), q.new_empty((b, h, s), dtype=torch.float32)


def flash_bwd(q, k, v, o, lse, do, delta, *, causal: bool, scale: float):
    """One flash backward: (dq, dk, dv) from the forward's inputs, its output
    o and lse, the upstream gradient do and delta = sum_d(do * o) [b, h, s]
    fp32 (less any upstream dlse). q/k/v/o/do are in the model's [b, s, h, d]
    layout. The kernels read o only through delta, as JAX's
    `_flash_bwd_impl` does; each launch wrapper checks its own inputs."""
    if q.device.type == "cpu":
        return reference_flash_bwd(q, k, v, o, lse, do, delta, causal=causal, scale=scale)
    dq = flash_bwd_dq(q, k, v, lse, do, delta, causal=causal, scale=scale)
    return (dq, *flash_bwd_dkv(q, k, v, lse, do, delta, causal=causal, scale=scale))


class _FlashAttention(torch.autograd.Function):
    """The flash forward with its backward kernels: JAX's `_flash` and
    `_flash_lse` custom_vjps in one. It returns (o, lse); when only o is
    used, lse gets no gradient and delta is sum_d(do * o) alone."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float):
        o, lse = torch.ops.ray_tpu_torch.flash_fwd(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, o, lse = ctx.saved_tensors
        do = torch.zeros_like(o) if do is None else do.contiguous()
        delta = (do.float() * o.float()).sum(dim=-1).transpose(1, 2)  # [b, h, s]
        if dlse is not None:  # the lse output's gradient folds into delta
            delta = delta - dlse.float()
        dq, dk, dv = flash_bwd(q, k, v, o, lse, do, delta.contiguous(), causal=ctx.causal,
                               scale=ctx.scale)
        return dq, dk, dv, None, None


def _check_heads(q, k):
    h, h_kv = q.shape[2], k.shape[2]
    if h % h_kv:
        raise ValueError(f"n_heads {h} not divisible by n_kv_heads {h_kv}")


def flash_attention_with_lse(q, k, v, *, causal: bool = True, scale: Optional[float] = None):
    """Fused attention over [b, s, h, d] returning (out, lse [b, h, s]);
    differentiable through both."""
    _check_heads(q, k)
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if kernel_takes(q, k, v):
        return _FlashAttention.apply(q, k, v, causal, scale)
    if q.device.type != "cpu":
        raise ValueError(f"flash kernel does not take head_dim {q.shape[-1]} / {q.dtype}")
    k, v = _expand_kv(q, k, v)
    return reference_attention_with_lse(q, k, v, causal=causal, scale=scale)


def flash_attention(q, k, v, *, causal: bool = True, scale: Optional[float] = None):
    """Fused attention over [batch, seq, heads, head_dim] inputs; exact."""
    _check_heads(q, k)
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if kernel_takes(q, k, v):
        return _FlashAttention.apply(q, k, v, causal, scale)[0]
    if q.device.type != "cpu":
        raise ValueError(f"flash kernel does not take head_dim {q.shape[-1]} / {q.dtype}")
    k, v = _expand_kv(q, k, v)
    return attention_reference(q, k, v, causal=causal, scale=scale)
