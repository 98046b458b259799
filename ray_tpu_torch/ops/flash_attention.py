"""Fused (flash) attention: the counterpart of ray_tpu/ops/flash_attention.py.

On a CUDA tensor `flash_attention` and `flash_attention_with_lse` launch the
hand-written Hopper kernel `csrc/flash_fwd.cu` (the port of the Pallas
`_fwd_kernel`). On a CPU tensor they run the kernel's plain PyTorch version,
`reference_attention_with_lse`. Layouts are the JAX package's: q/k/v are
[batch, seq, heads, head_dim] and lse is [batch, heads, seq].

The kernel takes head_dim in {16, 32, 64, 128}, float32 or bfloat16, any
sequence length (it masks the ragged edge), causal or not, and GQA. Inputs it
does not take go to the unfused `attention_reference` on the CPU, as the JAX
package's `_pick_block` sends untileable shapes there; on CUDA they raise.
The kernel's 64 x 64 tiles are fixed when it is compiled, so the JAX
functions' block_q / block_k arguments have no counterpart here.

Forward only: the backward kernels (`_dq_kernel`, `_dkv_kernel`) belong to the
training slice.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

NEG_INF = -1e30
KERNEL_HEAD_DIMS = (16, 32, 64, 128)
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


def reference_attention_with_lse(q, k, v, *, causal: bool, scale: float):
    """Unfused (o, lse) pair, lse [b, h, s_q] fp32: the plain version of the
    flash kernel. k/v carry as many heads as q."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        q_pos = torch.arange(s.shape[2], device=s.device)[:, None]
        k_pos = torch.arange(s.shape[3], device=s.device)[None, :]
        s = torch.where(q_pos >= k_pos, s, torch.full_like(s, NEG_INF))
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


def kernel_takes(q, k, v) -> bool:
    """Whether the CUDA kernel accepts these inputs (the role of the JAX
    package's `_pick_block`)."""
    return (
        q.dtype in _KERNEL_DTYPES
        and k.dtype == q.dtype
        and v.dtype == q.dtype
        and q.shape[-1] in KERNEL_HEAD_DIMS
    )


def flash_fwd(q, k, v, *, causal: bool, scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """One flash forward: (o [b, s, h, d], lse [b, h, s] fp32).

    A CUDA tensor launches csrc/flash_fwd.cu (and counts the launch in
    `flash_fwd.launches`); a CPU tensor runs `reference_attention_with_lse`.
    """
    if q.device.type == "cpu":
        k, v = _expand_kv(q, k, v)
        return reference_attention_with_lse(q, k, v, causal=causal, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_fwd runs on cuda or cpu tensors, got {q.device}")
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
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash kernel needs contiguous q, k and v")
    if b * h > 65535:
        raise ValueError(f"batch*heads {b * h} exceeds the kernel's grid limit 65535")
    from ._build import load

    fn = load("flash_fwd").flash_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p
    ]
    fn.restype = ctypes.c_int
    o = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        flash_fwd.launches += 1
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            b, s, h, h_kv, d, _KERNEL_DTYPES[q.dtype], float(scale), int(causal), stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed: cudaError {err}")
    return o, lse


flash_fwd.launches = 0


def _check_heads(q, k):
    h, h_kv = q.shape[2], k.shape[2]
    if h % h_kv:
        raise ValueError(f"n_heads {h} not divisible by n_kv_heads {h_kv}")


def flash_attention_with_lse(q, k, v, *, causal: bool = True, scale: Optional[float] = None):
    """Fused attention over [b, s, h, d] returning (out, lse [b, h, s])."""
    _check_heads(q, k)
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if kernel_takes(q, k, v):
        return flash_fwd(q, k, v, causal=causal, scale=scale)
    if q.device.type != "cpu":
        raise ValueError(f"flash kernel does not take head_dim {q.shape[-1]} / {q.dtype}")
    k, v = _expand_kv(q, k, v)
    return reference_attention_with_lse(q, k, v, causal=causal, scale=scale)


def flash_attention(q, k, v, *, causal: bool = True, scale: Optional[float] = None):
    """Fused attention over [batch, seq, heads, head_dim] inputs; exact."""
    _check_heads(q, k)
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if kernel_takes(q, k, v):
        return flash_fwd(q, k, v, causal=causal, scale=scale)[0]
    if q.device.type != "cpu":
        raise ValueError(f"flash kernel does not take head_dim {q.shape[-1]} / {q.dtype}")
    k, v = _expand_kv(q, k, v)
    return attention_reference(q, k, v, causal=causal, scale=scale)
