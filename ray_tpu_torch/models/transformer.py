"""Decoder-only transformer (Llama-2 family): the counterpart of
ray_tpu/models/transformer.py.

Params are a plain nested dict of tensors with the JAX package's tree, key
paths and layouts: layers are stacked on a leading n_layers axis, and
weights are [d_in, d_out]. Attention takes [b, s, h, d]; the paged KV pool is
[n_layers, pages, page_tokens, kv_heads, head_dim].

Where JAX scans over the stacked layers (and returns the updated pool as a
scan output), the port runs a Python loop over layers and writes the KV pool
in place. Training (`next_token_loss`, `build_train_step`) runs each layer
under `torch.utils.checkpoint` as JAX's `jax.checkpoint` does, and updates
params in place where JAX's step is pure and donates its buffers.

Mixed precision follows the JAX package: norms and RoPE compute in fp32 and
cast back; projections cast q/k/v to cfg.dtype; logits are fp32. A bf16
product goes to cuBLAS, which accumulates in fp32 and rounds its output to
bf16 once, where XLA kept the fp32 sum (preferred_element_type) for the next
elementwise op; in float32 the two are the same computation.

On a DeviceMesh (`mesh=`) every rank passes the global tokens and computes
its part: rows over ("data", "fsdp"), positions over "seq", and, where the
params are DTensors from `parallel.shard_tree`, heads and d_ff over
"tensor" (Megatron-LM's split, as GSPMD partitions JAX's forward): each
rank reads its leaves' local shards, gathers a layer's weights over "fsdp"
where it uses them, runs the column-parallel products (wq/wk/wv,
w_gate/w_up) on its columns and the row-parallel ones (wo, w_down) on its
rows with the sum over "tensor" after them, and names every collective
(see _Shard). Nothing relies on DTensor's sharding propagation, which the
flash op and torch.utils.checkpoint do not go through.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts, noop_context_fn)

from ..ops.flash_attention import attention_reference, flash_attention
from ..parallel.collectives import (_all_reduce, all_gather, axis_index, grad_sum, tp_copy,
                                    tp_gather, tp_reduce, tp_split)
from ..parallel.mesh import axes_group, data_parallel_rank, mesh_shape
from ..parallel.pipeline import pipeline_apply, shard_stage_params, split_stacked_layers
from ..parallel.sharding import PartitionSpec, dim_axes, grad_group, local_shard, spec_of
from ..parallel.ring_attention import ring_attention
from ..parallel.ulysses import ulysses_attention

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    d_model: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 32
    d_ff: int = 11008
    max_seq_len: int = 4096
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    attn_impl: str = "full"  # "full" (flash kernel) | "naive" | "ring" | "ulysses"
    # Per-layer recompute in the backward, while grad is enabled: "dots"
    # keeps matmul outputs and recomputes the rest; "attn" keeps the flash
    # forward's output; "hot" keeps JAX's HOT_SAVE_NAMES frontier; None
    # recomputes all (_remat_layer).
    remat: bool = True
    remat_policy: Optional[str] = "dots"
    tie_embeddings: bool = False
    # GPT-J switches: "gelu" MLP has no gate projection; parallel_block sums
    # attention and MLP computed from one pre-norm into the residual.
    mlp_act: str = "swiglu"  # "swiglu" | "gelu"
    parallel_block: bool = False
    # RoPE over the first rotary_dim dims of each head (None: all of them).
    rotary_dim: Optional[int] = None
    norm_type: str = "rms"  # "rms" | "layer"
    rope_style: str = "half"  # "half" (llama rotate-half) | "interleaved" (GPT-J)

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    def replace(self, **kw) -> "TransformerConfig":
        return dataclasses.replace(self, **kw)


def llama2_7b(**overrides) -> TransformerConfig:
    return TransformerConfig().replace(**overrides)


def llama2_13b(**overrides) -> TransformerConfig:
    return TransformerConfig(
        d_model=5120, n_layers=40, n_heads=40, n_kv_heads=40, d_ff=13824
    ).replace(**overrides)


def gpt_j_6b(**overrides) -> TransformerConfig:
    """GPT-J-6B: gelu MLP (no gate), parallel attention+MLP block, RoPE on
    64 of 256 head dims in interleaved pairs, LayerNorm. Biases are not
    modeled."""
    return TransformerConfig(
        vocab_size=50400, d_model=4096, n_layers=28, n_heads=16, n_kv_heads=16,
        d_ff=16384, rope_theta=10000.0, mlp_act="gelu", parallel_block=True,
        rotary_dim=64, norm_type="layer", rope_style="interleaved",
    ).replace(**overrides)


def tiny(**overrides) -> TransformerConfig:
    """Test-sized config."""
    return TransformerConfig(
        vocab_size=256, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
        d_ff=128, max_seq_len=128, remat=False,
    ).replace(**overrides)


# ------------------------------------------------------------------ params


def param_spec(cfg: TransformerConfig) -> Params:
    """The param tree's leaves as (shape, fan_in); fan_in None marks a norm
    scale initialised to ones."""
    hd, nh, nkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    L, d, f, v = cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab_size
    mlp = {"w_up": ((L, d, f), d), "w_down": ((L, f, d), f)}
    if cfg.mlp_act == "swiglu":
        mlp = {"w_gate": ((L, d, f), d), **mlp}
    spec = {
        "embed": {"embedding": ((v, d), d)},
        "blocks": {
            "attn_norm": {"scale": ((L, d), None)},
            "attn": {
                "wq": ((L, d, nh * hd), d),
                "wk": ((L, d, nkv * hd), d),
                "wv": ((L, d, nkv * hd), d),
                "wo": ((L, nh * hd, d), nh * hd),
            },
            "mlp_norm": {"scale": ((L, d), None)},
            "mlp": mlp,
        },
        "final_norm": {"scale": ((d,), None)},
    }
    if not cfg.tie_embeddings:
        spec["lm_head"] = ((d, v), d)
    return spec


def init_params(cfg: TransformerConfig, generator: torch.Generator, device=None) -> Params:
    """Stacked-layer param tree: normal / sqrt(fan_in) weights in cfg.dtype,
    norm scales of ones. The generator lives on `device` (cuda unless the
    caller passes "cpu")."""
    from .._device import resolve_device

    dev = resolve_device(device)

    def make(leaf):
        shape, fan_in = leaf
        if fan_in is None:
            return torch.ones(shape, dtype=cfg.dtype, device=dev)
        w = torch.randn(shape, generator=generator, dtype=torch.float32, device=dev)
        return w.div_(math.sqrt(fan_in)).to(cfg.dtype)

    return map_tree(make, param_spec(cfg))


def map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree) -> List[torch.Tensor]:
    """The tree's tensors in key order (map_tree's order)."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def param_count(params: Params) -> int:
    return sum(t.numel() for t in tree_leaves(params))


def _layer_params(params: Params, i: int) -> Params:
    return map_tree(lambda t: t[i], params["blocks"])


# ------------------------------------------------------------------ layers


def rms_norm(x, scale, eps):
    var = x.float().square().mean(dim=-1, keepdim=True)
    return (x.float() * torch.rsqrt(var + eps)).to(x.dtype) * scale


def layer_norm(x, scale, eps):
    """Mean-centering LayerNorm, scale only (GPT-J's ln, bias unmodeled)."""
    xf = x.float()
    xf = xf - xf.mean(dim=-1, keepdim=True)
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * scale


def _norm(x, scale, cfg: TransformerConfig):
    if cfg.norm_type == "layer":
        return layer_norm(x, scale, cfg.norm_eps)
    return rms_norm(x, scale, cfg.norm_eps)


def rope_tables(cfg: TransformerConfig, seq_len: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    half = (cfg.rotary_dim or cfg.head_dim) // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=device) / half
    freqs = torch.pow(torch.tensor(cfg.rope_theta, dtype=torch.float32, device=device), exps)
    angles = torch.arange(seq_len, dtype=torch.float32, device=device)[:, None] * freqs[None, :]
    return torch.cos(angles), torch.sin(angles)  # [seq, rotary_dim/2]


def _rotate(x, c, s, interleave: bool):
    """x [..., rd] fp32; c/s broadcast against x[..., rd/2]."""
    if interleave:  # GPT-J: pairs are (even, odd) dims
        x1, x2 = x[..., ::2], x[..., 1::2]
        return torch.stack([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).reshape(x.shape)
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def _rope(x, c, s, cfg: Optional[TransformerConfig]):
    rd = cfg.rotary_dim if cfg is not None else None
    interleave = cfg is not None and cfg.rope_style == "interleaved"
    xf = x.float()
    if rd is not None and rd < x.shape[-1]:
        out = torch.cat([_rotate(xf[..., :rd], c, s, interleave), xf[..., rd:]], dim=-1)
    else:
        out = _rotate(xf, c, s, interleave)
    return out.to(x.dtype)


def apply_rope(x, cos, sin, cfg: Optional[TransformerConfig] = None):
    """x [b, s, h, d], cos/sin [s, rd/2]. Llama rotates the whole head
    (rotate-half); GPT-J the first rotary_dim dims in interleaved pairs."""
    return _rope(x, cos[None, :, None, :], sin[None, :, None, :], cfg)


def _apply_rope_rows(x, cos, sin, cfg: TransformerConfig):
    """RoPE for one position per batch row: x [B, h, d], cos/sin [B, rd/2]."""
    return _rope(x, cos[:, None, :].float(), sin[:, None, :].float(), cfg)


@dataclasses.dataclass(frozen=True)
class _Shard:
    """What one rank's layer computes on a mesh.

    tensor: each weight's dim split over "tensor" in this rank's shard, 1
      (columns: wq/wk/wv, w_gate/w_up; the output comes out split) or 0
      (rows: wo, w_down; partial outputs summed over "tensor"), None where
      the weight is whole (tensor = 1, plain params, or a dim the clamp
      left whole);
    heads: attention runs on this rank's head group [t h/T, (t+1) h/T), its
      kv heads [t h_kv/T, ...) (GQA's i // rep stays inside the rank), one
      kernel call per rank; otherwise q, k, v are gathered and every rank
      runs the whole call, as GSPMD does where JAX's shard_map path does
      not apply (ray_tpu/models/transformer.py:259-265);
    seq_start: the first position of this rank's "seq" shard, for "full" and
      "naive" over a "seq" split, which gather q, k, v over "seq", run one
      whole-sequence call and keep this rank's rows (the causal mask is
      top-left aligned, so a query shard against gathered keys would be
      masked wrong); None otherwise."""

    mesh: Any
    tensor: Dict[str, Optional[int]]
    heads: bool
    seq_start: Optional[int] = None


def _tensor_split(shard: Optional[_Shard], name: str) -> Optional[int]:
    return None if shard is None else shard.tensor.get(name)


def _qkv(h, ap, cfg: TransformerConfig, shard: Optional[_Shard] = None):
    """q [b, s, h, hd], k/v [b, s, h_kv, hd] in cfg.dtype; on a "tensor"
    split, this rank's head group (shard.heads: q's and, where h_kv divides,
    k/v's own; else k/v whole, repeated to h heads and split like q) or all
    heads on every rank."""
    b, s, _ = h.shape
    hd = cfg.head_dim
    names = (("wq", cfg.n_heads), ("wk", cfg.n_kv_heads), ("wv", cfg.n_kv_heads))
    columns = any(_tensor_split(shard, name) == 1 for name, _ in names)
    hc = tp_copy(h, shard.mesh) if columns else h  # one gradient sum for the three
    out = []
    for name, n in names:
        split = _tensor_split(shard, name)
        y = torch.matmul(hc if split == 1 else h, ap[name])  # this rank's columns, or all
        local = split == 1 and shard.heads and n % mesh_shape(shard.mesh)["tensor"] == 0
        if split == 1 and not local:
            y = tp_gather(y, shard.mesh)
        y = y.reshape(b, s, -1, hd)
        if shard is not None and shard.heads and not local:  # k/v whole: repeat, split
            y = tp_split(y.repeat_interleave(cfg.n_heads // n, dim=2), shard.mesh, dim=2)
        out.append(y.to(cfg.dtype))
    return tuple(out)


def _mlp_act(h, mp, cfg: TransformerConfig, shard: Optional[_Shard] = None):
    """The MLP up to w_down: the gate/up products and their activation (on
    this rank's d_ff columns where w_up is split over "tensor")."""
    hc = tp_copy(h, shard.mesh) if _tensor_split(shard, "w_up") == 1 else h
    up = torch.matmul(hc, mp["w_up"]).float()
    if cfg.mlp_act == "swiglu":
        gate = torch.matmul(hc, mp["w_gate"]).float()
        return (F.silu(gate) * up).to(cfg.dtype)
    # jax.nn.gelu defaults to the tanh approximation.
    return F.gelu(up, approximate="tanh").to(cfg.dtype)


def _row_product(x, x_split: bool, w, name: str, shard: Optional[_Shard]):
    """x @ w for wo / w_down, x split over "tensor" on its last dim or
    whole: on this rank's rows of w with the sum over "tensor", or whole."""
    if _tensor_split(shard, name) == 0:
        x = x if x_split else tp_split(x, shard.mesh)
        return tp_reduce(torch.matmul(x, w), shard.mesh)
    if x_split:
        x = tp_gather(x, shard.mesh)
    return torch.matmul(x, w)


def _mlp_down(act, mp, cfg: TransformerConfig, shard: Optional[_Shard] = None):
    split = _tensor_split(shard, "w_up") == 1
    return _row_product(act, split, mp["w_down"], "w_down", shard).to(cfg.dtype)


def _mlp(h, mp, cfg: TransformerConfig, shard: Optional[_Shard] = None):
    return _mlp_down(_mlp_act(h, mp, cfg, shard), mp, cfg, shard)


def _attention(q, k, v, cfg: TransformerConfig, shard: Optional[_Shard] = None):
    """Causal attention over [b, s, h, d]. "ring" and "ulysses" take this
    rank's sequence shard and run over the mesh's "seq" dim; "full" and
    "naive" on a "seq" split run over the whole gathered sequence."""
    if cfg.attn_impl not in ("full", "naive", "ring", "ulysses"):
        raise ValueError(f"unknown attn_impl {cfg.attn_impl!r}")
    if cfg.attn_impl in ("full", "naive") and shard is not None and shard.seq_start is not None:
        s_local = q.shape[1]
        q, k, v = (all_gather(t, shard.mesh, "seq", gather_dim=1) for t in (q, k, v))
        o = _attention(q, k, v, cfg)
        return o.narrow(1, shard.seq_start, s_local)
    if cfg.attn_impl == "full":
        return flash_attention(q, k, v, causal=True)
    rep = q.shape[2] // k.shape[2]
    if rep > 1:  # jnp.repeat(k, rep, axis=2)
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    if cfg.attn_impl == "naive":
        return attention_reference(q, k, v, causal=True)
    if shard is None:
        raise ValueError(f"attn_impl={cfg.attn_impl!r} requires a mesh")
    parallel = ring_attention if cfg.attn_impl == "ring" else ulysses_attention
    return parallel(q, k, v, shard.mesh, causal=True)


def _attn_out(o, ap, cfg: TransformerConfig, shard: Optional[_Shard] = None):
    b, s = o.shape[:2]
    heads = shard is not None and shard.heads
    return _row_product(o.reshape(b, s, -1), heads, ap["wo"], "wo", shard).to(cfg.dtype)


def _residual(x, h, attn_out, lp, cfg: TransformerConfig, shard: Optional[_Shard] = None):
    """Parallel block (GPT-J): the MLP reads the same pre-norm h as
    attention; sequential (llama): re-norm after adding attention."""
    if cfg.parallel_block:
        return x + attn_out + _mlp(h, lp["mlp"], cfg, shard)
    x = x + attn_out
    return x + _mlp(_norm(x, lp["mlp_norm"]["scale"], cfg), lp["mlp"], cfg, shard)


def _attend(x, lp, cfg: TransformerConfig, cos, sin, shard: Optional[_Shard] = None):
    """The layer up to attention: (h, o), h the attention pre-norm and o
    attention's output."""
    h = _norm(x, lp["attn_norm"]["scale"], cfg)
    q, k, v = _qkv(h, lp["attn"], cfg, shard)
    q = apply_rope(q, cos, sin, cfg)
    k = apply_rope(k, cos, sin, cfg)
    return h, _attention(q, k, v, cfg, shard)


def _layer(x, lp, cfg: TransformerConfig, cos, sin, shard: Optional[_Shard] = None):
    h, o = _attend(x, lp, cfg, cos, sin, shard)
    return _residual(x, h, _attn_out(o, lp["attn"], cfg, shard), lp, cfg, shard)


def _head(params: Params) -> torch.Tensor:
    head = params.get("lm_head")
    return params["embed"]["embedding"].T if head is None else head


# Matrix products with no batch dimension: what
# jax.checkpoint_policies.checkpoint_dots_with_no_batch_dims keeps. A
# [b, s, d] @ [d, k] projection reaches aten as mm; attention's batched
# products (bmm) and the flash kernels are recomputed.
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
# The flash forward's registered op: its (o, lse) are JAX's flash_o/flash_lse.
_FLASH = (torch.ops.ray_tpu_torch.flash_fwd.default,)

# What JAX's remat_policy="hot" saves (save_only_these_names,
# ray_tpu/models/transformer.py HOT_SAVE_NAMES). The port's "hot" keeps the
# same frontier in torch's terms (see _hot_layer).
HOT_SAVE_NAMES = (
    "flash_o",
    "flash_lse",
    "q_bf16",
    "k_bf16",
    "v_bf16",
    "attn_out_bf16",
    "mlp_in_bf16",
    "mlp_act_bf16",
)


def _saving(ops) -> Callable:
    """A selective-checkpoint context that keeps the outputs of `ops` and
    recomputes every other op."""

    def policy(ctx, op, *args, **kwargs):
        return CheckpointPolicy.MUST_SAVE if op in ops else CheckpointPolicy.PREFER_RECOMPUTE

    return functools.partial(create_selective_checkpoint_contexts, policy)


def _ckpt(fn, *args, context_fn=noop_context_fn):
    # The layer draws no random numbers, so no RNG state is stashed.
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False,
                      context_fn=context_fn)


def _hot_layer(x, lp, cfg: TransformerConfig, cos, sin, shard: Optional[_Shard] = None):
    """_layer under remat "hot": the backward recomputes the two norms, RoPE
    and the gate/up products with their activation, and nothing else, as
    JAX's save_only_these_names(*HOT_SAVE_NAMES) does.

    torch.utils.checkpoint replays a region's forward up to the last tensor
    its backward reads, running every op it holds no output of, so a saved
    tag alone would not stop the projections that feed it from running
    again. The layer is built from two checkpointed regions instead:
      - _attend keeps the q/k/v projections' outputs (before RoPE, which is
        elementwise and recomputed; JAX's q/k/v_bf16 are after it, the same
        bytes) and the flash op's (o, lse) (flash_o/flash_lse);
      - the MLP up to w_down keeps nothing: its backward recomputes the
        norm and the gate/up products from its input, the residual x +
        attn_out (JAX keeps attn_out, from which it re-adds that residual,
        and mlp_in; under the parallel block the input is h, JAX's mlp_in);
    w_o and w_down run outside both regions, so autograd keeps their inputs:
    o (already kept) and the activation (mlp_act_bf16). Per layer that is
    3 + 1 + 1 tensors of [b, s, d] and one of [b, s, d_ff] in cfg.dtype plus
    lse, one [b, s, d] fewer than JAX's frontier (mlp_in, which the port
    recomputes with the norm JAX also recomputes)."""
    h, o = _ckpt(_attend, x, lp, cfg, cos, sin, shard, context_fn=_saving(_DOTS + _FLASH))
    attn_out = _attn_out(o, lp["attn"], cfg, shard)
    if cfg.parallel_block:
        act = _ckpt(_mlp_act, h, lp["mlp"], cfg, shard)
        return x + attn_out + _mlp_down(act, lp["mlp"], cfg, shard)
    x = x + attn_out
    act = _ckpt(_normed_mlp_act, x, lp, cfg, shard)
    return x + _mlp_down(act, lp["mlp"], cfg, shard)


def _normed_mlp_act(x, lp, cfg: TransformerConfig, shard: Optional[_Shard] = None):
    return _mlp_act(_norm(x, lp["mlp_norm"]["scale"], cfg), lp["mlp"], cfg, shard)


def _remat_layer(policy: Optional[str]) -> Callable:
    """_layer under torch.utils.checkpoint with the JAX package's policy:
      None: everything recomputed, the flash forward too;
      "dots": the projections' outputs kept, the rest (flash forward
        included) recomputed;
      "attn": only the flash forward's (o, lse) kept, so it never runs
        again; every projection but w_down (whose output no backward
        reads) runs again;
      "hot": see _hot_layer.
    What each keeps per layer at Llama-2-7B width in bf16 on 2 x 2048
    tokens, besides the layer's 32 MiB input: "dots" 332 MiB (seven
    projection outputs, rounded to bf16; JAX keeps them in fp32, 664 MiB),
    "hot" 246.5 MiB (JAX's frontier: 278.5), "attn" 32.5 MiB (as JAX)."""
    if policy == "hot":
        return _hot_layer
    contexts = {None: noop_context_fn, "dots": _saving(_DOTS), "attn": _saving(_FLASH)}
    if policy not in contexts:
        raise ValueError(f"unknown remat_policy {policy!r}")
    return functools.partial(_ckpt, _layer, context_fn=contexts[policy])


BATCH_AXES = ("data", "fsdp", "seq")


def _local_shard(mesh, b: int, s: int) -> Tuple[slice, int, int, Tuple[str, ...]]:
    """This rank's part of a global [b, s] batch on `mesh`: (rows, first
    position, positions, the batch dims larger than 1). Rows go over
    ("data", "fsdp"), positions over "seq"; the other dims replicate the
    batch."""
    sizes = mesh_shape(mesh)
    n_rows, n_seq = sizes["data"] * sizes["fsdp"], sizes["seq"]
    if b % n_rows or s % n_seq:
        raise ValueError(f"batch [{b}, {s}] does not split over data x fsdp = {n_rows} and "
                         f"seq = {n_seq}")
    row = data_parallel_rank(mesh)
    seq = axis_index(mesh, "seq")
    rows = slice(row * (b // n_rows), (row + 1) * (b // n_rows))
    split = tuple(a for a in BATCH_AXES if sizes[a] > 1)
    return rows, seq * (s // n_seq), s // n_seq, split


def _gather_dims(x, spec, mesh, batch: Tuple[str, ...], keep: Tuple[str, ...] = ()):
    """A leaf's local shard -> the tensor whole on every dim not split over
    `keep`: all_gather over a batch dim (its backward reduce-scatters the
    ranks' partial gradients), tp_gather over any other (every rank there
    computes the same, so its backward keeps its slice)."""
    for d, axes in enumerate(dim_axes(spec, x.dim())):
        if any(a in keep for a in axes):
            if len(axes) > 1:
                raise NotImplementedError(f"a dim split over {axes}: the 'tensor' split of a "
                                          "weight must be alone on its dim")
            continue
        for a in reversed(axes):
            x = all_gather(x, mesh, a, gather_dim=d) if a in batch else tp_gather(
                x, mesh, a, dim=d)
    return x


# Column-parallel weights (their outputs split over "tensor"); wo and
# w_down are row-parallel (their inputs split, the outputs summed).
_COLUMN = ("wq", "wk", "wv", "w_gate", "w_up")


def _plan(params: Params, specs: Params, cfg: TransformerConfig, mesh) -> _Shard:
    """The _Shard of a forward: each weight's "tensor" split read from its
    spec (the leading layer dim dropped), and whether attention runs per
    head group: where JAX runs its shard_map (h and, for "full", h_kv
    divisible by "tensor") and q's columns are split."""
    T = mesh_shape(mesh)["tensor"]
    tensor = {}
    for group in ("attn", "mlp"):
        for name, spec in specs["blocks"][group].items():
            axes = dim_axes(spec, params["blocks"][group][name].dim())
            if any(axes[0]):
                raise NotImplementedError(f"blocks.{group}.{name}: the layer dim is split over "
                                          f"{axes[0]}")
            dims = [d for d in (1, 2) if "tensor" in axes[d]]
            split = dims[0] - 1 if dims else None
            if split is not None and split != (1 if name in _COLUMN else 0):
                raise NotImplementedError(f"blocks.{group}.{name} split over 'tensor' on its "
                                          f"{'input' if split == 0 else 'output'} dim")
            tensor[name] = split
    if tensor.get("w_gate", tensor["w_up"]) != tensor["w_up"]:
        raise NotImplementedError("w_gate and w_up split over 'tensor' differently")
    kv_ok = cfg.attn_impl != "full" or (
        cfg.n_kv_heads % T == 0 and tensor["wk"] == 1 and tensor["wv"] == 1)
    heads = T > 1 and tensor["wq"] == 1 and cfg.n_heads % T == 0 and kv_ok
    return _Shard(mesh, tensor, heads)


def _local_params(params: Params, mesh, batch: Tuple[str, ...]):
    """(this rank's shard of every leaf, each leaf's spec). With grad on,
    the shards pass through one grad_sum node that sums each leaf's
    gradient over the batch dims the leaf is not split over."""
    specs = map_tree(spec_of, params)
    leaves = [local_shard(t) for t in tree_leaves(params)]
    if torch.is_grad_enabled() and batch:
        leaves = grad_sum(leaves, [grad_group(mesh, spec, batch) for spec in tree_leaves(specs)])
    it = iter(leaves)
    return map_tree(lambda _: next(it), params), specs


def _hidden(params: Params, tokens: torch.Tensor, cfg: TransformerConfig, mesh):
    """(final-norm hidden states [batch, seq, d], the head [d, vocab] as
    used) of tokens [batch, seq]. With cfg.remat and grad enabled, each
    layer recomputes in the backward.

    With a DeviceMesh (parallel.build_device_mesh) every rank passes the
    GLOBAL tokens, as the JAX function takes the global array, and gets ITS
    part of the result: rows over ("data", "fsdp"), positions over "seq"
    (RoPE at their global positions; "full" and "naive" attend over the
    gathered sequence). Params are plain tensors (whole on every rank) or
    DTensors (parallel.shard_tree): each rank computes on its shards (see
    _Shard), gathering the embedding and the head whole. Each leaf's
    gradient is summed over the batch ranks in the backward, so every rank
    gets its shard of the global gradient."""
    b, s = tokens.shape
    if mesh is None:
        emb = params["embed"]["embedding"]
        cos, sin = rope_tables(cfg, s, emb.device)
        layer = _remat_layer(cfg.remat_policy) if cfg.remat and torch.is_grad_enabled() else _layer
        x = emb[tokens.long()]
        for i in range(cfg.n_layers):
            x = layer(x, _layer_params(params, i), cfg, cos, sin)
        return _norm(x, params["final_norm"]["scale"], cfg), _head(params)
    rows, start, s_local, batch = _local_shard(mesh, b, s)
    params, specs = _local_params(params, mesh, batch)
    shard = _plan(params, specs, cfg, mesh)
    if mesh_shape(mesh)["seq"] > 1 and cfg.attn_impl in ("full", "naive"):
        shard = dataclasses.replace(shard, seq_start=start)
    whole = functools.partial(_gather_dims, mesh=mesh, batch=batch)
    emb = whole(params["embed"]["embedding"], specs["embed"]["embedding"])
    cos, sin = rope_tables(cfg, s, emb.device)
    cos, sin = cos[start:start + s_local], sin[start:start + s_local]
    x = emb[tokens[rows, start:start + s_local].long()]
    layer = _remat_layer(cfg.remat_policy) if cfg.remat and torch.is_grad_enabled() else _layer
    for i in range(cfg.n_layers):
        lp = {g: {k: whole(t[i], PartitionSpec(*specs["blocks"][g][k][1:]), keep=("tensor",))
                  for k, t in leaves.items()} for g, leaves in params["blocks"].items()}
        x = layer(x, lp, cfg, cos, sin, shard)
    head = emb.T if "lm_head" not in params else whole(params["lm_head"], specs["lm_head"])
    return _norm(x, params["final_norm"]["scale"], cfg), head


def forward_hidden(params: Params, tokens: torch.Tensor, cfg: TransformerConfig,
                   mesh=None) -> torch.Tensor:
    """tokens [batch, seq] -> final-norm hidden states [batch, seq, d] (with a
    mesh: this rank's part, see _hidden)."""
    return _hidden(params, tokens, cfg, mesh)[0]


def forward(params: Params, tokens: torch.Tensor, cfg: TransformerConfig,
            mesh=None) -> torch.Tensor:
    """tokens [batch, seq] int -> logits [batch, seq, vocab] float32 (with a
    mesh: this rank's rows and positions, every vocab entry; see _hidden)."""
    x, head = _hidden(params, tokens, cfg, mesh)
    return torch.matmul(x, head).float()


# ------------------------------------------------------------------ train


def _nll_sum(logits, targets, m):
    nll = F.cross_entropy(logits.flatten(0, 1), targets.flatten(), reduction="none")
    return (nll.view(targets.shape) * m).sum()


def next_token_loss(params: Params, tokens: torch.Tensor, cfg: TransformerConfig, mesh=None, *,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Causal LM loss: mean cross-entropy of token t+1 given tokens <= t.

    As in the JAX package, the forward runs at full length and the last
    position is masked (not sliced off); `mask` [batch, seq] marks valid
    target tokens. With a mesh every rank passes the global tokens (and
    mask) and gets the global mean: its part's targets are the global
    targets' (a part's last target is the next part's first token), only
    the global last position is masked, and the sum and count are summed
    over the ranks that hold the other parts. The gradient each rank's
    backward computes is its own part's; forward_hidden sums the params'
    gradients over those ranks.
    """
    b, s = tokens.shape
    targets = torch.roll(tokens.long(), -1, dims=1)
    m = (torch.arange(s, device=tokens.device) < s - 1).float().expand(b, s)
    if mask is not None:
        m = m * torch.roll(mask, -1, dims=1).float()
    group = None
    if mesh is not None:
        rows, start, s_local, batch = _local_shard(mesh, b, s)
        targets, m = (t[rows, start:start + s_local] for t in (targets, m))
        group = axes_group(mesh, batch) if batch else None
    logits = forward(params, tokens, cfg, mesh)
    m = m.to(device=logits.device, dtype=logits.dtype)
    local = _nll_sum(logits, targets.to(logits.device), m)
    count = m.sum()
    if group is None:
        return local / count.clamp_min(1.0)
    total = _all_reduce(local.detach(), group)
    count = _all_reduce(count, group)
    # the global sum's value with this rank's part's gradient
    return (local + (total - local.detach())) / count.clamp_min(1.0)


def adamw(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 1e-4) -> Callable[[List[torch.Tensor]], torch.optim.Optimizer]:
    """The counterpart of `optax.adamw` with optax's defaults (weight decay
    1e-4, where torch's default is 1e-2): a factory that builds
    `torch.optim.AdamW` over a list of params. Its state (exp_avg,
    exp_avg_sq) is in the param dtype, as optax's mu_dtype=None keeps it."""

    def make(params: List[torch.Tensor]) -> torch.optim.Optimizer:
        return torch.optim.AdamW(
            params, lr=lr, betas=(b1, b2), eps=eps, weight_decay=weight_decay, amsgrad=False,
            maximize=False, foreach=None, capturable=False, differentiable=False, fused=None,
        )

    return make


def build_train_step(cfg: TransformerConfig, make_optimizer, *, device=None,
                     zero_axis: Optional[str] = None, mesh=None):
    """The train step (fwd + bwd + optimizer), the counterpart of the JAX
    package's `build_train_step(cfg, tx, mesh, zero_axis=...)`.

    Returns `(init_state, step)`:
      init_state(generator, params=None) -> (params, optimizer): params from
        `init_params` on `device` (CUDA unless the caller passes "cpu"), on
        a DeviceMesh `mesh` laid out by `parallel.shard_tree` (DTensors; or
        the caller's `params`, sharded alike), every leaf requiring grad,
        and `make_optimizer(shards)`, e.g. `adamw(1e-4)`, over each leaf's
        local shard (a DTensor's local tensor: AdamW is elementwise, and
        DTensor's op dispatch on a six-dim mesh costs more than the
        update); with `zero_axis`, the ZeRO-sharded optimizer of
        train/zero.py (`init_opt_state`) over this rank's shards instead;
      step(params, optimizer, tokens) -> loss: one step on tokens
        [batch, seq]. It updates params and optimizer state IN PLACE and
        returns the loss before the update (a 0-d tensor), where the JAX
        step is pure and donates its inputs.

    With `zero_axis` the step is train/zero.py's ZeRO-1 step over the
    torch.distributed group (the default group, or the `zero_axis` dim of
    the DeviceMesh `mesh`, which must already be initialised): each rank
    passes its own [batch/N, seq] slice of the batch and gets the loss's
    mean over ranks. Without it, `mesh` (a DeviceMesh of
    parallel.build_device_mesh) goes to next_token_loss: every rank passes
    the global batch, computes its part (rows over data x fsdp, positions
    over seq, heads and d_ff over tensor), and gets the global loss and its
    shard of the global gradient, so every rank updates its shard as JAX's
    step updates the sharded params.
    """
    from .._device import resolve_device

    dev = resolve_device(device)

    def init_leaf_params(generator: torch.Generator):
        params = init_params(cfg, generator, device=dev)
        for t in tree_leaves(params):
            t.requires_grad_(True)
        return params

    if zero_axis is not None:
        from ..train import zero

        like = map_tree(lambda leaf: torch.empty(leaf[0], dtype=cfg.dtype, device="meta"),
                        param_spec(cfg))
        zero_step, _ = zero.build_zero_step(
            lambda p, tokens: next_token_loss(p, tokens.to(dev), cfg), like, mesh,
            axis=zero_axis)

        def zero_init_state(generator: torch.Generator):
            params = init_leaf_params(generator)
            return params, zero.init_opt_state(make_optimizer, params, mesh, zero_axis)

        return zero_init_state, zero_step

    def init_state(generator: torch.Generator, params: Optional[Params] = None):
        if params is None:
            params = init_leaf_params(generator)
            if mesh is not None:
                from ..parallel.sharding import shard_tree

                params = shard_tree(params, mesh)
        for t in tree_leaves(params):
            t.requires_grad_(True)
        return params, make_optimizer(_shard_storage(params))

    def step(params: Params, optimizer: torch.optim.Optimizer, tokens: torch.Tensor):
        leaves = tree_leaves(params)
        for t in leaves:
            t.grad = None
        loss = next_token_loss(params, tokens.to(dev), cfg, mesh)
        loss.backward()
        for t, shard in zip(leaves, _shard_storage(params)):
            if shard is not t:  # a DTensor: its local gradient on its local tensor
                shard.grad = local_shard(t.grad)
        optimizer.step()
        return loss.detach()

    return init_state, step


def _shard_storage(params: Params) -> List[torch.Tensor]:
    """Each leaf's local tensor (a DTensor's own storage, read outside
    autograd; a plain tensor itself): what the train step's optimizer
    updates in place."""
    with torch.no_grad():
        return [local_shard(t) for t in tree_leaves(params)]


def flops_per_token(cfg: TransformerConfig, seq_len: int) -> float:
    """Approximate training FLOPs per token (6N + attention) for MFU, as the
    JAX package counts them: attention causally, at seq/2 visible positions
    on average, 12 * n_layers * d_model * seq/2 for fwd + bwd."""
    n_params = (
        cfg.vocab_size * cfg.d_model
        + cfg.n_layers
        * (
            2 * cfg.d_model * cfg.n_heads * cfg.head_dim
            + 2 * cfg.d_model * cfg.n_kv_heads * cfg.head_dim
            + 3 * cfg.d_model * cfg.d_ff
        )
        + (0 if cfg.tie_embeddings else cfg.d_model * cfg.vocab_size)
    )
    attn = 12 * cfg.n_layers * cfg.d_model * (seq_len / 2)
    return 6.0 * n_params + attn


def forward_pipelined(params: Params, tokens: torch.Tensor, cfg: TransformerConfig, mesh, *,
                      num_microbatches: int = 4, stage_axis: str = "stage") -> torch.Tensor:
    """Pipeline-parallel forward: the layer stack splits into S stages over
    the mesh's `stage_axis` dim, microbatches stream through the GPipe
    schedule of parallel/pipeline.py, and the backward of this function is
    the backward pipeline. Every rank passes the whole params and the global
    tokens and gets the whole logits [batch, seq, vocab]; the embedding and
    head run on every rank (they are batch-local); each rank runs only its
    stage's layers, and its blocks' gradient is gathered from every stage.
    With cfg.remat each stage recomputes its layers in the backward (JAX's
    jax.checkpoint of the stage function).

    As JAX's stage function runs with mesh=None inside a shard_map over the
    stage dim only, every other dim ("tensor" too) replicates the pipeline:
    DTensor params are gathered whole first (tp_gather: each rank keeps its
    shard of the whole gradient)."""
    S = mesh_shape(mesh)[stage_axis]
    params = map_tree(lambda t: _gather_dims(local_shard(t), spec_of(t), mesh, ()), params)
    b, s = tokens.shape
    if b % num_microbatches:
        raise ValueError(f"batch {b} not divisible into {num_microbatches} microbatches")
    emb = params["embed"]["embedding"]
    cos, sin = rope_tables(cfg, s, emb.device)
    x = emb[tokens.long()]
    stage = shard_stage_params(split_stacked_layers(params["blocks"], S), mesh, stage_axis)

    def stage_fn(local_blocks, xin):
        for i in range(cfg.n_layers // S):
            xin = _layer(xin, map_tree(lambda t: t[i], local_blocks), cfg, cos, sin)
        return xin

    mb = x.reshape(num_microbatches, b // num_microbatches, s, cfg.d_model)
    y = pipeline_apply(stage_fn, stage, mb, mesh, axis=stage_axis, remat=cfg.remat)
    x = _norm(y.reshape(b, s, cfg.d_model), params["final_norm"]["scale"], cfg)
    return torch.matmul(x, _head(params)).float()


def next_token_loss_pipelined(params: Params, tokens: torch.Tensor, cfg: TransformerConfig,
                              mesh, *, num_microbatches: int = 4) -> torch.Tensor:
    """next_token_loss over forward_pipelined (its backward is the backward
    pipeline); every rank gets the loss and the whole gradient."""
    logits = forward_pipelined(params, tokens, cfg, mesh, num_microbatches=num_microbatches)
    b, s = tokens.shape
    targets = torch.roll(tokens.long(), -1, dims=1).to(logits.device)
    m = (torch.arange(s, device=logits.device) < s - 1).float().expand(b, s)
    return _nll_sum(logits, targets, m) / m.sum().clamp_min(1.0)


# ------------------------------------------------------------ paged decode
#
# The KV cache is a pool of fixed-size pages shared by every sequence.
# Prefill writes a sequence's k/v into the pages its block table names;
# decode gathers them back, attends over them and appends the new position.
# Page 0 is a trash page: masked writes (inactive slots, positions past a
# sequence's length, shared prefix pages owned by the radix cache) go there,
# with duplicate indices, so their order is undefined. Trash contents are
# never read: the attention mask stops at each sequence's length.

TRASH_PAGE = 0


def init_kv_pages(cfg: TransformerConfig, num_pages: int, page_tokens: int, device=None):
    """The paged KV pool: k/v of shape
    [n_layers, num_pages, page_tokens, n_kv_heads, head_dim]."""
    from .._device import resolve_device

    dev = resolve_device(device)
    shape = (cfg.n_layers, num_pages, page_tokens, cfg.n_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
        "v": torch.zeros(shape, dtype=cfg.dtype, device=dev),
    }


def forward_prefill(
    params: Params,
    tokens: torch.Tensor,
    cfg: TransformerConfig,
    kv_pages: Dict[str, torch.Tensor],
    block_table: torch.Tensor,
    length: int,
    write_from: int,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Prefill ONE sequence and write its k/v into the paged pool in place.

    tokens [1, S] (padded to a bucket), block_table [P] page indices,
    length: true prompt length (<= S), write_from: first position to write
    (positions below it sit in shared prefix pages already written).
    Returns (last-position logits [1, vocab] fp32, kv_pages).
    """
    S = tokens.shape[1]
    T = kv_pages["k"].shape[2]
    dev = tokens.device
    cos, sin = rope_tables(cfg, S, dev)
    x = params["embed"]["embedding"][tokens.long()]

    pos = torch.arange(S, device=dev)
    writable = (pos >= write_from) & (pos < length)
    # Indices clamp like jnp's gather: a block table shorter than S/T
    # repeats its last page.
    page_idx = (pos // T).clamp_max(block_table.shape[0] - 1)
    dest_page = torch.where(writable, block_table.long()[page_idx], TRASH_PAGE)
    dest_slot = pos % T

    for i in range(cfg.n_layers):
        lp = _layer_params(params, i)
        h = _norm(x, lp["attn_norm"]["scale"], cfg)
        q, k, v = _qkv(h, lp["attn"], cfg)
        q = apply_rope(q, cos, sin, cfg)
        k = apply_rope(k, cos, sin, cfg)
        kv_pages["k"][i][dest_page, dest_slot] = k[0]
        kv_pages["v"][i][dest_page, dest_slot] = v[0]
        o = _attention(q, k, v, cfg)
        x = _residual(x, h, _attn_out(o, lp["attn"], cfg), lp, cfg)
    x = _norm(x, params["final_norm"]["scale"], cfg)
    h_last = x[0, min(max(int(length) - 1, 0), S - 1)][None, :]
    return torch.matmul(h_last, _head(params)).float(), kv_pages


def forward_decode(
    params: Params,
    tokens: torch.Tensor,
    positions: torch.Tensor,
    cfg: TransformerConfig,
    kv_pages: Dict[str, torch.Tensor],
    block_tables: torch.Tensor,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decode step for the whole slot batch, paged attention.

    tokens [B] (last emitted token per slot), positions [B] (index the new
    token occupies; -1 marks an inactive slot), block_tables [B, P].
    Appends each active slot's k/v at `positions` in place, attends over
    [0, pos] and returns (logits [B, vocab] fp32, kv_pages). Inactive slots
    write to the trash page and give logits the scheduler ignores.
    """
    B = tokens.shape[0]
    T = kv_pages["k"].shape[2]
    P = block_tables.shape[1]
    dev = tokens.device
    active = positions >= 0
    # Clamped like jnp.take: positions past the table read its last entry.
    pos = positions.long().clamp(0, P * T - 1)
    block_tables = block_tables.long()

    cos_t, sin_t = rope_tables(cfg, P * T, dev)
    cos, sin = cos_t[pos], sin_t[pos]  # [B, rd/2]
    x = params["embed"]["embedding"][tokens.long()][:, None, :]  # [B, 1, d]
    rows = torch.arange(B, device=dev)
    dest_page = torch.where(active, block_tables[rows, pos // T], TRASH_PAGE)
    dest_slot = pos % T
    rep = cfg.n_heads // cfg.n_kv_heads
    kv_mask = torch.arange(P * T, device=dev)[None, :] <= pos[:, None]  # [B, P*T]

    for i in range(cfg.n_layers):
        lp = _layer_params(params, i)
        kp, vp = kv_pages["k"][i], kv_pages["v"][i]
        h = _norm(x, lp["attn_norm"]["scale"], cfg)
        q, k, v = _qkv(h, lp["attn"], cfg)
        q = _apply_rope_rows(q[:, 0], cos, sin, cfg)  # [B, nh, hd]
        k = _apply_rope_rows(k[:, 0], cos, sin, cfg)  # [B, nkv, hd]
        kp[dest_page, dest_slot] = k
        vp[dest_page, dest_slot] = v[:, 0]
        # Gather after the append so the new position attends to itself.
        kb = kp[block_tables].reshape(B, P * T, cfg.n_kv_heads, cfg.head_dim)
        vb = vp[block_tables].reshape(B, P * T, cfg.n_kv_heads, cfg.head_dim)
        if rep > 1:
            kb = kb.repeat_interleave(rep, dim=2)
            vb = vb.repeat_interleave(rep, dim=2)
        scores = torch.einsum("bhd,bshd->bhs", q.float(), kb.float()) / math.sqrt(cfg.head_dim)
        scores = scores.masked_fill(~kv_mask[:, None, :], float("-inf"))
        attn = torch.softmax(scores, dim=-1)
        o = torch.einsum("bhs,bshd->bhd", attn, vb.float())
        o = o.reshape(B, 1, cfg.n_heads, cfg.head_dim).to(cfg.dtype)
        x = _residual(x, h, _attn_out(o, lp["attn"], cfg), lp, cfg)
    x = _norm(x, params["final_norm"]["scale"], cfg)
    return torch.matmul(x[:, 0], _head(params)).float(), kv_pages
