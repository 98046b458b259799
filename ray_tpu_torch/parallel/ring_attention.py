"""Ring attention: exact attention over sequence shards passed around a
ring of ranks. The counterpart of ray_tpu/parallel/ring_attention.py
(blockwise ring formulation, Liu et al., "Ring Attention with Blockwise
Transformers").

Each rank holds one sequence shard of q, k and v, [b, s/n, h, d]. Every
rank's K/V reach every other rank (`ring_permute` by -i for block i,
point-to-point through batch_isend_irecv: n - 1 transfers of one shard per
rank, as the JAX ring's n - 1 neighbour hops, but each block in one
transfer from its owner, so its gradient goes back in one), and every
visible (q shard, kv block) pair runs the flash kernel with its lse
(`flash_attention_with_lse`); the partial outputs merge by their lse, so
the result is full attention. Gradients flow through the merge into each
block's lse, so the backward hands the kernels a non-zero dlse.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.flash_attention import NEG_INF, attention_reference, flash_attention_with_lse
from .collectives import axis_index, axis_size, ring_permute
from .mesh import PartitionSpec, mesh_shape


class _Anchor(torch.autograd.Function):
    """Returns o; its backward also sends zeros to every K/V block. On a rank
    that skips a block (causal, src > rank) nothing else would reach it,
    autograd would skip its transfer's backward, and the rank that owns the
    block would wait for it."""

    @staticmethod
    def forward(ctx, o, *kv):
        ctx.kv_like = [(t.shape, t.dtype, t.device) for t in kv]
        return o.view_as(o)

    @staticmethod
    def backward(ctx, g):
        return (g, *(torch.zeros(s, dtype=dt, device=dev) for s, dt, dev in ctx.kv_like))


def _ring_attention_shard(q, k, v, mesh, *, axis: str, causal: bool, scale: float):
    """One rank's ring. q [b, s, h, d], k/v [b, s, h_kv, d] (this rank's
    shard). Block i is the K/V of rank (rank + i) % n, which it sends
    straight here (ring_permute by -i): n - 1 transfers in, n - 1 out. Shards
    are equal-sized, so a block is the diagonal (src == rank: causal flash),
    fully visible (src < rank: non-causal flash) or fully in the future
    (skipped: no kernel launches).

    Every rank makes every transfer, skipped blocks included, and all of
    them come before the first kernel: the ranks' programs differ only in
    the blocks they skip, not in where a transfer sits among their other
    ops. So a recompute under remat (which may stop after the last tensor a
    rank needs) makes every transfer on every rank, and in the backward,
    where autograd runs later-made ops first, every rank finishes its
    kernels' backward before it sends the first gradient back.

    Gradients add up in float32: each block reads q, k and v through a cast
    from a float32 copy, so the blocks' bf16 gradients are summed in float32
    and rounded once (the values the kernels see are the inputs' own)."""
    n, rank = axis_size(mesh, axis), axis_index(mesh, axis)
    b, s, h, d = q.shape
    q32, k32, v32 = q.float(), k.float(), v.float()
    blocks = [(k32.to(k.dtype), v32.to(v.dtype))]
    blocks += [ring_permute((k32.to(k.dtype), v32.to(v.dtype)), mesh, axis, shift=-i)
               for i in range(1, n)]
    o = torch.zeros((b, s, h, d), dtype=torch.float32, device=q.device)
    lse = torch.full((b, h, s), NEG_INF, dtype=torch.float32, device=q.device)
    for i, (k_i, v_i) in enumerate(blocks):
        src = (rank + i) % n
        if causal and src > rank:
            continue
        o_i, lse_i = flash_attention_with_lse(q32.to(q.dtype), k_i, v_i,
                                              causal=causal and src == rank, scale=scale)
        # Merge normalised partials by lse weight (online softmax across
        # blocks): exact full attention once every block has contributed.
        lse_new = torch.logaddexp(lse, lse_i)
        w_acc = torch.exp(lse - lse_new).transpose(1, 2)[..., None]
        w_i = torch.exp(lse_i - lse_new).transpose(1, 2)[..., None]
        o = o * w_acc + o_i.float() * w_i
        lse = lse_new
    if n > 1:
        o = _Anchor.apply(o, *(t for kv in blocks[1:] for t in kv))
    return o.to(q.dtype)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh, *,
                   axis: str = "seq", causal: bool = True,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Exact attention with the sequence split over `axis`.

    Where the JAX function takes the global [batch, seq, heads, head_dim]
    arrays and runs the ring under shard_map, each rank here passes ITS
    shard, [b, seq / n, h, d] (positions rank * seq / n onwards; k/v may
    have fewer heads, GQA), and gets its shard of the output. With heads
    over "tensor" (batch_seq_spec) each rank passes its head group and runs
    the ring over the "seq" group of that head group: the ranks that share
    its "tensor" coordinate."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    return _ring_attention_shard(q, k, v, mesh, axis=axis, causal=causal, scale=scale)


def batch_seq_spec(mesh, axis: str) -> PartitionSpec:
    """[batch, seq, heads, head_dim] spec: batch over the mesh's batch axes
    ("data"/"fsdp"), sequence over `axis`, heads over "tensor" when that
    dim is larger than 1."""
    sizes = mesh_shape(mesh)
    if axis not in sizes:
        raise ValueError(f"mesh has no axis {axis!r}; axes: {tuple(sizes)}")
    batch_axes = tuple(a for a in ("data", "fsdp") if a in sizes)
    head_axis = "tensor" if sizes.get("tensor", 1) > 1 else None
    return PartitionSpec(batch_axes if batch_axes else None, axis, head_axis, None)


__all__ = ["attention_reference", "batch_seq_spec", "ring_attention"]
