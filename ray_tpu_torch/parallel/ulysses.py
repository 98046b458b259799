"""Ulysses sequence parallelism: an all-to-all from sequence shards to head
shards, attention over the whole sequence, and back. The counterpart of
ray_tpu/parallel/ulysses.py (DeepSpeed-Ulysses).

Two all-to-alls per attention against the ring's n - 1 hops; each rank runs
one flash kernel over the full sequence on its h / n heads.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.flash_attention import flash_attention
from .collectives import all_to_all, axis_size


def _ulysses_shard(q, k, v, mesh, *, axis: str, causal: bool, scale: Optional[float]):
    """q/k/v [b, s/n, h, d] -> [b, s/n, h, d]: [b, s/n, h, d] -> [b, s, h/n, d]
    (split heads, gather the sequence), flash attention, and back."""

    def seq_to_head(x):
        return all_to_all(x, mesh, axis, split_dim=2, concat_dim=1)

    oh = flash_attention(seq_to_head(q), seq_to_head(k), seq_to_head(v), causal=causal,
                         scale=scale)
    return all_to_all(oh, mesh, axis, split_dim=1, concat_dim=2)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh, *,
                      axis: str = "seq", causal: bool = True,
                      scale: Optional[float] = None) -> torch.Tensor:
    """Attention over a sequence split on `axis`, by head resharding.

    Needs num_heads % n == 0 (and the same of k/v's heads). Where the JAX
    function takes the global [batch, seq, heads, head_dim] arrays, each
    rank here passes ITS sequence shard [b, seq / n, h, d] and gets its
    shard of the output. With heads over "tensor" each rank passes its
    head group (num_heads here is that group's) and the all-to-alls run
    over the "seq" group of that head group."""
    n = axis_size(mesh, axis)
    if q.shape[2] % n:
        raise ValueError(f"num_heads={q.shape[2]} not divisible by {axis} ranks {n}")
    if k.shape[2] % n:
        raise ValueError(f"num_kv_heads={k.shape[2]} not divisible by {axis} ranks {n}")
    return _ulysses_shard(q, k, v, mesh, axis=axis, causal=causal, scale=scale)


__all__ = ["ulysses_attention"]
