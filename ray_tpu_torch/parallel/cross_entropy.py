"""Cross-entropy over logits whose vocab is split over a mesh dim: each rank
holds the columns [t V/T, (t+1) V/T) of its rows' logits (a column-parallel
head's output) and no rank ever holds a whole [..., V] tensor.

The JAX package computes the same loss with XLA ops on logits GSPMD splits
over "tensor" (ray_tpu/models/transformer.py `next_token_loss`:
log_softmax, take_along_axis), with no Pallas kernel; here it is three
all-reduces over the dim's group (Megatron-LM's vocab-parallel loss,
Shoeybi et al. 2019):
  1. the row max of the local columns, all-reduced by max;
  2. the local sum of exp(x - max), all-reduced by sum;
  3. each target's logit, taken by the one rank whose columns hold it, 0
     elsewhere, all-reduced by sum;
and nll = log(sum) + max - target logit. The backward is softmax - one-hot
on the local columns, times the incoming gradient: the gradient of every
rank's slice of the (equal on every rank) loss, so it needs no collective.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .collectives import Axes, _all_reduce, axis_index, group_of


class _VocabParallelNLL(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, targets, group, start):
        x = logits.float()
        vocab = x.shape[-1]
        row_max = _all_reduce(x.detach().amax(dim=-1), group, dist.ReduceOp.MAX)
        p = torch.exp(x - row_max.unsqueeze(-1))
        total = _all_reduce(p.sum(dim=-1), group)
        local = targets - start
        own = (local >= 0) & (local < vocab)
        idx = torch.where(own, local, torch.zeros_like(local)).unsqueeze(-1)
        picked = torch.where(own, x.gather(-1, idx).squeeze(-1), torch.zeros_like(row_max))
        picked = _all_reduce(picked, group)
        p.div_(total.unsqueeze(-1))  # the local columns of the softmax
        ctx.save_for_backward(p, idx, own)
        ctx.dtype = logits.dtype
        return torch.log(total) + row_max - picked

    @staticmethod
    def backward(ctx, g):
        p, idx, own = ctx.saved_tensors
        grad = p * g.unsqueeze(-1)
        grad.scatter_add_(-1, idx, (-g * own).unsqueeze(-1))
        return grad.to(ctx.dtype), None, None, None


def vocab_parallel_nll(logits: torch.Tensor, targets: torch.Tensor, mesh,
                       axis: Axes = "tensor") -> torch.Tensor:
    """-log softmax(logits)[target] per row, float32, shaped as targets.
    `logits` [..., V/T] are this rank's columns of the whole logits, the
    ranks of `axis` holding them in rank order; `targets` [...] are global
    vocab ids, equal on every rank of `axis`. The result is equal on every
    rank of `axis`."""
    start = axis_index(mesh, axis) * logits.shape[-1]
    return _VocabParallelNLL.apply(logits, targets.long(), group_of(mesh, axis), start)
