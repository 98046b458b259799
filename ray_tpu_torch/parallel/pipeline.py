"""Pipeline parallelism: GPipe microbatches over the "stage" dim, point to
point between neighbouring stages. The counterpart of
ray_tpu/parallel/pipeline.py.

Where JAX's pipeline is one SPMD program (a `lax.scan` over M + S - 1 steps
in which every stage computes, bubbles on zeros, and autodiff derives the
backward), each rank here runs its own stage's schedule, and one
`torch.autograd.Function` holds the forward and the backward pipeline:

  forward:  for m in 0 .. M-1: receive microbatch m from stage - 1 (stage 0
            takes it from the input), run the stage, send it to stage + 1;
            the last stage's outputs are broadcast to every stage (JAX's
            masked psum);
  backward: for m in M-1 .. 0: receive the output's gradient from stage + 1
            (the last stage takes its own cotangent), backpropagate through
            the stage (recomputing its forward from the saved input under
            remat, as jax.checkpoint does), send the input's gradient to
            stage - 1. Stage 0's input gradients are summed over the stages
            (zeros elsewhere), as JAX transposes a replicated input.

So each stage runs its function M times forward (2M under remat) and M
times backward, and no bubble step runs: outputs and gradients are JAX's.
"""

from __future__ import annotations

from typing import Any, Callable, List

import torch
import torch.distributed as dist

from .collectives import _all_gather, _all_reduce, _broadcast, _recv, _send, group_of

PyTree = Any


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _leaves(v)]
    return [tree]


def _rebuild(like, leaves) -> PyTree:
    it = iter(leaves)

    def one(t):
        return {k: one(v) for k, v in t.items()} if isinstance(t, dict) else next(it)

    return one(like)


def _map(fn, tree) -> PyTree:
    return {k: _map(fn, v) for k, v in tree.items()} if isinstance(tree, dict) else fn(tree)


def stack_stage_params(stage_trees: List[PyTree]) -> PyTree:
    """Per-stage param trees stacked into one with a leading [S, ...] dim."""
    return _rebuild(stage_trees[0], [torch.stack(xs) for xs in
                                     zip(*(_leaves(t) for t in stage_trees))])


def split_stacked_layers(stacked: PyTree, num_stages: int) -> PyTree:
    """Stacked layer params [L, ...] as [S, L / S, ...]: stage s holds layers
    s * L/S .. (s + 1) * L/S - 1."""

    def one(p):
        n_layers = p.shape[0]
        if n_layers % num_stages:
            raise ValueError(f"{n_layers} layers not divisible into {num_stages} stages")
        return p.reshape((num_stages, n_layers // num_stages) + tuple(p.shape[1:]))

    return _map(one, stacked)


def stage_param_sharding(mesh, tree: PyTree, axis: str = "stage") -> PyTree:
    """Each leaf's DTensor placements with its leading stage dim over `axis`."""
    from .mesh import PartitionSpec, placements

    return _map(lambda _: placements(mesh, PartitionSpec(axis)), tree)


class _StageSlice(torch.autograd.Function):
    """This stage's slice [sid] of stacked params [S, ...]; the backward
    gathers every stage's slice gradient, so each rank's stacked params get
    the gradient of the whole pipeline, as a replicated JAX array does."""

    @staticmethod
    def forward(ctx, group, sid, *leaves):
        ctx.group = group
        return tuple(p[sid].clone() for p in leaves)

    @staticmethod
    def backward(ctx, *gs):
        return (None, None, *(_all_gather(g.unsqueeze(0), ctx.group, 0) for g in gs))


def shard_stage_params(params: PyTree, mesh, axis: str = "stage") -> PyTree:
    """This rank's stage of stacked params [S, ...] (JAX: device_put with the
    leading dim over `axis`): the tree pipeline_apply takes. Every rank
    passes the whole stacked tree; the gradient it gets back is the whole
    pipeline's."""
    group = group_of(mesh, axis)
    leaves = _leaves(params)
    return _rebuild(params, _StageSlice.apply(group, dist.get_rank(group), *leaves))


class _GPipe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, stage_fn, like, group, remat, x, *leaves):
        S, sid = dist.get_world_size(group), dist.get_rank(group)
        ctx.stage_fn, ctx.like, ctx.group, ctx.remat = stage_fn, like, group, remat
        M = x.shape[0]
        ctx.M = M
        if not remat:
            params = [p.detach().requires_grad_(p.requires_grad) for p in leaves]
            ctx.graph_params = params
        ys, ctx.saved_in, ctx.graphs = [], [], []
        for m in range(M):
            x_in = x[m] if sid == 0 else _recv(x[m], group, sid - 1)
            if remat:
                y = stage_fn(_rebuild(like, leaves), x_in)
                ctx.saved_in.append(x_in)
            else:
                with torch.enable_grad():
                    x_leaf = x_in.detach().requires_grad_()
                    y = stage_fn(_rebuild(like, params), x_leaf)
                ctx.graphs.append((x_leaf, y))
                y = y.detach()
            if sid < S - 1:
                _send(y, group, sid + 1)
            else:
                ys.append(y)
        out = torch.stack(ys) if sid == S - 1 else torch.empty_like(x)
        ctx.save_for_backward(*leaves)
        return _broadcast(out, group, S - 1)

    @staticmethod
    def backward(ctx, g_out):
        group = ctx.group
        S, sid = dist.get_world_size(group), dist.get_rank(group)
        leaves = ctx.saved_tensors
        grads = [None] * len(leaves)
        g_in = torch.zeros_like(g_out)
        for m in reversed(range(ctx.M)):
            g_y = g_out[m] if sid == S - 1 else _recv(g_out[m], group, sid + 1)
            with torch.enable_grad():
                if ctx.remat:
                    params = [p.detach().requires_grad_(p.requires_grad) for p in leaves]
                    x_leaf = ctx.saved_in[m].detach().requires_grad_()
                    y = ctx.stage_fn(_rebuild(ctx.like, params), x_leaf)
                else:
                    params = ctx.graph_params
                    x_leaf, y = ctx.graphs[m]
                wrt = [x_leaf] + [p for p in params if p.requires_grad]
                got = iter(torch.autograd.grad(y, wrt, g_y, allow_unused=True))
            g_x = next(got)
            g_x = torch.zeros_like(x_leaf) if g_x is None else g_x
            for i, p in enumerate(params):
                if p.requires_grad:
                    g = next(got)
                    if g is not None:
                        grads[i] = g if grads[i] is None else grads[i] + g
            if sid > 0:
                _send(g_x, group, sid - 1)
            else:
                g_in[m] = g_x
        ctx.graphs = ctx.saved_in = None
        g_x_all = _all_reduce(g_in, group) if ctx.needs_input_grad[4] else None
        grads = [torch.zeros_like(p) if g is None and p.requires_grad else g
                 for g, p in zip(grads, leaves)]
        return (None, None, None, None, g_x_all, *grads)


def pipeline_apply(stage_fn: Callable[[PyTree, torch.Tensor], torch.Tensor], stage_params: PyTree,
                   microbatches: torch.Tensor, mesh, *, axis: str = "stage",
                   remat: bool = True) -> torch.Tensor:
    """Runs microbatches [M, mb, ...] through the S stages of `axis`.

    `stage_params` is THIS rank's stage (`shard_stage_params` of a stacked
    tree; the JAX function takes the stacked [S, ...] tree and shard_map
    slices it), `stage_fn(params, x) -> y` keeps x's shape and dtype, and
    every rank passes the same microbatches. Returns the outputs [M, mb,
    ...] on every rank. Differentiable end to end: the backward is the
    backward pipeline; with `remat` each stage recomputes its forward from
    its saved input, else it keeps the forward's graph."""
    group = group_of(mesh, axis)
    return _GPipe.apply(stage_fn, stage_params, group, remat, microbatches,
                        *_leaves(stage_params))


__all__ = ["pipeline_apply", "shard_stage_params", "split_stacked_layers",
           "stack_stage_params", "stage_param_sharding"]
