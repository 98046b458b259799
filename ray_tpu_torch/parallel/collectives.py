"""Collectives over one mesh dim's process group: the counterpart of
ray_tpu/parallel/collectives.py.

JAX traces these into one SPMD program under `shard_map`; the port has no
shard_map, since each rank's program already is the per-shard body. Each
function takes this rank's tensor, the DeviceMesh (None: the default group)
and the axis name, and runs one torch.distributed op over that dim's group.

Each is differentiable as JAX's is under `shard_map(..., check_vma=False)`:
its backward is the op's transpose, the gradient each rank receives being
what `jax.grad` gives that device's shard:
  - psum: psum of the cotangents (not the identity: with check_vma=False
    JAX transposes psum to psum); pmean: the same over n;
  - pmax: no gradient, as lax.pmax has no differentiation rule;
  - all_gather <-> reduce_scatter along the same dim;
  - all_to_all: all_to_all with split and concat dims swapped;
  - ring_permute by `shift`: ring_permute by -shift;
  - pbroadcast (select + psum): psum of the cotangents, kept on the root.
`axis` may name several mesh dims, as JAX's axis_name tuples do: the op
then runs over their group, `mesh.axes_group(mesh, axes)`.

Tensor parallelism (Megatron-LM's pair, Shoeybi et al. 2019) needs
gradients that the transposes above do not give: over "tensor" the ranks
hold the same activations and the same loss, not parts of a sum, so a
replicated value's gradient must come out whole on every rank, not summed
T times. Four ops keep that convention:
  - tp_copy before a column-parallel product: identity forward, psum of
    the (partial) gradients backward;
  - tp_reduce after a row-parallel product: psum forward, identity
    backward (with `psum` here the gradient upstream would be T times too
    large);
  - tp_gather (all-gather forward, this rank's slice of the whole gradient
    backward) and tp_split (this rank's slice forward, all-gather backward)
    move a value between sharded and replicated.
A bfloat16 or half tensor is summed in float32 and rounded once, as one
product over the whole contraction would be.

Backends. NCCL takes CUDA tensors. Gloo's point-to-point and all-to-all
ops read host memory only, so where `dist.get_backend(group)` is "gloo" and
a tensor is on a CUDA device, every op here copies it to the host, runs
there and copies the result back to the tensor's device (how several ranks
that share one GPU run over gloo). Compute stays on the device; only the
bytes on the wire pass through host memory. A group of one rank moves
nothing.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from .mesh import axes_group

Tensors = Union[torch.Tensor, Sequence[torch.Tensor]]
Axes = Union[str, Sequence[str]]


def group_of(mesh, axis: Axes):
    """The process group of `mesh`'s dim `axis` (or of several dims: the
    ranks that share every other coordinate); the default group without a
    mesh."""
    if mesh is None:
        return dist.group.WORLD
    return axes_group(mesh, axis)


def axis_size(mesh, axis: Axes) -> int:
    return dist.get_world_size(group_of(mesh, axis))


def axis_index(mesh, axis: Axes) -> int:
    """This rank's coordinate along `axis` (lax.axis_index)."""
    return dist.get_rank(group_of(mesh, axis))


def _wire(x: torch.Tensor, group) -> torch.Tensor:
    """x as the group's backend reads it: a contiguous host copy of a CUDA
    tensor under gloo, else x itself made contiguous."""
    if x.device.type != "cpu" and dist.get_backend(group) == "gloo":
        return x.detach().to("cpu").contiguous()
    return x.detach().contiguous()


# ---------------------------------------------------------------- raw ops
# No autograd: each takes and returns tensors on the caller's device.


def _all_reduce(x, group, op=dist.ReduceOp.SUM):
    if dist.get_world_size(group) == 1:
        return x.detach().clone()
    w = _wire(x, group)
    w = w.clone() if w.data_ptr() == x.data_ptr() else w
    dist.all_reduce(w, op=op, group=group)
    return w.to(x.device)


def _all_gather(x, group, dim: int):
    n = dist.get_world_size(group)
    if n == 1:
        return x.detach().clone()
    w = _wire(x, group)
    parts = [torch.empty_like(w) for _ in range(n)]
    dist.all_gather(parts, w, group=group)
    return torch.cat(parts, dim=dim).to(x.device)


def _reduce_scatter(x, group, dim: int):
    n = dist.get_world_size(group)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split over {n} ranks")
    if n == 1:
        return x.detach().clone()
    w = _wire(x.movedim(dim, 0), group)
    out = w.new_empty((w.shape[0] // n,) + tuple(w.shape[1:]))
    dist.reduce_scatter_tensor(out, w, op=dist.ReduceOp.SUM, group=group)
    return out.movedim(0, dim).to(x.device)


def _all_to_all(x, group, split_dim: int, concat_dim: int):
    n = dist.get_world_size(group)
    if x.shape[split_dim] % n:
        raise ValueError(f"dim {split_dim} of {tuple(x.shape)} does not split over {n} ranks")
    if n == 1:
        return x.detach().clone()
    # chunk j goes to rank j; the chunk from rank j lands at index j
    w = _wire(torch.stack(x.chunk(n, dim=split_dim)), group)
    out = torch.empty_like(w)
    dist.all_to_all_single(out, w, group=group)
    return torch.cat(out.unbind(0), dim=concat_dim).to(x.device)


def _ring_permute(xs: Tuple[torch.Tensor, ...], group, shift: int):
    """Sends each of xs to the rank `shift` steps on around the group's ring
    and returns what the rank `shift` steps back sent, in one
    batch_isend_irecv."""
    n = dist.get_world_size(group)
    if n == 1 or shift % n == 0:
        return tuple(x.detach().clone() for x in xs)
    r = dist.get_rank(group)
    to = dist.get_global_rank(group, (r + shift) % n)
    frm = dist.get_global_rank(group, (r - shift) % n)
    sends = [_wire(x, group) for x in xs]
    recvs = [torch.empty_like(s) for s in sends]
    ops = ([dist.P2POp(dist.isend, s, to, group) for s in sends]
           + [dist.P2POp(dist.irecv, t, frm, group) for t in recvs])
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return tuple(t.to(x.device) for t, x in zip(recvs, xs))


def _send(x, group, to: int) -> None:
    """Sends x to group rank `to` (blocking until it is taken)."""
    dist.send(_wire(x, group), dist.get_global_rank(group, to), group=group)


def _recv(like, group, frm: int):
    """Receives a tensor shaped, typed and placed as `like` from group rank
    `frm`."""
    buf = _wire(torch.empty_like(like), group)
    dist.recv(buf, dist.get_global_rank(group, frm), group=group)
    return buf.to(like.device)


def _broadcast(x, group, src: int):
    """Group rank `src`'s x on every rank of the group (x: a tensor of the
    right shape and dtype everywhere)."""
    if dist.get_world_size(group) == 1:
        return x
    w = _wire(x, group)
    w = w.clone() if w.data_ptr() == x.data_ptr() else w
    dist.broadcast(w, dist.get_global_rank(group, src), group=group)
    return w.to(x.device)


# --------------------------------------------------------------- autograd


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _PMax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group, dist.ReduceOp.MAX)

    @staticmethod
    def backward(ctx, g):
        raise NotImplementedError("pmax has no gradient (lax.pmax has no differentiation rule)")


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.group, ctx.dim), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _reduce_scatter(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.group, ctx.dim), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_dim, concat_dim):
        ctx.group, ctx.dims = group, (split_dim, concat_dim)
        return _all_to_all(x, group, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim = ctx.dims
        return _all_to_all(g, ctx.group, concat_dim, split_dim), None, None, None


class _RingPermute(torch.autograd.Function):
    """Its backward receives zeros for an output that got no gradient, so a
    rank whose backward reaches this op always makes its transfer; a caller
    whose outputs may reach no loss on some ranks keeps them in the graph
    (ring_attention's _Anchor), or those ranks would skip it."""

    @staticmethod
    def forward(ctx, group, shift, *xs):
        ctx.group, ctx.shift = group, shift
        return _ring_permute(xs, group, shift)

    @staticmethod
    def backward(ctx, *gs):
        return (None, None, *_ring_permute(gs, ctx.group, -ctx.shift))


def _sum(x, group):
    """_all_reduce in float32 for a 16-bit x, rounded once."""
    if x.dtype in (torch.bfloat16, torch.float16):
        return _all_reduce(x.float(), group).to(x.dtype)
    return _all_reduce(x, group)


def _own(x, group, dim: int):
    """This rank's chunk of x along dim."""
    n = dist.get_world_size(group)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split over {n} ranks")
    return x.chunk(n, dim=dim)[dist.get_rank(group)].contiguous()


class _TPCopy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.group), None


class _TPReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _TPGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _own(g, ctx.group, ctx.dim), None, None


class _TPSplit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _own(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.group, ctx.dim), None, None


class _GradSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, groups, *leaves):
        ctx.groups = groups
        return tuple(t.view_as(t) for t in leaves)

    @staticmethod
    def backward(ctx, *grads):
        return (None, *(g if group is None or g is None else _all_reduce(g, group)
                        for g, group in zip(grads, ctx.groups)))


# ------------------------------------------------------------------ API


def psum(x: torch.Tensor, mesh, axis: Axes) -> torch.Tensor:
    return _PSum.apply(x, group_of(mesh, axis))


def pmean(x: torch.Tensor, mesh, axis: Axes) -> torch.Tensor:
    return psum(x, mesh, axis) / axis_size(mesh, axis)


def pmax(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    return _PMax.apply(x, group_of(mesh, axis))


def all_gather(x: torch.Tensor, mesh, axis: str, *, tiled: bool = True,
               gather_dim: int = 0) -> torch.Tensor:
    """Every rank's x concatenated along gather_dim in rank order (tiled),
    or stacked on a new gather_dim (tiled=False)."""
    if not tiled:
        x = x.unsqueeze(gather_dim)
    return _AllGather.apply(x, group_of(mesh, axis), gather_dim)


def reduce_scatter(x: torch.Tensor, mesh, axis: str, *, scatter_dim: int = 0) -> torch.Tensor:
    """The sum over ranks of x, split along scatter_dim: this rank's chunk
    (lax.psum_scatter, tiled)."""
    return _ReduceScatter.apply(x, group_of(mesh, axis), scatter_dim)


def all_to_all(x: torch.Tensor, mesh, axis: str, *, split_dim: int,
               concat_dim: int) -> torch.Tensor:
    """x split into n chunks along split_dim, chunk j sent to rank j; the
    chunks received concatenated along concat_dim in rank order (tiled)."""
    return _AllToAll.apply(x, group_of(mesh, axis), split_dim, concat_dim)


def ring_permute(x: Tensors, mesh, axis: str, *, shift: int = 1):
    """Sends x (a tensor, or a tuple of tensors moved in one batch of
    transfers) to the rank `shift` steps on around `axis`'s ring; returns
    what arrives from `shift` steps back, shaped as x."""
    xs = (x,) if isinstance(x, torch.Tensor) else tuple(x)
    out = _RingPermute.apply(group_of(mesh, axis), shift, *xs)
    return out[0] if isinstance(x, torch.Tensor) else tuple(out)


def tp_copy(x: torch.Tensor, mesh, axis: Axes = "tensor") -> torch.Tensor:
    """x as it is; the backward sums x's gradient over `axis` (the input of
    a column-parallel product, whose gradient each rank holds a part of)."""
    return _TPCopy.apply(x, group_of(mesh, axis))


def tp_reduce(x: torch.Tensor, mesh, axis: Axes = "tensor") -> torch.Tensor:
    """The sum of x over `axis` (a row-parallel product's partial outputs);
    the backward passes the gradient through, as every rank already holds
    all of it."""
    return _TPReduce.apply(x, group_of(mesh, axis))


def tp_gather(x: torch.Tensor, mesh, axis: Axes = "tensor", *, dim: int = -1) -> torch.Tensor:
    """Every rank's x concatenated along dim in rank order; the backward
    keeps this rank's slice of the (whole, equal on every rank) gradient."""
    return _TPGather.apply(x, group_of(mesh, axis), dim % x.dim())


def tp_split(x: torch.Tensor, mesh, axis: Axes = "tensor", *, dim: int = -1) -> torch.Tensor:
    """This rank's chunk of x (equal on every rank) along dim; the backward
    gathers every rank's chunk gradient into the whole."""
    return _TPSplit.apply(x, group_of(mesh, axis), dim % x.dim())


def grad_sum(leaves: Sequence[torch.Tensor], groups: Sequence) -> Tuple[torch.Tensor, ...]:
    """The leaves as they are; the backward sums each one's gradient over
    its group (None: no sum). A model passes its params' local shards
    through one such node, so every rank's shard gets the gradient of the
    global loss from the ranks that hold other parts of the batch: one node
    for all leaves runs once, after the rest of the backward, on every rank
    alike."""
    return _GradSum.apply(tuple(groups), *leaves)


def one_hot_rank(mesh, axis: str, n: Optional[int] = None,
                 dtype=torch.float32, device=None) -> torch.Tensor:
    """This rank's one-hot row over `axis`'s n ranks."""
    n = axis_size(mesh, axis) if n is None else n
    out = torch.zeros(n, dtype=dtype, device=device)
    out[axis_index(mesh, axis)] = 1
    return out


def pbroadcast(x: torch.Tensor, mesh, axis: str, root: int = 0) -> torch.Tensor:
    """The root's x on every rank (select + psum, as the JAX function)."""
    # a select, not a branch: x stays in the graph on every rank
    is_root = torch.tensor(axis_index(mesh, axis) == root, device=x.device)
    return psum(torch.where(is_root, x, torch.zeros_like(x)), mesh, axis)


__all__ = ["all_gather", "all_to_all", "axis_index", "axis_size", "grad_sum", "group_of",
           "one_hot_rank",
           "pbroadcast", "pmax", "pmean", "psum", "reduce_scatter", "ring_permute", "tp_copy",
           "tp_gather", "tp_reduce", "tp_split"]
