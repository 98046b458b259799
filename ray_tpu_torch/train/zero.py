"""ZeRO-1: the optimizer state sharded over a torch.distributed group, the
counterpart of ray_tpu/train/zero.py (arXiv:2004.13336).

Plain data parallelism keeps a full AdamW state on every rank, twice the
params' bytes. ZeRO-1 shards it: each rank updates only its 1/N slice of
every flattened param,

    local grads --reduce_scatter (sum) / N--> grad shard
    grad shard + AdamW state shard --optimizer.step--> param shard
    param shard --all_gather--> full params, copied into place

one reduce-scatter and one all-gather, the bytes of the all-reduce they
replace. AdamW is elementwise, so the shard-local update computes what the
unsharded one does.

Representation: every param leaf, in jax.tree_util's leaf order
(models/convert.py `flatten`), is flattened and zero-padded to a multiple of
the group's size N. The ZeRO optimizer state is a torch.optim optimizer (the
`make_optimizer` factory, e.g. transformer.adamw) over one flat tensor per
leaf, this rank's [padded/N] slice, so its exp_avg/exp_avg_sq are shards in
the param dtype. The pad stays zero through AdamW (zero grad, zero moments,
decay of a zero param), so `to_logical` / `from_logical`, the unpadded
param-shaped view that the elastic checkpoint stores, are exact at any
world size. The logical view is JAX's: {"count", "mu", "nu"} with mu and nu
keyed by leaf index, str(i).

The group is the default one, or the `axis` dim of a 1-D DeviceMesh.
Where the JAX step takes the global batch and shard_map slices it, each rank
here passes its own [b/N, ...] slice.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from ..models.convert import as_tensor, flatten, unflatten


def _group(mesh, axis: str):
    return dist.group.WORLD if mesh is None else mesh.get_group(axis)


def _collective(fn, out: torch.Tensor, inp: torch.Tensor, group, **kw) -> None:
    """fn(out, inp) over `group`. Gloo reads host memory only: under gloo a
    CUDA tensor goes through a host copy (how ranks that share one GPU run
    ZeRO over gloo, as parallel/collectives.py does)."""
    if inp.device.type != "cpu" and dist.get_backend(group) == "gloo":
        host_out = out.detach().cpu()
        fn(host_out, inp.detach().cpu(), group=group, **kw)
        out.copy_(host_out)
    else:
        fn(out, inp, group=group, **kw)


def _optimizer_shards(optimizer: torch.optim.Optimizer) -> List[torch.Tensor]:
    return [p for g in optimizer.param_groups for p in g["params"]]


class ZeroSharder:
    """The flatten/pad/shard mapping between a logical param tree and the
    per-leaf padded flat vectors the sharded update runs on; leaf i is key
    str(i), in jax.tree_util's order. `params_like` needs only shapes and
    dtypes (meta tensors do)."""

    def __init__(self, params_like, mesh=None, axis: str = "data"):
        self.mesh, self.axis = mesh, axis
        self.group = _group(mesh, axis)
        self.n = dist.get_world_size(self.group)
        self.rank = dist.get_rank(self.group)
        self.paths, leaves = flatten(params_like)
        self.shapes = [tuple(t.shape) for t in leaves]
        self.dtypes = [t.dtype for t in leaves]
        self.sizes = [math.prod(s) for s in self.shapes]
        self.padded = [-(-s // self.n) * self.n for s in self.sizes]

    # ------------------------------------------------------------ params
    def _padded_flat(self, i: int, t: torch.Tensor) -> torch.Tensor:
        flat = t.detach().reshape(-1)
        pad = self.padded[i] - self.sizes[i]
        return torch.cat([flat, flat.new_zeros(pad)]) if pad else flat

    def flatten(self, tree) -> Dict[str, torch.Tensor]:
        """Logical tree -> {str(i): padded flat vector} (every rank's, whole)."""
        return {str(i): self._padded_flat(i, t) for i, t in enumerate(flatten(tree)[1])}

    def unflatten(self, flats: Dict[str, torch.Tensor]):
        leaves = [flats[str(i)][: self.sizes[i]].reshape(self.shapes[i])
                  for i in range(len(self.shapes))]
        return unflatten(self.paths, leaves)

    def shard_struct(self) -> Dict[str, torch.Tensor]:
        """This rank's shard shapes and dtypes, as meta tensors."""
        return {str(i): torch.empty((self.padded[i] // self.n,), dtype=self.dtypes[i],
                                    device="meta") for i in range(len(self.shapes))}

    def _shard_of(self, i: int, t: torch.Tensor) -> torch.Tensor:
        k = self.padded[i] // self.n
        return self._padded_flat(i, t)[self.rank * k:(self.rank + 1) * k]

    def shard(self, tree) -> Dict[str, torch.Tensor]:
        """Logical tree -> this rank's slice of each padded flat leaf."""
        return {str(i): self._shard_of(i, t) for i, t in enumerate(flatten(tree)[1])}

    # --------------------------------------------------------- opt state
    def to_logical(self, optimizer: torch.optim.Optimizer) -> Dict[str, Any]:
        """The ZeRO optimizer's state -> the world-size-independent logical
        tree, on the CPU: {"count", "mu": {str(i): param-shaped}, "nu": ...}.
        A collective: every rank of the group calls it and gets the whole."""
        shards = _optimizer_shards(optimizer)
        counts, mu, nu = set(), {}, {}
        for i, p in enumerate(shards):
            state = optimizer.state.get(p) or {}
            counts.add(int(state["step"]) if state else 0)
            for name, out in (("exp_avg", mu), ("exp_avg_sq", nu)):
                shard = state[name] if state else torch.zeros_like(p)
                full = shard.new_empty(self.padded[i])
                _collective(dist.all_gather_into_tensor, full, shard.contiguous(), self.group)
                out[str(i)] = full[: self.sizes[i]].reshape(self.shapes[i]).cpu()
        if len(counts) > 1:
            raise ValueError(f"shards were stepped unequally often: {sorted(counts)}")
        return {"count": torch.tensor(counts.pop(), dtype=torch.int32), "mu": mu, "nu": nu}

    def from_logical(self, logical, optimizer: torch.optim.Optimizer) -> None:
        """Inverse of to_logical at THIS sharder's world size: re-pads each
        moment with zeros (exact: the pad of a fresh or restored run is zero)
        and loads this rank's slice into `optimizer`. Leaves may be numpy
        (JAX's to_logical, bfloat16 as ml_dtypes' dtype) or tensors."""
        count = logical["count"]
        step = float(count.item() if isinstance(count, torch.Tensor) else count)
        for i, p in enumerate(_optimizer_shards(optimizer)):
            moments = [self._shard_of(i, as_tensor(logical[m][str(i)], self.dtypes[i],
                                                   self.shapes[i])).to(p.device, copy=True)
                       for m in ("mu", "nu")]
            group = next(g for g in optimizer.param_groups if any(q is p for q in g["params"]))
            dev = p.device if group.get("fused") or group.get("capturable") else "cpu"
            optimizer.state[p] = {"step": torch.tensor(step, dtype=torch.float32, device=dev),
                                  "exp_avg": moments[0], "exp_avg_sq": moments[1]}

    def place_opt(self, optimizer: torch.optim.Optimizer, state_dict: Dict[str, Any]) -> None:
        """Loads a ZeRO optimizer's own `state_dict()` saved at THIS world
        size and rank (the same representation, e.g. through
        checkpoint.save_aux_state); torch moves each moment to its shard's
        device."""
        for i, st in state_dict["state"].items():
            got = tuple(st["exp_avg"].shape)
            if got != (self.padded[int(i)] // self.n,):
                raise ValueError(f"leaf {i}: saved shard {got} is not this world's "
                                 f"({self.padded[int(i)] // self.n},); use from_logical")
        optimizer.load_state_dict(state_dict)

    def opt_specs(self, optimizer: torch.optim.Optimizer) -> Dict[str, Any]:
        """Placement tree of the ZeRO optimizer's state over the sharder's
        axis, keyed as `to_logical` keys it: each leaf's moments are this
        rank's slice of a flat vector, sharded along dim 0 ((Shard(0),));
        the step count is replicated ((Replicate(),)). JAX's `opt_specs`
        gives P(axis) and P() for the same leaves."""
        from torch.distributed.tensor import Replicate, Shard

        sharded = {str(i): (Shard(0),) for i in range(len(_optimizer_shards(optimizer)))}
        return {"count": (Replicate(),), "mu": dict(sharded), "nu": dict(sharded)}

    # ------------------------------------------------------------ update
    def _apply(self, params, optimizer: torch.optim.Optimizer,
               grad_shards: List[torch.Tensor]) -> None:
        """Sets each shard to this rank's slice of its param, its grad to
        `grad_shards`, steps the optimizer and all-gathers the updated shards
        into the params in place."""
        leaves = flatten(params)[1]
        shards = _optimizer_shards(optimizer)
        with torch.no_grad():
            for i, (p, sh, g) in enumerate(zip(leaves, shards, grad_shards)):
                sh.copy_(self._shard_of(i, p))
                sh.grad = g
            optimizer.step()
            for i, (p, sh) in enumerate(zip(leaves, shards)):
                sh.grad = None
                full = sh.new_empty(self.padded[i])
                _collective(dist.all_gather_into_tensor, full, sh, self.group)
                p.copy_(full[: self.sizes[i]].view(self.shapes[i]))


def init_opt_state(make_optimizer: Callable[[List[torch.Tensor]], torch.optim.Optimizer],
                   params, mesh=None, axis: str = "data") -> torch.optim.Optimizer:
    """The ZeRO optimizer state: `make_optimizer` over this rank's flat slice
    of every padded param leaf (~1/N of the unsharded state's bytes)."""
    sharder = ZeroSharder(params, mesh, axis)
    return make_optimizer([sh.clone() for sh in sharder.shard(params).values()])


def build_zero_step(
    loss_fn: Callable[[Any, Any], torch.Tensor],
    params_like,
    mesh=None,
    *,
    axis: str = "data",
) -> Tuple[Callable, ZeroSharder]:
    """The ZeRO-1 train step: returns (step, sharder), where
    `step(params, optimizer, batch) -> loss` runs `loss_fn(params, batch)`
    (the MEAN loss of this rank's batch slice) and its backward, reduce-
    scatters every grad (sum / N), steps the optimizer on the shards,
    all-gathers the params in place, and returns the loss's mean over ranks
    (JAX's pmean). `params` leaves require grad; `optimizer` is
    init_opt_state's."""
    sharder = ZeroSharder(params_like, mesh, axis)

    def step(params, optimizer: torch.optim.Optimizer, batch) -> torch.Tensor:
        leaves = flatten(params)[1]
        for t in leaves:
            t.grad = None
        loss = loss_fn(params, batch)
        loss.backward()
        grad_shards = []
        for i, t in enumerate(leaves):
            g = t.grad if t.grad is not None else torch.zeros_like(t)
            t.grad = None
            out = g.new_empty(sharder.padded[i] // sharder.n)
            _collective(dist.reduce_scatter_tensor, out, sharder._padded_flat(i, g),
                        sharder.group, op=dist.ReduceOp.SUM)
            grad_shards.append(out.div_(sharder.n))
        sharder._apply(params, optimizer, grad_shards)
        loss = loss.detach().clone()
        _collective(lambda out, _, **kw: dist.all_reduce(out, **kw), loss, loss, sharder.group,
                    op=dist.ReduceOp.SUM)
        return loss.div_(sharder.n)

    return step, sharder


def build_zero_update(params_like, mesh=None, *,
                      axis: str = "data") -> Tuple[Callable, ZeroSharder]:
    """Update only: `update(params, optimizer, grads)` for callers that hold
    globally reduced grads (a tree like params, the same on every rank):
    each rank slices its shard of the grads, steps, and all-gathers the
    params in place."""
    sharder = ZeroSharder(params_like, mesh, axis)

    def update(params, optimizer: torch.optim.Optimizer, grads) -> None:
        grad_shards = [sharder._shard_of(i, g).clone()
                       for i, g in enumerate(flatten(grads)[1])]
        sharder._apply(params, optimizer, grad_shards)

    return update, sharder


def per_device_bytes(obj, device=None) -> int:
    """Bytes of `obj` (a tensor tree, or an optimizer's state) resident on
    ONE device, by default that of the optimizer's first param or the tree's
    first tensor: the number ZeRO shrinks ~1/N. (torch keeps AdamW's step
    counts on the host, so on a GPU they are not counted.)"""
    if isinstance(obj, torch.optim.Optimizer):
        first = _optimizer_shards(obj)[:1]
        leaves = [t for st in obj.state.values() for t in st.values()
                  if isinstance(t, torch.Tensor)]
    else:
        leaves = first = [t for t in flatten(obj)[1] if isinstance(t, torch.Tensor)]
    if device is None:
        if not first:
            return 0
        device = first[0].device
    return sum(t.numel() * t.element_size() for t in leaves if t.device == torch.device(device))
