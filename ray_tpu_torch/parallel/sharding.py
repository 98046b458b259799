"""Parameter and batch sharding rules: regex on a param path -> PartitionSpec,
laid out as DTensor placements on a DeviceMesh. The counterpart of
ray_tpu/parallel/sharding.py.

The rules and the clamp are the JAX package's. `tree_shardings` turns them
into each leaf's DTensor placements (JAX: NamedShardings), `shard_tree`
places a tree as DTensors (JAX: device_put), and `shard_batch` assembles
each rank's shard of a batch into a global DTensor
(`DTensor.from_local`; JAX: make_array_from_process_local_data).

The model code reads a leaf back with `local_shard` (this rank's tensor,
differentiable: its gradient becomes the DTensor's, with the leaf's
placements) and `spec_of` (the PartitionSpec its placements stand for); a
plain tensor reads as replicated. Rule sets compose by concatenation, the
first match winning: `models.moe.EXPERT_RULES + TRANSFORMER_RULES` for a
tree that holds both (its MoE leaves under a "moe" key).
"""

from __future__ import annotations

import re
from typing import Any, List, Sequence, Tuple

import torch

from .mesh import PartitionSpec, axes_group, mesh_shape, placements

PyTree = Any
Rules = Sequence[Tuple[str, PartitionSpec]]

# Presets for transformer params as models/transformer.py names them
# ("blocks.attn.wq", "embed.embedding"): fsdp shards the contraction-free
# axis, tensor shards heads/ffn.
TRANSFORMER_RULES: Rules = (
    (r".*embed.*embedding$", PartitionSpec(("fsdp",), "tensor")),
    (r".*attn\.(wq|wk|wv)$", PartitionSpec(("fsdp",), "tensor")),
    (r".*attn\.wo$", PartitionSpec("tensor", ("fsdp",))),
    (r".*mlp\.(w_gate|w_up)$", PartitionSpec(("fsdp",), "tensor")),
    (r".*mlp\.w_down$", PartitionSpec("tensor", ("fsdp",))),
    (r".*(norm|scale|bias).*", PartitionSpec()),
    (r".*lm_head$", PartitionSpec(("fsdp",), "tensor")),
    (r".*", PartitionSpec()),
)

# Batch over (data, fsdp), and the sequence over "seq" under sequence
# parallelism.
BATCH_SPEC = PartitionSpec(("data", "fsdp"))
BATCH_SEQ_SPEC = PartitionSpec(("data", "fsdp"), "seq")


def spec_for_path(path: str, rules: Rules) -> PartitionSpec:
    for pattern, spec in rules:
        if re.fullmatch(pattern, path):
            return spec
    return PartitionSpec()


def _clamp_spec(spec: PartitionSpec, shape: Tuple[int, ...], mesh, *,
                align: str = "left") -> PartitionSpec:
    """Drops sharded axes that do not divide the array dim (that dim is
    replicated instead) and trims specs longer than the array's rank.
    align="right" pads a short spec with leading Nones, so a rank-2 rule
    applies to the trailing dims of stacked layer params [n_layers, in, out]
    and replicates the layer dim; batch specs stay left-aligned."""
    sizes = mesh_shape(mesh)
    entries = list(spec)
    if align == "right" and 0 < len(entries) < len(shape):
        entries = [None] * (len(shape) - len(entries)) + entries
    out = []
    for dim, entry in enumerate(entries[:len(shape)]):
        if entry is None:
            out.append(None)
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        total = 1
        for a in axes:
            total *= sizes.get(a, 1)
        out.append(entry if total > 1 and shape[dim] % total == 0 else None)
    while out and out[-1] is None:
        out.pop()
    return PartitionSpec(*out)


def _map_with_path(fn, tree, prefix=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, prefix + (str(k),)) for k, v in tree.items()}
    return fn(".".join(prefix), tree)


def _leaf_spec(path: str, leaf, mesh, rules: Rules) -> PartitionSpec:
    return _clamp_spec(spec_for_path(path, rules), tuple(leaf.shape), mesh, align="right")


def tree_specs(tree: PyTree, mesh, rules: Rules = TRANSFORMER_RULES) -> PyTree:
    """Each leaf's clamped PartitionSpec, by its dotted key path."""
    return _map_with_path(lambda path, leaf: _leaf_spec(path, leaf, mesh, rules), tree)


def tree_shardings(tree: PyTree, mesh, rules: Rules = TRANSFORMER_RULES) -> PyTree:
    """Each leaf's DTensor placements on `mesh`, from the rules."""
    return _map_with_path(
        lambda path, leaf: placements(mesh, _leaf_spec(path, leaf, mesh, rules)), tree)


def dim_axes(spec: PartitionSpec, ndim: int) -> List[tuple]:
    """The mesh axes that split each of a tensor's ndim dims, as tuples."""
    out = []
    for d in range(ndim):
        entry = spec[d] if d < len(spec) else None
        out.append(() if entry is None else entry if isinstance(entry, tuple) else (entry,))
    return out


def shard_slices(shape: Tuple[int, ...], spec: PartitionSpec, mesh) -> Tuple[slice, ...]:
    """This rank's slice of each dim of a tensor of `shape` laid out as
    `spec` on `mesh` (DTensor's even chunks; a dim split over several axes
    is split by the first, each part by the next)."""
    sizes = mesh_shape(mesh)
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    out = []
    for n, axes in zip(shape, dim_axes(spec, len(shape))):
        start, length = 0, n
        for a in axes:
            if length % sizes[a]:
                raise ValueError(f"dim of {n} does not split over {axes} on {sizes}")
            length //= sizes[a]
            start += coord[a] * length
        out.append(slice(start, start + length))
    return tuple(out)


def shard_tree(tree: PyTree, mesh, rules: Rules = TRANSFORMER_RULES) -> PyTree:
    """Every leaf as a DTensor with its rule-derived placements: each rank
    passes the whole (equal) tensor and keeps its shard, with no transfer
    (as distribute_tensor(..., src_data_rank=None))."""
    from torch.distributed.tensor import DTensor

    def one(path, leaf):
        spec = _leaf_spec(path, leaf, mesh, rules)
        local = leaf.detach()[shard_slices(tuple(leaf.shape), spec, mesh)].clone()
        out = DTensor.from_local(local, mesh, list(placements(mesh, spec)), run_check=False,
                                 shape=leaf.shape, stride=leaf.contiguous().stride())
        return out.requires_grad_(leaf.requires_grad)

    return _map_with_path(one, tree)


def spec_of(leaf) -> PartitionSpec:
    """The PartitionSpec a DTensor's placements stand for (a plain tensor:
    replicated). An entry is one axis name, or a tuple where several mesh
    dims split one tensor dim."""
    from torch.distributed.tensor import DTensor, Shard

    if not isinstance(leaf, DTensor):
        return PartitionSpec()
    entries: List[list] = [[] for _ in range(leaf.ndim)]
    for name, p in zip(leaf.device_mesh.mesh_dim_names, leaf.placements):
        if isinstance(p, Shard):
            entries[p.dim].append(name)
        elif not p.is_replicate():
            raise ValueError(f"placement {p} of a param on {name!r} is neither Shard nor "
                             "Replicate")
    out = [None if not e else e[0] if len(e) == 1 else tuple(e) for e in entries]
    while out and out[-1] is None:
        out.pop()
    return PartitionSpec(*out)


def local_shard(leaf) -> torch.Tensor:
    """This rank's tensor of a leaf: a DTensor's local shard (to_local, so
    its gradient lands on the DTensor with the leaf's placements), or a
    plain tensor itself."""
    from torch.distributed.tensor import DTensor

    return leaf.to_local() if isinstance(leaf, DTensor) else leaf


def grad_group(mesh, spec: PartitionSpec, batch: Sequence[str]):
    """The group a leaf's gradient is summed over (collectives.grad_sum):
    the dims of `batch` (those whose ranks hold other parts of the batch)
    that the leaf is not split over; None where that is none."""
    split = {a for axes in dim_axes(spec, len(spec)) for a in axes}
    rest = tuple(a for a in batch if a not in split)
    return axes_group(mesh, rest) if rest else None


def replicated(mesh) -> tuple:
    """Placements of a tensor replicated on every rank of `mesh`."""
    return placements(mesh, PartitionSpec())


def replicate_tree(tree: PyTree, mesh) -> PyTree:
    """Every leaf as a DTensor replicated on `mesh`. Callers pass values that
    are equal on every rank by construction (seeded init, broadcast
    weights), so nothing is compared."""
    from torch.distributed.tensor import DTensor

    return _map_with_path(lambda path, leaf: DTensor.from_local(
        leaf, mesh, list(replicated(mesh)), run_check=False), tree)


def batch_sharding(mesh, *, seq: bool = False) -> tuple:
    """Placements of a batch: over (data, fsdp), and its sequence over "seq"."""
    return placements(mesh, BATCH_SEQ_SPEC if seq else BATCH_SPEC)


def shard_batch(batch: PyTree, mesh, *, seq: bool = False) -> PyTree:
    """A batch as global DTensors over (data, fsdp)[, seq].

    In a world of one rank each leaf is the global batch
    (`distribute_tensor`). With several ranks each passes ITS shard of the
    global batch, [b / n_ranks, ...], and the leaves assemble into global
    DTensors (`DTensor.from_local`), as each DDP rank gets its sampler's
    shard; a global batch dim that the batch axes do not divide raises."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    n_proc = mesh.size()
    spec_of = BATCH_SEQ_SPEC if seq else BATCH_SPEC

    def one(path, leaf):
        shape = tuple(leaf.shape)
        if n_proc > 1:
            # each rank holds 1/n_proc of the batch: judge divisibility
            # against the GLOBAL shape
            shape = (shape[0] * n_proc,) + shape[1:]
        spec = _clamp_spec(spec_of, shape, mesh)
        if n_proc == 1:
            return distribute_tensor(leaf, mesh, list(placements(mesh, spec)))
        if not spec or spec[0] is None:
            # replicating the batch dim while each rank holds a DIFFERENT
            # shard would diverge the ranks silently
            raise ValueError(
                f"global batch dim {shape[0]} is not divisible by the batch mesh axes on a "
                f"{n_proc}-process mesh; pad the batch or adjust data/fsdp axis sizes")
        return DTensor.from_local(leaf, mesh, list(placements(mesh, spec)), run_check=False)

    return _map_with_path(one, batch)


__all__ = ["BATCH_SEQ_SPEC", "BATCH_SPEC", "PartitionSpec", "TRANSFORMER_RULES", "batch_sharding",
           "dim_axes", "grad_group", "local_shard", "replicate_tree", "replicated", "shard_batch",
           "shard_slices", "shard_tree", "spec_for_path", "spec_of", "tree_shardings", "tree_specs"]
