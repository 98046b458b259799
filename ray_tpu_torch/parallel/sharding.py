"""Parameter and batch sharding rules: regex on a param path -> PartitionSpec,
laid out as DTensor placements on a DeviceMesh. The counterpart of
ray_tpu/parallel/sharding.py.

The rules and the clamp are the JAX package's. `tree_shardings` turns them
into each leaf's DTensor placements (JAX: NamedShardings), `shard_tree`
places a tree with `distribute_tensor` (JAX: device_put), and `shard_batch`
assembles each rank's shard of a batch into a global DTensor
(`DTensor.from_local`; JAX: make_array_from_process_local_data).
"""

from __future__ import annotations

import re
from typing import Any, Sequence, Tuple

from .mesh import PartitionSpec, mesh_shape, placements

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


def shard_tree(tree: PyTree, mesh, rules: Rules = TRANSFORMER_RULES) -> PyTree:
    """Every leaf as a DTensor with its rule-derived placements: each rank
    passes the whole (equal) tensor and keeps its shard."""
    from torch.distributed.tensor import distribute_tensor

    return _map_with_path(lambda path, leaf: distribute_tensor(
        leaf, mesh, list(placements(mesh, _leaf_spec(path, leaf, mesh, rules)))), tree)


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
           "replicate_tree", "replicated", "shard_batch", "shard_tree", "spec_for_path", "tree_shardings",
           "tree_specs"]
