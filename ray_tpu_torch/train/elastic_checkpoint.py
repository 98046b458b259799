"""World-size-independent ("elastic") checkpoints, the counterpart of
ray_tpu/train/elastic_checkpoint.py, in the same on-disk format.

Every leaf of a tree is stored as its global logical array, split into
per-rank files along a deterministic flat partition, with a JSON manifest
of the global shapes. A checkpoint written at world N restores at world M by
index arithmetic alone, and a rank reads only the bytes that overlap its
new slice.

Layout (one directory; several kinds may share it):

    <dir>/<kind>_manifest.json            # format/kind/step/world_size/leaves/meta
    <dir>/<kind>_shard_00002of00004.npz   # rank 2 of 4's slice of every leaf
    <dir>/<kind>_structure.json           # the port's: each leaf's key path
    <dir>/<kind>_treedef.pkl              # the JAX package's: a pickled PyTreeDef

Partition: a leaf flattened to length L; rank r of N owns
[L*r//N, L*(r+1)//N). Each shard holds uint8 views of the raw bytes, keyed
by leaf index, with the dtype's name in the manifest, so bfloat16 is read
without ml_dtypes (raw bytes, viewed as torch.bfloat16).

Leaves are numbered in jax.tree_util's order (dict keys sorted;
models/convert.py `flatten`), so the two packages read each other's files:
a JAX-written checkpoint restores here, and one written here reads in JAX
through `load_shard`. The treedef pickle cannot be loaded without jax, so
the port writes each leaf's key path into `<kind>_structure.json` instead
and restores its trees from that; a JAX-written kind has no such file, and
its restore takes `like`, a tree with the same key paths (e.g. the port's
params, or `{"count": 0, "mu": params, "nu": params}` for optax adamw's
state). Trees are nested dicts of tensors (or numpy arrays, or numbers);
restored leaves are CPU tensors. `reshard` copies a treedef pickle it finds
as bytes, so a resharded JAX checkpoint stays readable in JAX.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models.convert import flatten, to_tensor, unflatten

FORMAT = "raytpu-elastic-v1"

# numpy's dtype names, which the JAX package writes, and torch's dtypes.
DTYPES = {
    "float64": torch.float64, "float32": torch.float32, "float16": torch.float16,
    "bfloat16": torch.bfloat16, "int64": torch.int64, "int32": torch.int32,
    "int16": torch.int16, "int8": torch.int8, "uint8": torch.uint8, "bool": torch.bool,
}
_NAMES = {v: k for k, v in DTYPES.items()}


def _raw_bytes(flat: torch.Tensor) -> np.ndarray:
    """A 1-D tensor's bytes as a uint8 numpy array."""
    return flat.contiguous().view(torch.uint8).numpy() if flat.numel() else np.empty(0, np.uint8)


def shard_bounds(n_elems: int, world_size: int, rank: int) -> Tuple[int, int]:
    """Rank `rank` of `world_size`'s [start, stop) slice of a flat leaf."""
    if world_size < 1 or not (0 <= rank < world_size):
        raise ValueError(f"bad shard coords rank={rank} world={world_size}")
    return (n_elems * rank) // world_size, (n_elems * (rank + 1)) // world_size


def _observe(op: str, t0: float) -> None:
    from ..utils import internal_metrics as imet

    imet.TRAIN_RESHARD_TIME.observe((time.perf_counter() - t0) * 1e3, op=op)


def _shard_file(kind: str, rank: int, world_size: int) -> str:
    return f"{kind}_shard_{rank:05d}of{world_size:05d}.npz"


def _write_atomic(path: str, write) -> None:
    """Writes through path.tmp and a rename, so a preemption mid-save leaves
    no torn file."""
    with open(path + ".tmp", "wb") as f:
        write(f)
    os.replace(path + ".tmp", path)


def _write_json(path: str, payload) -> None:
    _write_atomic(path, lambda f: f.write(json.dumps(payload, indent=1).encode()))


def save_shards(
    directory: str,
    tree: Any,
    *,
    kind: str = "params",
    world_size: int = 1,
    rank: int = 0,
    step: int = 0,
    meta: Optional[Dict[str, Any]] = None,
) -> None:
    """Writes `rank`'s shard of `tree` (and, from rank 0, the manifest and
    the structure file). Pass the full logical tree: only this rank's
    [start, stop) bytes of each leaf are written."""
    t0 = time.perf_counter()
    os.makedirs(directory, exist_ok=True)
    paths, leaves = flatten(tree)
    arrays: Dict[str, np.ndarray] = {}
    entries: List[Dict[str, Any]] = []
    for i, leaf in enumerate(leaves):
        t = to_tensor(leaf)
        flat = t.reshape(-1)
        start, stop = shard_bounds(flat.numel(), world_size, rank)
        arrays[str(i)] = _raw_bytes(flat[start:stop])
        entries.append({"shape": list(t.shape), "dtype": _NAMES[t.dtype],
                        "size": int(flat.numel())})
    _write_atomic(os.path.join(directory, _shard_file(kind, rank, world_size)),
                  lambda f: np.savez(f, **arrays))
    if rank == 0:
        _write_json(os.path.join(directory, f"{kind}_manifest.json"), {
            "format": FORMAT, "kind": kind, "step": int(step), "world_size": int(world_size),
            "leaves": entries, "meta": dict(meta or {}),
        })
        _write_json(os.path.join(directory, f"{kind}_structure.json"),
                    {"format": FORMAT, "paths": [list(p) for p in paths]})
    _observe("save", t0)


def read_manifest(directory: str, kind: str = "params") -> Dict[str, Any]:
    with open(os.path.join(directory, f"{kind}_manifest.json")) as f:
        manifest = json.load(f)
    if manifest.get("format") != FORMAT:
        raise ValueError(
            f"{directory}: unknown elastic checkpoint format {manifest.get('format')!r}")
    return manifest


def has_kind(directory: str, kind: str = "params") -> bool:
    return os.path.exists(os.path.join(directory, f"{kind}_manifest.json"))


class _SavedShards:
    """A saved kind's shard files, opened as they are first read and closed
    on exit."""

    def __init__(self, directory: str, kind: str, manifest: Dict[str, Any]):
        self.directory, self.kind = directory, kind
        self.world, self.leaves = manifest["world_size"], manifest["leaves"]
        self.files: Dict[int, Any] = {}

    def __enter__(self) -> "_SavedShards":
        return self

    def __exit__(self, *exc) -> None:
        for f in self.files.values():
            f.close()

    def slice(self, i: int, start: int, stop: int) -> torch.Tensor:
        """[start, stop) of leaf i's flat global data, reading only the saved
        shards that overlap."""
        entry = self.leaves[i]
        out = torch.empty(stop - start, dtype=DTYPES[entry["dtype"]])
        out_bytes = out.view(torch.uint8) if out.numel() else out
        es = out.element_size()
        for r in range(self.world):
            s0, s1 = shard_bounds(entry["size"], self.world, r)
            lo, hi = max(start, s0), min(stop, s1)
            if lo >= hi:
                continue
            if r not in self.files:
                self.files[r] = np.load(os.path.join(
                    self.directory, _shard_file(self.kind, r, self.world)))
            raw = torch.from_numpy(self.files[r][str(i)])  # a fresh array per read
            out_bytes[(lo - start) * es:(hi - start) * es] = raw[(lo - s0) * es:(hi - s0) * es]
        return out


def _paths(directory: str, kind: str, like) -> List[Tuple[str, ...]]:
    if like is not None:
        return flatten(like)[0]
    path = os.path.join(directory, f"{kind}_structure.json")
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"{directory}: {kind} has no {kind}_structure.json (a JAX-written checkpoint "
            "keeps its structure in a pickled PyTreeDef); pass like=, a tree with its key paths")
    with open(path) as f:
        return [tuple(p) for p in json.load(f)["paths"]]


def load_full(directory: str, kind: str = "params", like=None) -> Tuple[Any, Dict[str, Any]]:
    """Reassembles the full tree (CPU tensors) from all saved shards, at any
    saved world size; structure from the structure file or from `like`."""
    t0 = time.perf_counter()
    manifest = read_manifest(directory, kind)
    paths = _paths(directory, kind, like)
    if len(paths) != len(manifest["leaves"]):
        raise ValueError(f"{directory}: {kind} has {len(manifest['leaves'])} leaves, the "
                         f"structure {len(paths)}")
    with _SavedShards(directory, kind, manifest) as saved:
        leaves = [saved.slice(i, 0, e["size"]).reshape(e["shape"])
                  for i, e in enumerate(manifest["leaves"])]
    _observe("load", t0)
    return unflatten(paths, leaves), manifest


def load_shard(directory: str, *, world_size: int, rank: int,
               kind: str = "params") -> Tuple[List[torch.Tensor], Dict[str, Any]]:
    """Rank `rank` of a NEW `world_size`'s flat slice of every leaf, reading
    only the overlapping bytes of the saved shard files: (flat slices, one
    per leaf, and the manifest)."""
    t0 = time.perf_counter()
    manifest = read_manifest(directory, kind)
    with _SavedShards(directory, kind, manifest) as saved:
        slices = [saved.slice(i, *shard_bounds(e["size"], world_size, rank))
                  for i, e in enumerate(manifest["leaves"])]
    _observe("load", t0)
    return slices, manifest


def _copy_file(src: str, dst: str) -> None:
    if os.path.exists(src) and os.path.abspath(src) != os.path.abspath(dst):
        with open(src, "rb") as fin:
            data = fin.read()
        _write_atomic(dst, lambda f: f.write(data))


def reshard(src: str, dst: str, new_world_size: int, kind: str = "params") -> None:
    """Rewrites a saved kind at another world size, one new rank's slice at a
    time, without building the whole tree in one buffer."""
    t0 = time.perf_counter()
    manifest = read_manifest(src, kind)
    os.makedirs(dst, exist_ok=True)
    with _SavedShards(src, kind, manifest) as saved:
        for r in range(new_world_size):
            arrays = {
                str(i): _raw_bytes(saved.slice(i, *shard_bounds(e["size"], new_world_size, r)))
                for i, e in enumerate(manifest["leaves"])
            }
            _write_atomic(os.path.join(dst, _shard_file(kind, r, new_world_size)),
                          lambda f: np.savez(f, **arrays))
    _write_json(os.path.join(dst, f"{kind}_manifest.json"),
                dict(manifest, world_size=int(new_world_size)))
    for name in (f"{kind}_structure.json", f"{kind}_treedef.pkl"):
        _copy_file(os.path.join(src, name), os.path.join(dst, name))
    _observe("reshard", t0)


# --------------------------------------------------- trainer-facing bundle


def save_state(
    directory: str,
    params: Any,
    opt_state: Any = None,
    *,
    step: int = 0,
    world_size: int = 1,
    rank: int = 0,
    meta: Optional[Dict[str, Any]] = None,
) -> None:
    """Saves the training state pair: params (the replicated logical tree)
    and the optimizer state as its logical tree: models/convert.py
    `opt_state_to_torch` of a plain AdamW, or `ZeroSharder.to_logical` of a
    ZeRO one. Per-rank slicing is this format's job."""
    save_shards(directory, params, kind="params", world_size=world_size, rank=rank,
                step=step, meta=meta)
    if opt_state is not None:
        save_shards(directory, opt_state, kind="opt", world_size=world_size, rank=rank,
                    step=step, meta=meta)


def load_state(directory: str, *, params_like=None, opt_like=None) -> Dict[str, Any]:
    """Full restore of a save_state checkpoint: {"params", "opt_state" (None
    when absent), "step", "meta", "saved_world_size"}, CPU tensors. The
    `*_like` trees give the structure of a JAX-written checkpoint. Device
    placement and ZeRO re-slicing (`ZeroSharder.from_logical`) are the
    caller's."""
    params, manifest = load_full(directory, "params", params_like)
    opt_state = None
    if has_kind(directory, "opt"):
        opt_state, _ = load_full(directory, "opt", opt_like)
    return {
        "params": params,
        "opt_state": opt_state,
        "step": manifest["step"],
        "meta": manifest.get("meta", {}),
        "saved_world_size": manifest["world_size"],
    }
