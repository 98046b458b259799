"""Checkpoint directory, keep-K manager and storage context, and pytree
save/restore: the counterpart of ray_tpu/train/checkpoint.py.

`Checkpoint`, `CheckpointManager` and `StorageContext` are the port's own
copies of the JAX package's (they touch no JAX). `save_pytree` writes a
tree of tensors as `pytree.npz`, each leaf's raw bytes as uint8 (bfloat16
included, with no ml_dtypes), beside `pytree.json` with each leaf's key path
(jax.tree_util's order), dtype and shape; the JAX package writes an orbax
directory (or its own npz and a pickled PyTreeDef), which the port does not
read. `save_aux_state` pickles host-side state such as an optimizer's
`state_dict()` beside it.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pickle
import shutil
import tempfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models.convert import flatten, to_tensor, unflatten
from .elastic_checkpoint import DTYPES, _NAMES, _raw_bytes, _write_atomic

_PYTREE_NPZ, _PYTREE_JSON = "pytree.npz", "pytree.json"


class Checkpoint:
    """A directory of files (framework-agnostic), created via
    `Checkpoint.from_directory` (reference: python/ray/train/_checkpoint.py)."""

    def __init__(self, path: str):
        self.path = os.path.abspath(path)

    @classmethod
    def from_directory(cls, path: str) -> "Checkpoint":
        return cls(path)

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "Checkpoint":
        d = tempfile.mkdtemp(prefix="rt-ckpt-")
        with open(os.path.join(d, "data.pkl"), "wb") as f:
            pickle.dump(data, f)
        return cls(d)

    def to_dict(self) -> Dict[str, Any]:
        with open(os.path.join(self.path, "data.pkl"), "rb") as f:
            return pickle.load(f)

    def as_directory(self) -> str:
        return self.path

    def __repr__(self):
        return f"Checkpoint({self.path})"


def save_pytree(tree: Any, directory: str) -> None:
    """Saves a tree (nested dicts of tensors, numpy arrays or numbers) bit
    for bit; tensors may be on any device."""
    os.makedirs(directory, exist_ok=True)
    paths, leaves = flatten(tree)
    tensors = [to_tensor(leaf) for leaf in leaves]
    arrays = {str(i): _raw_bytes(t.reshape(-1)) for i, t in enumerate(tensors)}
    _write_atomic(os.path.join(directory, _PYTREE_NPZ), lambda f: np.savez(f, **arrays))
    index = [{"path": list(p), "dtype": _NAMES[t.dtype], "shape": list(t.shape)}
             for p, t in zip(paths, tensors)]
    _write_atomic(os.path.join(directory, _PYTREE_JSON),
                  lambda f: f.write(json.dumps({"leaves": index}).encode()))


def load_pytree(directory: str, like: Any = None) -> Any:
    """Restores a tree saved by save_pytree. Without `like`, tensors come
    back on the CPU; with `like` (a tree with the same key paths), each leaf
    goes to the device of like's leaf."""
    index_path = os.path.join(directory, _PYTREE_JSON)
    if not os.path.exists(index_path):
        raise FileNotFoundError(
            f"{directory}: no {_PYTREE_JSON}; the port reads its own save_pytree format, "
            "not the JAX package's orbax directory or pickled PyTreeDef")
    with open(index_path) as f:
        index = json.load(f)["leaves"]
    data = np.load(os.path.join(directory, _PYTREE_NPZ))
    leaves = []
    for i, e in enumerate(index):
        dtype, raw = DTYPES[e["dtype"]], torch.from_numpy(data[str(i)])
        t = raw.view(dtype) if raw.numel() else torch.empty(0, dtype=dtype)
        leaves.append(t.reshape(e["shape"]))
    paths = [tuple(e["path"]) for e in index]
    if like is not None:
        like_paths, like_leaves = flatten(like)
        if like_paths != paths:
            raise ValueError(f"{directory}: saved key paths differ from like's")
        leaves = [t.to(getattr(ref, "device", "cpu")) for t, ref in zip(leaves, like_leaves)]
    return unflatten(paths, leaves)


def save_aux_state(directory: str, payload: Any) -> None:
    """Pickles host-side auxiliary training state (an optimizer's
    `state_dict()`, RNG state) beside a pytree checkpoint, through a temp
    file and a rename so a crash mid-save leaves no truncated file."""
    os.makedirs(directory, exist_ok=True)
    _write_atomic(os.path.join(directory, "opt_state.pkl"), lambda f: pickle.dump(payload, f))


def load_aux_state(directory: str) -> Optional[Any]:
    """Inverse of save_aux_state; None when the checkpoint has none or the
    file is unreadable (callers start a fresh optimizer: an intact params
    tree must stay restorable)."""
    path = os.path.join(directory, "opt_state.pkl")
    if not os.path.exists(path):
        return None
    try:
        with open(path, "rb") as f:
            return pickle.load(f)
    except (OSError, EOFError, ValueError, pickle.UnpicklingError):
        return None


@dataclasses.dataclass
class _TrackedCheckpoint:
    checkpoint: Checkpoint
    index: int
    metrics: Dict[str, Any]


class CheckpointManager:
    """Keep-K retention by score attribute
    (reference: python/ray/train/_internal/checkpoint_manager.py)."""

    def __init__(
        self,
        num_to_keep: Optional[int] = None,
        score_attribute: Optional[str] = None,
        score_order: str = "max",
    ):
        if num_to_keep is not None and num_to_keep <= 0:
            raise ValueError("num_to_keep must be positive or None")
        if score_order not in ("max", "min"):
            raise ValueError("score_order must be 'max' or 'min'")
        self._num_to_keep = num_to_keep
        self._score_attribute = score_attribute
        self._score_order = score_order
        self._checkpoints: List[_TrackedCheckpoint] = []
        self._next_index = 0

    def register(self, checkpoint: Checkpoint, metrics: Dict[str, Any]) -> None:
        self._checkpoints.append(
            _TrackedCheckpoint(checkpoint, self._next_index, dict(metrics or {}))
        )
        self._next_index += 1
        self._evict()

    def _score(self, t: _TrackedCheckpoint) -> Tuple:
        if self._score_attribute and self._score_attribute in t.metrics:
            v = float(t.metrics[self._score_attribute])
            return (v if self._score_order == "max" else -v, t.index)
        return (float("-inf"), t.index)

    def _evict(self) -> None:
        if self._num_to_keep is None:
            return
        while len(self._checkpoints) > self._num_to_keep:
            worst = min(self._checkpoints, key=self._score)
            self._checkpoints.remove(worst)
            shutil.rmtree(worst.checkpoint.path, ignore_errors=True)

    @property
    def best_checkpoint(self) -> Optional[Checkpoint]:
        if not self._checkpoints:
            return None
        return max(self._checkpoints, key=self._score).checkpoint

    @property
    def latest_checkpoint(self) -> Optional[Checkpoint]:
        if not self._checkpoints:
            return None
        return max(self._checkpoints, key=lambda t: t.index).checkpoint

    @property
    def checkpoints(self) -> List[Checkpoint]:
        return [t.checkpoint for t in self._checkpoints]


class StorageContext:
    """Resolves the experiment/trial directory layout and persists worker
    checkpoints into it (reference: python/ray/train/_internal/storage.py:358)."""

    def __init__(self, storage_path: str, experiment_name: str, trial_name: str = ""):
        self.storage_path = os.path.abspath(storage_path)
        self.experiment_name = experiment_name
        self.trial_name = trial_name

    @property
    def experiment_dir(self) -> str:
        return os.path.join(self.storage_path, self.experiment_name)

    @property
    def trial_dir(self) -> str:
        d = self.experiment_dir
        return os.path.join(d, self.trial_name) if self.trial_name else d

    def persist_checkpoint(self, checkpoint: Checkpoint, index: int) -> Checkpoint:
        dest = os.path.join(self.trial_dir, f"checkpoint_{index:06d}")
        if os.path.abspath(checkpoint.path) != dest:
            if os.path.exists(dest):
                shutil.rmtree(dest)
            os.makedirs(os.path.dirname(dest), exist_ok=True)
            shutil.copytree(checkpoint.path, dest)
        return Checkpoint(dest)

    def write_json(self, name: str, payload: Dict[str, Any]) -> None:
        os.makedirs(self.trial_dir, exist_ok=True)
        with open(os.path.join(self.trial_dir, name), "w") as f:
            json.dump(payload, f, indent=2, default=str)
