"""Moves transformer params between the JAX package's pytree and the port.

`params_from_numpy` takes the JAX param tree with each leaf converted by
`np.asarray` (bfloat16 leaves arrive as numpy arrays of the `bfloat16`
extension dtype) and returns the port's tree on `device`, in cfg.dtype.
`params_to_numpy` goes back; numpy has no built-in bfloat16, so bfloat16
tensors come out as float32 arrays, which widens them exactly. Both use the
key paths of `init_params`, and the shapes are checked against them.
"""

from __future__ import annotations

import numpy as np
import torch

from .transformer import Params, TransformerConfig, map_tree, param_spec


def _leaf_to_tensor(arr) -> torch.Tensor:
    arr = np.array(arr)  # a writable copy: jax's host buffers are read-only
    if arr.dtype.name == "bfloat16":  # ml_dtypes bfloat16: same bits as torch's
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _check_tree(tree, spec, path: str = "") -> None:
    if isinstance(spec, dict):
        if not isinstance(tree, dict) or set(tree) != set(spec):
            got = sorted(tree) if isinstance(tree, dict) else type(tree).__name__
            raise ValueError(f"param tree at {path or '/'}: want keys {sorted(spec)}, got {got}")
        for k in spec:
            _check_tree(tree[k], spec[k], f"{path}/{k}")
        return
    want = tuple(spec[0])
    if tuple(np.shape(tree)) != want:
        raise ValueError(f"param {path}: want shape {want}, got {tuple(np.shape(tree))}")


def params_from_numpy(tree, cfg: TransformerConfig, device=None) -> Params:
    """JAX param tree (numpy leaves) -> the port's params on `device`."""
    from .._device import resolve_device

    dev = resolve_device(device)
    _check_tree(tree, param_spec(cfg))
    return map_tree(lambda a: _leaf_to_tensor(a).to(device=dev, dtype=cfg.dtype), tree)


def params_to_numpy(params: Params):
    """The port's params -> a tree of numpy arrays (bfloat16 as float32)."""

    def to_np(t: torch.Tensor):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()

    return map_tree(to_np, params)
