"""Moves transformer and MLP params and AdamW state between the JAX
package's pytrees and the port.

`params_from_numpy` takes the JAX param tree with each leaf converted by
`np.asarray` (bfloat16 leaves arrive as numpy arrays of the `bfloat16`
extension dtype) and returns the port's tree on `device`, in cfg.dtype.
`params_to_numpy` goes back; numpy has no built-in bfloat16, so bfloat16
tensors come out as float32 arrays, which widens them exactly. Both use the
key paths of `init_params`, and the shapes are checked against them.

`opt_state_to_torch` / `opt_state_to_numpy` / `opt_state_from_numpy` map
torch.optim.AdamW's per-param state (step, exp_avg, exp_avg_sq) to and from
optax adamw's `ScaleByAdamState(count, mu, nu)`, as the dict
{"count": int32 scalar, "mu": tree, "nu": tree}, mu and nu shaped like the
params. These keep every bit: a checkpoint must not widen bfloat16.

`mlp_params_from_numpy` does the same for models/mlp.py's tree.

`flatten` and `unflatten` order a tree's leaves as `jax.tree_util` does:
dict keys sorted (so "blocks/attn/wk" comes before "wo", and ZeRO's leaf
indices "0", "1", "10", ..., "2" sort as strings), list items in order (the
MLP's layers), not in insertion order as `transformer.tree_leaves` has
them. Every leaf index that crosses between
the packages (an elastic checkpoint's manifest, ZeRO's keys) uses it.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple, Union

import numpy as np
import torch

from .transformer import Params, TransformerConfig, map_tree, param_spec

Path = Tuple[Union[str, int], ...]


def flatten(tree) -> Tuple[List[Path], List[Any]]:
    """(key paths, leaves) in jax.tree_util's order: a dict's keys sorted, a
    list's items in order (their path keys are ints), anything else a
    leaf."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        for key in keys:
            if not isinstance(key, str):
                raise TypeError(f"tree keys must be str, got {key!r}")
    elif isinstance(tree, list):
        keys = range(len(tree))
    else:
        return [()], [tree]
    paths, leaves = [], []
    for key in keys:
        sub_paths, sub_leaves = flatten(tree[key])
        paths += [(key, *p) for p in sub_paths]
        leaves += sub_leaves
    return paths, leaves


def _lists(node):
    """A nested dict whose int-keyed levels become lists."""
    if not isinstance(node, dict):
        return node
    out = {k: _lists(v) for k, v in node.items()}
    if out and all(isinstance(k, int) for k in out):
        return [out[i] for i in range(len(out))]
    return out


def unflatten(paths: List[Path], leaves: List[Any]):
    """The tree with `leaves` at `paths` (flatten's inverse)."""
    if list(paths) == [()]:
        return leaves[0]
    tree: Dict[Any, Any] = {}
    for path, leaf in zip(paths, leaves):
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return _lists(tree)


def to_tensor(x) -> torch.Tensor:
    """A leaf (a tensor, a numpy array, bfloat16 as ml_dtypes' dtype, or a
    number) as a CPU tensor with the same bits: a copy."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    arr = np.array(x)  # a writable copy: jax's host buffers are read-only
    if arr.dtype.name == "bfloat16":  # ml_dtypes bfloat16: same bits as torch's
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host copy with the same bits; numpy has no bfloat16, so a bfloat16
    tensor comes out as a uint16 array of its bits (`.view(ml_dtypes.bfloat16)`
    is JAX's array)."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


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
    return map_tree(lambda a: to_tensor(a).to(device=dev, dtype=cfg.dtype), tree)


def params_to_numpy(params: Params):
    """The port's params -> a tree of numpy arrays (bfloat16 as float32)."""

    def to_np(t: torch.Tensor):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()

    return map_tree(to_np, params)


# ------------------------------------------------------------ AdamW state


def _param_leaves(optimizer: torch.optim.Optimizer, params):
    """(paths, leaves, group of each leaf by id) of the optimizer's params."""
    paths, leaves = flatten(params)
    groups = {id(p): g for g in optimizer.param_groups for p in g["params"]}
    for path, t in zip(paths, leaves):
        if id(t) not in groups:
            raise ValueError(f"param {'/'.join(path)} is not one of the optimizer's params")
    return paths, leaves, groups


def opt_state_to_torch(optimizer: torch.optim.Optimizer, params) -> Dict[str, Any]:
    """AdamW's state over `params` (the tensors the optimizer was built on)
    as optax's ScaleByAdamState: {"count", "mu", "nu"}, CPU copies in the
    params' dtype. Before the first step it is optax's init: count 0 and
    zero moments."""
    paths, leaves, _ = _param_leaves(optimizer, params)
    counts, mu, nu = set(), [], []
    for t in leaves:
        state = optimizer.state.get(t)
        if not state:
            counts.add(0)
            mu.append(torch.zeros(t.shape, dtype=t.dtype))
            nu.append(torch.zeros(t.shape, dtype=t.dtype))
            continue
        counts.add(int(state["step"]))
        mu.append(state["exp_avg"].detach().to("cpu", copy=True))
        nu.append(state["exp_avg_sq"].detach().to("cpu", copy=True))
    if len(counts) > 1:
        raise ValueError(f"params were stepped unequally often ({sorted(counts)}); optax "
                         "keeps one count")
    return {"count": torch.tensor(counts.pop() if counts else 0, dtype=torch.int32),
            "mu": unflatten(paths, mu), "nu": unflatten(paths, nu)}


def opt_state_to_numpy(optimizer: torch.optim.Optimizer, params) -> Dict[str, Any]:
    """opt_state_to_torch with numpy leaves (bfloat16 as uint16 bits, see
    tensor_to_numpy)."""
    state = opt_state_to_torch(optimizer, params)
    return {"count": tensor_to_numpy(state["count"]),
            "mu": map_tree(tensor_to_numpy, state["mu"]),
            "nu": map_tree(tensor_to_numpy, state["nu"])}


def as_tensor(x, dtype: torch.dtype, shape) -> torch.Tensor:
    """to_tensor(x), where a bfloat16 leaf may also come as uint16 bits;
    raises unless it has `dtype` and `shape`."""
    t = to_tensor(x)
    if dtype == torch.bfloat16 and t.dtype == torch.uint16:
        t = t.view(torch.bfloat16)
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"leaf {t.dtype} {tuple(t.shape)} does not match {dtype} {tuple(shape)}")
    return t


def _adam_fields(state):
    if isinstance(state, dict):
        return state["count"], state["mu"], state["nu"]
    return state.count, state.mu, state.nu  # optax's ScaleByAdamState


def opt_state_from_numpy(state, optimizer: torch.optim.Optimizer, params) -> None:
    """Loads optax adamw's ScaleByAdamState (the namedtuple, or the dict of
    opt_state_to_torch; leaves numpy or tensors) into `optimizer`'s state
    for `params`, bit for bit: step = count, exp_avg = mu, exp_avg_sq = nu."""
    count, mu, nu = _adam_fields(state)
    paths, leaves, groups = _param_leaves(optimizer, params)
    if flatten(mu)[0] != paths or flatten(nu)[0] != paths:
        raise ValueError("mu/nu trees do not have the params' key paths")
    step = float(np.asarray(count.cpu() if isinstance(count, torch.Tensor) else count))
    for t, m, v in zip(leaves, flatten(mu)[1], flatten(nu)[1]):
        # torch keeps step on the host unless the optimizer is fused or capturable
        group = groups[id(t)]
        dev = t.device if group.get("fused") or group.get("capturable") else "cpu"
        optimizer.state[t] = {"step": torch.tensor(step, dtype=torch.float32, device=dev),
                              "exp_avg": as_tensor(m, t.dtype, t.shape).to(t.device),
                              "exp_avg_sq": as_tensor(v, t.dtype, t.shape).to(t.device)}


# ------------------------------------------------------------------- MLP


def mlp_params_from_numpy(tree, cfg, device=None):
    """The JAX package's MLP params ({"layers": [{"w", "b"}, ...]}, numpy
    leaves) -> the port's models/mlp.py tree on `device`, in cfg.dtype."""
    from .._device import resolve_device

    dev = resolve_device(device)
    layers = tree["layers"]
    dims = cfg.dims
    if len(layers) != len(dims) - 1:
        raise ValueError(f"MLP tree has {len(layers)} layers, cfg {len(dims) - 1}")
    out = []
    for i, (layer, din, dout) in enumerate(zip(layers, dims[:-1], dims[1:])):
        if set(layer) != {"w", "b"}:
            raise ValueError(f"MLP layer {i}: want keys ['b', 'w'], got {sorted(layer)}")
        if np.shape(layer["w"]) != (din, dout) or np.shape(layer["b"]) != (dout,):
            raise ValueError(f"MLP layer {i}: want w {(din, dout)} and b {(dout,)}, got "
                             f"{np.shape(layer['w'])} and {np.shape(layer['b'])}")
        out.append({k: to_tensor(layer[k]).to(device=dev, dtype=cfg.dtype) for k in ("w", "b")})
    return {"layers": out}


# ------------------------------------------------------------------- MoE


def moe_params_from_numpy(tree, cfg, device=None):
    """The JAX package's MoE params ({"router", "w_up", "w_down"}, numpy
    leaves) -> the port's models/moe.py tree on `device`, in cfg.dtype."""
    from .._device import resolve_device

    dev = resolve_device(device)
    E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    spec = {"router": ((d, E),), "w_up": ((E, d, f),), "w_down": ((E, f, d),)}
    _check_tree(tree, spec)
    return {k: to_tensor(tree[k]).to(device=dev, dtype=cfg.dtype) for k in spec}
