"""Switch Mixture-of-Experts layer with expert parallelism over a
DeviceMesh: the counterpart of ray_tpu/models/moe.py (top-1 routing with a
capacity per expert; Shazeer et al. 2017, Fedus et al. 2021).

Routing is the JAX function's: the router's softmax in float32, each token
to its argmax expert (the first on ties), its position in that expert's
capacity C = max(1, int(capacity_factor * N / E)) counted over all N tokens
in order, tokens past C passing through unchanged, the expert MLP (tanh
gelu) in float32, y cast back to x's dtype, and the Switch aux loss
E * sum_e load_e * importance_e. Gradients reach the router only through
the gate (dispatch is one-hot). Where JAX builds dense [N, E, C] one-hot
dispatch and combine tensors and contracts them, the port scatters each
kept token into its (expert, slot) row of an [E, C, d] buffer and gathers
it back: each slot holds at most one token, so the sums are the same.

`EXPERT_RULES` put the experts over "expert" and each expert's d_ff over
"tensor"; compose them with the transformer's (`EXPERT_RULES +
parallel.TRANSFORMER_RULES`, the first match winning) for a tree whose MoE
leaves sit under a "moe" key, or pass them to `parallel.shard_tree` alone
for a tree {"moe": params}.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..parallel.collectives import (_all_gather, _all_reduce, all_gather, axis_index, axis_size,
                                    grad_sum, group_of, psum, reduce_scatter, tp_copy, tp_reduce)
from ..parallel.mesh import PartitionSpec, mesh_shape
from ..parallel.sharding import dim_axes, grad_group, local_shard, spec_of

Params = Dict[str, Any]

# Sharding rules for MoE params (compose with TRANSFORMER_RULES).
EXPERT_RULES = (
    (r".*moe\.router$", PartitionSpec()),
    (r".*moe\.w_up$", PartitionSpec("expert", None, "tensor")),
    (r".*moe\.w_down$", PartitionSpec("expert", "tensor", None)),
)

# The mesh dims that split the tokens: rank g of their row-major order
# holds global tokens [g * N_local, (g + 1) * N_local). Ranks along the
# other dims hold the same tokens.
TOKEN_AXES = ("data", "fsdp", "expert")


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    d_ff: int
    n_experts: int
    capacity_factor: float = 1.25
    dtype: torch.dtype = torch.float32


def init_moe_params(cfg: MoEConfig, generator: torch.Generator, device=None) -> Params:
    """router [d, E], w_up [E, d, d_ff], w_down [E, d_ff, d]: normal draws
    scaled by d_model^-1/2 (router, w_up) and d_ff^-1/2 (w_down), in
    cfg.dtype. The generator lives on `device` (cuda unless the caller
    passes "cpu")."""
    from .._device import resolve_device

    dev = resolve_device(device)
    E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff

    def normal(shape, scale):
        w = torch.randn(shape, generator=generator, dtype=torch.float32, device=dev)
        return (w * scale).to(cfg.dtype)

    return {"router": normal((d, E), d ** -0.5), "w_up": normal((E, d, f), d ** -0.5),
            "w_down": normal((E, f, d), f ** -0.5)}


def _split(leaf, dim: int, axis: str) -> bool:
    return axis in dim_axes(spec_of(leaf), leaf.dim())[dim]


def moe_apply(params: Params, x: torch.Tensor, cfg: MoEConfig, *,
              capacity: Optional[int] = None, mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-1 (Switch) MoE over tokens.

    x: [..., T, d_model], leading dims flattened as the token batch.
    Returns (y, aux_loss): y has x's shape; aux_loss is the Switch
    load-balancing loss (scale by ~1e-2 and add to the task loss). Tokens
    past their expert's capacity pass through unchanged.

    With a DeviceMesh each rank passes ITS tokens: the global tokens are
    split over TOKEN_AXES ("data", "fsdp", "expert"; other dims hold the
    same), rank g of them holding the g-th block, so N and the capacity are
    global. Params are plain tensors or DTensors from shard_tree with
    EXPERT_RULES: each rank holds its experts' w_up / w_down (E / n_expert
    of them) and their d_ff slice under "tensor". A token's position in its
    expert's capacity counts every token before it on the lower token
    ranks first (an exclusive prefix of their per-expert counts), so the
    same tokens are dropped as in JAX. aux_loss is global, the same value on
    every rank; each rank's backward carries its own tokens' part of it (as
    next_token_loss does), and each param shard's gradient is summed over
    the token ranks that hold the same shard.

    Transfers: every rank scatters its tokens into a dense [E, C, d] buffer
    at their global (expert, slot); the buffers are reduce-scattered over
    "expert" (each rank gets its experts' slots) and summed over the other
    token dims, the experts run, and their outputs are all-gathered over
    "expert" for each rank to pick its tokens' rows. Dense buffers rather
    than an all-to-all of variable-length token lists: the shapes are
    static (C slots per expert, as JAX's), each collective's backward is
    its transpose (all-gather <-> reduce-scatter, psum -> psum), and no
    per-rank counts must cross before the tokens can; the cost is E * C * d
    floats per rank each way, 31.5 MB at Switch-Base's 128 experts of 768
    with C = 80."""
    orig_shape = x.shape
    d = orig_shape[-1]
    tokens = x.reshape(-1, d)
    E = cfg.n_experts
    sizes = mesh_shape(mesh) if mesh is not None else {}
    token_axes = tuple(a for a in TOKEN_AXES if sizes.get(a, 1) > 1)
    g, n_groups = (axis_index(mesh, token_axes), axis_size(mesh, token_axes)) if token_axes \
        else (0, 1)
    N = tokens.shape[0] * n_groups
    C = capacity if capacity is not None else max(1, int(cfg.capacity_factor * N / E))

    names = ("router", "w_up", "w_down")
    leaves = [local_shard(params[k]) for k in names]
    if token_axes and torch.is_grad_enabled():
        leaves = grad_sum(leaves, [grad_group(mesh, spec_of(params[k]), token_axes)
                                   for k in names])
    router, w_up, w_down = leaves

    probs = torch.softmax(torch.matmul(tokens, router.to(tokens.dtype)).float(), dim=-1)
    expert_idx = torch.argmax(probs, dim=-1)  # the first max, as jnp.argmax
    gate = probs.gather(1, expert_idx[:, None])[:, 0]
    onehot = F.one_hot(expert_idx, E).float()  # [N_local, E]
    counts, before = onehot.sum(0), 0.0
    if token_axes:  # the tokens of the lower token ranks come first
        every = _all_gather(counts[None], group_of(mesh, token_axes), 0)
        counts, before = every.sum(0), every[:g].sum(0)
    position = (torch.cumsum(onehot, dim=0) - 1.0 + before) * onehot
    keep = (position < C) * onehot
    kept = keep.sum(-1)  # [N_local]: 1 routed, 0 dropped
    slot = expert_idx * C + (position * keep).sum(-1).long()  # its row of [E * C]

    rows = kept.bool()
    buf = torch.zeros((E * C, d), dtype=torch.float32, device=x.device)
    expert_in = buf.index_put((slot[rows],), tokens[rows].float()).view(E, C, d)
    expert_split = mesh is not None and _split(params["w_up"], 0, "expert")
    if expert_split:
        expert_in = reduce_scatter(expert_in, mesh, "expert", scatter_dim=0)
    rest = tuple(a for a in token_axes if not (expert_split and a == "expert"))
    if rest:
        expert_in = psum(expert_in, mesh, rest)
    ff_split = mesh is not None and _split(params["w_up"], 2, "tensor")
    if ff_split:
        expert_in = tp_copy(expert_in, mesh)
    h = F.gelu(torch.bmm(expert_in, w_up.float()), approximate="tanh")
    expert_out = torch.bmm(h, w_down.float())
    if ff_split:
        expert_out = tp_reduce(expert_out, mesh)
    if expert_split:
        expert_out = all_gather(expert_out, mesh, "expert", gather_dim=0)
    combined = expert_out.reshape(E * C, d)[slot] * kept[:, None]
    y = combined * gate[:, None] + tokens.float() * (1.0 - kept)[:, None]

    importance = probs.sum(0)
    if token_axes:  # the global sum's value with this rank's part's gradient
        total = _all_reduce(importance.detach(), group_of(mesh, token_axes))
        importance = importance + (total - importance.detach())
    aux_loss = E * torch.sum((counts / N) * (importance / N))
    return y.to(x.dtype).reshape(orig_shape), aux_loss


__all__ = ["EXPERT_RULES", "MoEConfig", "TOKEN_AXES", "init_moe_params", "moe_apply"]
