"""RLModule: the network abstraction of the RL stack (the counterpart of
ray_tpu/rl/module.py).

A module describes an architecture and its forward functions; its params
are an `nn.Module` that `init_params(generator, device)` builds: `RLParams`,
whose children are the named MLPs ("pi", "vf", "mean", "q", ...) and whose
own parameters and buffers are the named tensors ("log_std", "log_alpha",
the buffer "epsilon"). The forward functions take (params, obs) as the JAX
package's take (params pytree, obs), so the losses keep their signatures.

The JAX package's param tree is {"pi": [{"w": [din, dout], "b": [dout]},
...], ...}; here layer i of an MLP is an `nn.Linear` whose weight is
(dout, din). models/convert.py `rl_params_to_numpy` / `rl_params_from_numpy`
move params between the two layouts; env runners receive that numpy tree.

Init is He-normal (`randn * sqrt(2 / din)`) with zero biases, drawn from a
CPU `torch.Generator` (so a seed gives the same weights on every device) and
then moved to `device`. Sampling takes an explicit generator on the device
of the logits, where the JAX package splits a key.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


class MLP(nn.ModuleList):
    """Linear layers with tanh between them (none after the last)."""

    def __init__(self, dims: Sequence[int], generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__(
            nn.utils.skip_init(nn.Linear, din, dout, device="cpu", dtype=dtype)
            for din, dout in zip(dims[:-1], dims[1:]))
        with torch.no_grad():
            for layer, din in zip(self, dims[:-1]):
                if generator is not None:
                    w = torch.randn(layer.weight.shape, generator=generator) * math.sqrt(2.0 / din)
                    layer.weight.copy_(w)
                else:
                    layer.weight.zero_()
                layer.bias.zero_()
        if device is not None:
            self.to(device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        *hidden, last = self  # (no slicing: a ModuleList slice rebuilds its class)
        for layer in hidden:
            x = torch.tanh(layer(x))
        return last(x)


class RLParams(nn.Module):
    """A module's params: named MLPs, named trainable tensors and named
    buffers (tensors the optimizer does not step, as DQN's epsilon)."""

    def __init__(self, nets: Optional[Dict[str, nn.Module]] = None,
                 tensors: Optional[Dict[str, torch.Tensor]] = None,
                 buffers: Optional[Dict[str, torch.Tensor]] = None):
        super().__init__()
        for name, net in (nets or {}).items():
            self.add_module(name, net)
        for name, t in (tensors or {}).items():
            self.register_parameter(name, nn.Parameter(t))
        for name, t in (buffers or {}).items():
            self.register_buffer(name, t)


class RLModule:
    """ABC. forward_* mirror the reference's inference/exploration/train
    forwards; the action distribution lives on the module (sample /
    logp_entropy), so env runners and losses are action-space agnostic."""

    action_kind: str = "discrete"
    action_shape: Tuple[int, ...] = ()

    def init_params(self, generator: torch.Generator, device=None) -> RLParams:
        raise NotImplementedError

    def forward_inference(self, params: RLParams, obs: torch.Tensor) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    def forward_exploration(self, params, obs):
        return self.forward_inference(params, obs)

    def forward_train(self, params, obs):
        return self.forward_inference(params, obs)

    # ---- action distribution ----
    def sample(self, generator: torch.Generator, fwd_out):
        """(action, logp) from the exploration forward output."""
        return sample_actions(generator, fwd_out["logits"])

    def logp_entropy(self, fwd_out, actions):
        return logp_entropy(fwd_out["logits"], actions)

    def sample_with_params(self, params, generator, fwd_out):
        """Sampling hook that can read exploration state carried in the
        params (DQN's synced epsilon); the default ignores them."""
        return self.sample(generator, fwd_out)

    def clip_action(self, action):
        """Maps a stored action to what the env receives (identity unless
        the module has bounds)."""
        return action


@dataclasses.dataclass(frozen=True)
class DiscretePolicyConfig:
    obs_dim: int
    n_actions: int
    hidden: Tuple[int, ...] = (64, 64)
    dtype: Any = torch.float32


class DiscretePolicyModule(RLModule):
    """Separate policy and value MLPs (the default PPO/IMPALA module for
    discrete action spaces)."""

    def __init__(self, config: DiscretePolicyConfig):
        self.config = config

    def _mlp(self, generator, dims, device=None) -> MLP:
        return MLP(dims, generator, dtype=self.config.dtype, device=device)

    def init_params(self, generator, device=None) -> RLParams:
        c = self.config
        return RLParams(nets={
            "pi": self._mlp(generator, (c.obs_dim,) + tuple(c.hidden) + (c.n_actions,), device),
            "vf": self._mlp(generator, (c.obs_dim,) + tuple(c.hidden) + (1,), device),
        })

    def forward_inference(self, params, obs):
        return {"logits": params.pi(obs), "vf": params.vf(obs)[..., 0]}


@dataclasses.dataclass(frozen=True)
class GaussianPolicyConfig:
    obs_dim: int
    act_dim: int
    hidden: Tuple[int, ...] = (64, 64)
    # Per-dimension bounds (scalars broadcast).
    low: Any = -1.0
    high: Any = 1.0
    init_log_std: float = 0.0
    dtype: Any = torch.float32


class GaussianPolicyModule(RLModule):
    """Diagonal Gaussian policy for Box action spaces with a free,
    state-independent log-std."""

    action_kind = "continuous"

    def __init__(self, config: GaussianPolicyConfig):
        self.config = config
        self.action_shape = (config.act_dim,)

    def init_params(self, generator, device=None) -> RLParams:
        c = self.config
        mlp = lambda dims: MLP(dims, generator, dtype=c.dtype, device=device)  # noqa: E731
        return RLParams(
            nets={"mean": mlp((c.obs_dim,) + tuple(c.hidden) + (c.act_dim,)),
                  "vf": mlp((c.obs_dim,) + tuple(c.hidden) + (1,))},
            tensors={"log_std": torch.full((c.act_dim,), c.init_log_std, dtype=c.dtype,
                                           device=device)})

    def forward_inference(self, params, obs):
        return {"mean": params.mean(obs), "log_std": params.log_std,
                "vf": params.vf(obs)[..., 0]}

    def sample(self, generator, fwd_out, noise: Optional[torch.Tensor] = None):
        mean, log_std = fwd_out["mean"], fwd_out["log_std"]
        if noise is None:
            noise = torch.randn(mean.shape, generator=generator, dtype=mean.dtype,
                                device=mean.device)
        action = mean + torch.exp(log_std) * noise
        # The UNCLIPPED action is returned and stored, so (action, logp) stay
        # consistent; the bounds apply only at the env (clip_action): the
        # reference's clip-not-squash rule.
        return action, self._normal_logp(action, mean, log_std)

    def clip_action(self, action):
        c = self.config
        if isinstance(action, torch.Tensor):
            return torch.clamp(action, torch.as_tensor(c.low, device=action.device),
                               torch.as_tensor(c.high, device=action.device))
        return np.clip(action, np.asarray(c.low, np.float32), np.asarray(c.high, np.float32))

    def logp_entropy(self, fwd_out, actions):
        mean, log_std = fwd_out["mean"], fwd_out["log_std"]
        logp = self._normal_logp(actions, mean, log_std)
        entropy = torch.sum(log_std + 0.5 * math.log(2 * math.pi * math.e), dim=-1)
        return logp, torch.broadcast_to(entropy, logp.shape)

    @staticmethod
    def _normal_logp(x, mean, log_std):
        var = torch.exp(2 * log_std)
        return torch.sum(-0.5 * ((x - mean) ** 2 / var) - log_std - 0.5 * math.log(2 * math.pi),
                         dim=-1)


def sample_actions(generator: torch.Generator, logits: torch.Tensor):
    """Categorical sample + its logp (exploration path)."""
    logp_all = F.log_softmax(logits, dim=-1)
    flat = torch.exp(logp_all).reshape(-1, logits.shape[-1])
    action = torch.multinomial(flat, 1, generator=generator).reshape(logits.shape[:-1])
    return action, torch.gather(logp_all, -1, action[..., None])[..., 0]


def logp_entropy(logits: torch.Tensor, actions: torch.Tensor):
    logp_all = F.log_softmax(logits, dim=-1)
    logp = torch.gather(logp_all, -1, actions.long()[..., None])[..., 0]
    entropy = -torch.sum(torch.exp(logp_all) * logp_all, dim=-1)
    return logp, entropy


def masked_mean(x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Mean over valid (mask=1) entries; mask=None means all valid."""
    if mask is None:
        return torch.mean(x)
    return torch.sum(x * mask) / torch.clamp(torch.sum(mask), min=1.0)


def build_discrete_module(env_name: str, hidden: Tuple[int, ...]) -> DiscretePolicyModule:
    """The default discrete module for an env's spaces (PPO/IMPALA)."""
    from .envs import spaces

    obs_space, act_space = spaces(env_name)
    return DiscretePolicyModule(DiscretePolicyConfig(
        obs_dim=int(math.prod(obs_space.shape)), n_actions=int(act_space.n),
        hidden=tuple(hidden)))


def build_module_for_env(env_name: str, hidden: Tuple[int, ...]) -> RLModule:
    """Categorical for Discrete action spaces, diagonal Gaussian for Box."""
    from .envs import spaces

    obs_space, space = spaces(env_name)
    obs_dim = int(math.prod(obs_space.shape))
    if hasattr(space, "n"):
        return DiscretePolicyModule(DiscretePolicyConfig(
            obs_dim=obs_dim, n_actions=int(space.n), hidden=tuple(hidden)))
    return GaussianPolicyModule(GaussianPolicyConfig(
        obs_dim=obs_dim, act_dim=int(math.prod(space.shape)), hidden=tuple(hidden),
        low=tuple(float(x) for x in space.low.ravel()),
        high=tuple(float(x) for x in space.high.ravel())))
