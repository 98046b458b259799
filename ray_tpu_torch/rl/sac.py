"""SAC: soft actor-critic for continuous control (the counterpart of
ray_tpu/rl/sac.py).

Re-design of the reference's SAC (reference: rllib/algorithms/sac/sac.py;
loss rllib/algorithms/sac/torch/sac_torch_learner.py — squashed-Gaussian
policy, twin Q networks, polyak target smoothing, learned entropy
temperature). One update function (`SACLearner.update`) keeps the JAX
package's order of steps: the critics against the target networks, then the
actor against the NEW critics, then the temperature from the actor step's
(old-policy) logp, then the polyak targets. Three Adams (actor, critics,
alpha) on the learner's device: CUDA unless device="cpu". The update's
gaussian noise comes from a generator on that device, or is passed in.
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .env_runner import EnvRunnerGroup
from .learner import batch_to_device
from .module import MLP, RLModule, RLParams
from .replay import TransitionReplayBuffer

PyTree = Any
_LOG_STD_MIN, _LOG_STD_MAX = -20.0, 2.0


class SquashedGaussianModule(RLModule):
    """tanh-squashed Gaussian policy with state-dependent std plus twin Q
    critics (reference: sac_catalog building pi/q networks)."""

    action_kind = "continuous"

    def __init__(self, obs_dim: int, act_dim: int, hidden=(256, 256), low=-1.0, high=1.0):
        self.obs_dim, self.act_dim, self.hidden = obs_dim, act_dim, tuple(hidden)
        low = np.broadcast_to(np.asarray(low, np.float32), (act_dim,))
        high = np.broadcast_to(np.asarray(high, np.float32), (act_dim,))
        self.scale = (high - low) / 2.0
        self.center = (high + low) / 2.0
        self.action_shape = (act_dim,)
        # sum(log scale): the affine rescale's log-det, a float32 sum as JAX's.
        self._log_scale_sum = float(np.sum(np.log(self.scale)))
        self._affine_on = {}  # device -> (scale, center) tensors

    def __getstate__(self):
        return {**self.__dict__, "_affine_on": {}}

    # ---- params ----
    def init_params(self, generator, device=None) -> RLParams:
        qdims = (self.obs_dim + self.act_dim,) + self.hidden + (1,)
        return RLParams(
            nets={"pi": MLP((self.obs_dim,) + self.hidden + (2 * self.act_dim,), generator,
                            device=device),
                  "q1": MLP(qdims, generator, device=device),
                  "q2": MLP(qdims, generator, device=device)},
            tensors={"log_alpha": torch.tensor(0.0, dtype=torch.float32, device=device)})

    def _affine(self, like: torch.Tensor):
        """(scale, center) as tensors on like's device."""
        if like.device not in self._affine_on:
            with torch.inference_mode(False):  # usable by autograd wherever made
                self._affine_on[like.device] = (
                    torch.as_tensor(self.scale, device=like.device),
                    torch.as_tensor(self.center, device=like.device))
        return self._affine_on[like.device]

    # ---- policy ----
    def _pi(self, pi: MLP, obs):
        mean, log_std = torch.chunk(pi(obs), 2, dim=-1)
        return mean, torch.clamp(log_std, _LOG_STD_MIN, _LOG_STD_MAX)

    def pi_sample(self, params, generator, obs, noise: Optional[torch.Tensor] = None):
        """Reparameterized squashed sample + logp (tanh correction); `noise`,
        when given, replaces the standard normal draw from `generator`."""
        mean, log_std = self._pi(params.pi, obs)
        if noise is None:
            noise = torch.randn(mean.shape, generator=generator, dtype=mean.dtype,
                                device=mean.device)
        pre = mean + torch.exp(log_std) * noise
        logp = torch.sum(-0.5 * noise**2 - log_std - 0.5 * math.log(2 * math.pi), dim=-1)
        # tanh change of variables (the stable softplus form), plus the affine
        # rescale term: act = tanh(pre) * scale + center.
        logp = logp - torch.sum(2.0 * (math.log(2.0) - pre - F.softplus(-2.0 * pre)), dim=-1)
        logp = logp - self._log_scale_sum
        scale, center = self._affine(pre)
        return torch.tanh(pre) * scale + center, logp

    def q_value(self, q: MLP, obs, act):
        return q(torch.cat([obs, act], dim=-1))[..., 0]

    # ---- RLModule surface (env runner integration) ----
    def forward_inference(self, params, obs):
        mean, log_std = self._pi(params.pi, obs)
        return {"mean": mean, "log_std": log_std}

    def sample_with_params(self, params, generator, fwd_out):
        mean, log_std = fwd_out["mean"], fwd_out["log_std"]
        noise = torch.randn(mean.shape, generator=generator, dtype=mean.dtype,
                            device=mean.device)
        scale, center = self._affine(mean)
        act = torch.tanh(mean + torch.exp(log_std) * noise) * scale + center
        return act, torch.zeros_like(act[..., 0])  # logp unused off-policy


def _grads_to(params, loss) -> None:
    """loss's gradients as the .grad of `params` (a list of tensors)."""
    for p, g in zip(params, torch.autograd.grad(loss, params)):
        p.grad = g


class SACLearner:
    """SAC's params, target critics, three Adams and the update, on one
    device. CQL's learner subclasses it and adds its conservative term to
    the critic loss."""

    def __init__(self, module: SquashedGaussianModule, *, gamma: float, tau: float,
                 actor_lr: float, critic_lr: float, alpha_lr: float, target_entropy: float,
                 seed: int, device=None):
        from .._device import resolve_device

        self.module = module
        self.gamma, self.tau, self.target_entropy = gamma, tau, target_entropy
        self.device = resolve_device(device)
        self.params = module.init_params(torch.Generator().manual_seed(seed), device=self.device)
        self.target_q = RLParams(nets={"q1": copy.deepcopy(self.params.q1),
                                       "q2": copy.deepcopy(self.params.q2)})
        self.target_q.requires_grad_(False)
        p = self.params
        self.opt = {
            "pi": torch.optim.Adam(p.pi.parameters(), lr=actor_lr, eps=1e-8),
            "q": torch.optim.Adam([*p.q1.parameters(), *p.q2.parameters()], lr=critic_lr,
                                  eps=1e-8),
            "alpha": torch.optim.Adam([p.log_alpha], lr=alpha_lr, eps=1e-8),
        }
        self.generator = torch.Generator(device=self.device).manual_seed(seed + 1)

    def opt_params(self) -> Dict[str, Any]:
        """What each optimizer steps, keyed as the JAX package's `_opt`."""
        p = self.params
        return {"pi": p.pi, "q": {"q1": p.q1, "q2": p.q2}, "alpha": p.log_alpha}

    def draw_noise(self, batch_size: int) -> Dict[str, torch.Tensor]:
        """The update's gaussian draws: the next-obs sample and the actor's."""
        shape = (batch_size, self.module.act_dim)
        return {k: torch.randn(shape, generator=self.generator, device=self.device)
                for k in ("next", "pi")}

    def critic_loss(self, params, obs, act, target, noise):
        """(loss, metrics) of the twin critics against `target`."""
        m = self.module
        l1 = torch.mean((m.q_value(params.q1, obs, act) - target) ** 2)
        l2 = torch.mean((m.q_value(params.q2, obs, act) - target) ** 2)
        return l1 + l2, {}

    def update(self, batch, noise: Optional[Dict[str, torch.Tensor]] = None):
        """One SAC step on a replay batch (numpy or tensors); returns its
        metrics as 0-d tensors on the device."""
        m, p = self.module, self.params
        batch = batch_to_device(batch, self.device)
        obs, act = batch["obs"], batch["actions"]
        if noise is None:
            noise = self.draw_noise(obs.shape[0])
        noise = {k: torch.as_tensor(v, device=self.device) for k, v in noise.items()}

        # ---- critics
        with torch.no_grad():
            alpha = torch.exp(p.log_alpha)
            next_a, next_logp = m.pi_sample(p, None, batch["next_obs"], noise=noise["next"])
            q_next = torch.minimum(m.q_value(self.target_q.q1, batch["next_obs"], next_a),
                                   m.q_value(self.target_q.q2, batch["next_obs"], next_a))
            target = batch["rewards"] + self.gamma * (1.0 - batch["terminateds"]) * (
                q_next - alpha * next_logp)
        q_loss, extra = self.critic_loss(p, obs, act, target, noise)
        _grads_to([*p.q1.parameters(), *p.q2.parameters()], q_loss)
        self.opt["q"].step()

        # ---- actor, against the new critics
        a, logp = m.pi_sample(p, None, obs, noise=noise["pi"])
        q = torch.minimum(m.q_value(p.q1, obs, a), m.q_value(p.q2, obs, a))
        pi_loss = torch.mean(alpha * logp - q)
        _grads_to(list(p.pi.parameters()), pi_loss)
        self.opt["pi"].step()

        # ---- temperature, from the actor step's (old-policy) logp
        logp = logp.detach()
        a_loss = -torch.mean(torch.exp(p.log_alpha) * (logp + self.target_entropy))
        _grads_to([p.log_alpha], a_loss)
        self.opt["alpha"].step()

        # ---- polyak targets
        with torch.no_grad():
            for t, o in zip(self.target_q.parameters(),
                            [*p.q1.parameters(), *p.q2.parameters()]):
                t.copy_((1 - self.tau) * t + self.tau * o)
        for opt in self.opt.values():
            opt.zero_grad(set_to_none=True)
        return {"q_loss": q_loss.detach(), **extra, "pi_loss": pi_loss.detach(),
                "alpha_loss": a_loss.detach(), "alpha": torch.exp(p.log_alpha.detach()),
                "entropy": -torch.mean(logp)}

    # ---- checkpoint state (the JAX package's layout)
    def state(self) -> Dict[str, Any]:
        from ..models.convert import rl_opt_state_to_numpy, rl_params_to_numpy

        return {"params": rl_params_to_numpy(self.params),
                "target_q": rl_params_to_numpy(self.target_q),
                "opt": {k: rl_opt_state_to_numpy(self.opt[k], v)
                        for k, v in self.opt_params().items()},
                "generator": self.generator.get_state()}

    def load(self, params, target_q, opt=None, generator=None) -> None:
        from ..models.convert import rl_opt_state_from_numpy, rl_params_from_numpy

        self.params.load_state_dict(rl_params_from_numpy(params, device="cpu").state_dict())
        self.target_q.load_state_dict(rl_params_from_numpy(target_q, device="cpu").state_dict())
        for k, v in self.opt_params().items():
            self.opt[k].state.clear()  # no saved state: fresh moments
            if opt is not None:
                rl_opt_state_from_numpy(opt[k], self.opt[k], v)
        if generator is not None:
            self.generator.set_state(generator)


@dataclasses.dataclass
class SACConfig:
    """(reference: sac.py SACConfig)"""

    env: str = "Pendulum-v1"
    num_env_runners: int = 1
    num_envs_per_runner: int = 8
    rollout_length: int = 16
    buffer_capacity: int = 100_000
    learning_starts: int = 1_000
    train_batch_size: int = 256
    updates_per_iteration: int = 32
    gamma: float = 0.99
    tau: float = 0.005                 # polyak target smoothing
    actor_lr: float = 3e-4
    critic_lr: float = 3e-4
    alpha_lr: float = 3e-4
    target_entropy: Optional[float] = None  # default: -act_dim
    hidden: Tuple[int, ...] = (256, 256)
    seed: int = 0
    device: Any = None  # the update's: CUDA unless "cpu"

    def environment(self, env: str) -> "SACConfig":
        self.env = env
        return self

    def training(self, **kw) -> "SACConfig":
        for k, v in kw.items():
            if not hasattr(self, k):
                raise AttributeError(k)
            setattr(self, k, v)
        return self

    def build(self) -> "SAC":
        return SAC(self)


class SAC:
    """(reference: Algorithm + SAC.training_step)"""

    def __init__(self, config: SACConfig):
        from .envs import spaces

        self.config = config
        obs_space, act_space = spaces(config.env)
        act_dim = int(math.prod(act_space.shape))
        self.module = SquashedGaussianModule(
            int(math.prod(obs_space.shape)), act_dim, hidden=config.hidden,
            low=act_space.low, high=act_space.high)
        self.target_entropy = (
            config.target_entropy if config.target_entropy is not None else -float(act_dim))
        self.learner = SACLearner(
            self.module, gamma=config.gamma, tau=config.tau, actor_lr=config.actor_lr,
            critic_lr=config.critic_lr, alpha_lr=config.alpha_lr,
            target_entropy=self.target_entropy, seed=config.seed, device=config.device)
        self.env_runner_group = EnvRunnerGroup(
            config.env, self.module,
            num_runners=config.num_env_runners,
            num_envs_per_runner=config.num_envs_per_runner,
            seed=config.seed,
        )
        self.buffer = TransitionReplayBuffer(config.buffer_capacity, seed=config.seed)
        self.num_env_steps = 0
        self.num_updates = 0
        self.iteration = 0
        self.env_runner_group.sync_weights(self.get_weights())

    @property
    def params(self) -> RLParams:
        return self.learner.params

    @property
    def target_q(self) -> RLParams:
        return self.learner.target_q

    def get_weights(self) -> PyTree:
        from ..models.convert import rl_params_to_numpy

        return rl_params_to_numpy(self.learner.params)

    # -------------------------------------------------------------- train
    def train(self) -> Dict[str, Any]:
        cfg = self.config
        for ro in self.env_runner_group.sample(cfg.rollout_length):
            self.num_env_steps += self.buffer.add_rollout(ro)

        metrics: Dict[str, float] = {}
        if len(self.buffer) >= cfg.learning_starts:
            last = None
            for _ in range(cfg.updates_per_iteration):
                last = self.learner.update(self.buffer.sample(cfg.train_batch_size))
                self.num_updates += 1
            if last is not None:
                metrics = dict(zip(last, torch.stack(list(last.values())).tolist()))
                self.env_runner_group.sync_weights(self.get_weights())

        self.iteration += 1
        returns = self.env_runner_group.episode_returns()
        return {
            "iteration": self.iteration,
            "num_env_steps_sampled": self.num_env_steps,
            "num_updates": self.num_updates,
            "buffer_size": len(self.buffer),
            "episode_return_mean": float(np.mean(returns)) if returns else float("nan"),
            "num_episodes": len(returns),
            **metrics,
        }

    # --------------------------------------------------------- checkpoint
    def save(self, directory: str) -> None:
        from ..train.checkpoint import save_aux_state, save_pytree

        state = self.learner.state()
        save_pytree(
            {
                "params": state["params"],
                "target_q": state["target_q"],
                "counters": {
                    "num_env_steps": self.num_env_steps,
                    "num_updates": self.num_updates,
                    "iteration": self.iteration,
                },
            },
            directory,
        )
        save_aux_state(directory, {"opt": state["opt"], "generator": state["generator"]})

    def restore(self, directory: str) -> None:
        from ..train.checkpoint import load_aux_state, load_pytree

        data = load_pytree(directory)
        counters = data.get("counters", {})
        self.num_env_steps = int(counters.get("num_env_steps", 0))
        self.num_updates = int(counters.get("num_updates", 0))
        self.iteration = int(counters.get("iteration", 0))
        aux = load_aux_state(directory) or {}
        self.learner.load(data["params"], data["target_q"], aux.get("opt"), aux.get("generator"))
        self.env_runner_group.sync_weights(self.get_weights())
