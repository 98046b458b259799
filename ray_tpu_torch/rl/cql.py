"""CQL: conservative Q-learning for offline continuous control (the
counterpart of ray_tpu/rl/cql.py).

Re-design of the reference's CQL (reference: rllib/algorithms/cql/cql.py —
SAC plus the CQL(H) conservative regularizer on the critics). Purely
offline: no env runners; the algorithm consumes a transition dataset (obs,
action, reward, next_obs, done). The step is SAC's (rl/sac.py SACLearner,
same order) with the critic loss regularized.

The conservative term lower-bounds the learned Q: for each state, logsumexp
over Q at sampled actions (uniform + current-policy, the CQL(H)
importance-sampling estimator) is pushed DOWN while Q at dataset actions is
pushed UP, so out-of-distribution actions cannot look spuriously good.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from .sac import SACLearner, SquashedGaussianModule


@dataclasses.dataclass
class CQLConfig:
    """(reference: cql.py CQLConfig — min_q_weight here is cql_alpha)"""

    obs_dim: int = None
    act_dim: int = None
    action_low: float = -1.0
    action_high: float = 1.0
    cql_alpha: float = 1.0          # weight of the conservative term
    n_action_samples: int = 8       # actions per state in the logsumexp
    gamma: float = 0.99
    tau: float = 0.005
    actor_lr: float = 3e-4
    critic_lr: float = 3e-4
    alpha_lr: float = 3e-4
    target_entropy: Optional[float] = None
    hidden: Tuple[int, ...] = (256, 256)
    batch_size: int = 256
    seed: int = 0
    device: Any = None  # the update's: CUDA unless "cpu"

    def build(self) -> "CQL":
        return CQL(self)


class CQLLearner(SACLearner):
    """SAC's learner whose critic loss adds cql_alpha x the conservative
    term. The update draws, besides SAC's two gaussian draws, the uniform
    actions "unif" [N, B, act] in the action box and the current-policy
    draws "cur" [N, B, act]; all may be passed in."""

    def __init__(self, module, *, cql_alpha: float, n_action_samples: int, **kw):
        super().__init__(module, **kw)
        self.cql_alpha = cql_alpha
        self.n_action_samples = n_action_samples

    def draw_noise(self, batch_size: int) -> Dict[str, torch.Tensor]:
        m, n = self.module, self.n_action_samples
        shape = (n, batch_size, m.act_dim)
        noise = super().draw_noise(batch_size)
        lo, hi = (torch.as_tensor(v, device=self.device) for v in (m.center - m.scale,
                                                                     m.center + m.scale))
        noise["unif"] = lo + (hi - lo) * torch.rand(shape, generator=self.generator,
                                                    device=self.device)
        noise["cur"] = torch.randn(shape, generator=self.generator, device=self.device)
        return noise

    def critic_loss(self, params, obs, act, target, noise):
        m, n = self.module, self.n_action_samples
        q1d, q2d = m.q_value(params.q1, obs, act), m.q_value(params.q2, obs, act)
        bellman = torch.mean((q1d - target) ** 2) + torch.mean((q2d - target) ** 2)
        lo, hi = m.center - m.scale, m.center + m.scale
        unif_logp = -float(np.sum(np.log(hi - lo)))  # the uniform box's log-density
        obs_n = obs.expand((n,) + tuple(obs.shape))
        with torch.no_grad():
            cur_a, cur_logp = m.pi_sample(params, None, obs_n, noise=noise["cur"])
        unif = noise["unif"].to(obs.dtype)
        # Importance-corrected logsumexp over the 2N samples.
        cat1 = torch.cat([m.q_value(params.q1, obs_n, unif) - unif_logp,
                          m.q_value(params.q1, obs_n, cur_a) - cur_logp], dim=0)
        cat2 = torch.cat([m.q_value(params.q2, obs_n, unif) - unif_logp,
                          m.q_value(params.q2, obs_n, cur_a) - cur_logp], dim=0)
        lse1 = torch.logsumexp(cat1, dim=0) - math.log(2 * n)
        lse2 = torch.logsumexp(cat2, dim=0) - math.log(2 * n)
        conservative = torch.mean(lse1 - q1d) + torch.mean(lse2 - q2d)
        return bellman + self.cql_alpha * conservative, {
            "bellman_loss": bellman.detach(), "cql_conservative": conservative.detach()}


class CQL:
    def __init__(self, config: CQLConfig):
        if config.obs_dim is None or config.act_dim is None:
            raise ValueError("CQLConfig needs obs_dim and act_dim")
        self.config = config
        self.module = SquashedGaussianModule(
            config.obs_dim, config.act_dim, hidden=config.hidden,
            low=config.action_low, high=config.action_high)
        self.target_entropy = (config.target_entropy if config.target_entropy is not None
                               else -float(config.act_dim))
        self.learner = CQLLearner(
            self.module, cql_alpha=config.cql_alpha, n_action_samples=config.n_action_samples,
            gamma=config.gamma, tau=config.tau, actor_lr=config.actor_lr,
            critic_lr=config.critic_lr, alpha_lr=config.alpha_lr,
            target_entropy=self.target_entropy, seed=config.seed, device=config.device)
        self.num_updates = 0

    @property
    def params(self):
        return self.learner.params

    @property
    def target_q(self):
        return self.learner.target_q

    # -------------------------------------------------------------- train
    def train_on_dataset(self, dataset, *, epochs: int = 1) -> Dict[str, float]:
        """Offline passes over a transition dataset with columns
        obs/action/reward/next_obs/done."""
        last = None
        for _ in range(epochs):
            for batch in dataset.iter_batches(batch_size=self.config.batch_size,
                                              batch_format="numpy"):
                last = self.learner.update({
                    "obs": np.asarray(batch["obs"], np.float32),
                    "actions": np.asarray(batch["action"], np.float32),
                    "rewards": np.asarray(batch["reward"], np.float32),
                    "next_obs": np.asarray(batch["next_obs"], np.float32),
                    "terminateds": np.asarray(batch["done"], np.float32),
                })
                self.num_updates += 1
        if last is None:
            raise ValueError("offline dataset produced no batches")
        keys = ("q_loss", "bellman_loss", "cql_conservative", "pi_loss", "alpha_loss")
        return dict(zip(keys, torch.stack([last[k] for k in keys]).tolist()))

    @torch.no_grad()
    def q_values(self, obs: np.ndarray, actions: np.ndarray) -> np.ndarray:
        """Min of the twin critics (for offline evaluation)."""
        dev = self.learner.device
        obs = torch.as_tensor(obs, device=dev)
        actions = torch.as_tensor(actions, device=dev)
        p, m = self.params, self.module
        return torch.minimum(m.q_value(p.q1, obs, actions),
                             m.q_value(p.q2, obs, actions)).cpu().numpy()

    @torch.no_grad()
    def compute_actions(self, obs: np.ndarray) -> np.ndarray:
        out = self.module.forward_inference(
            self.params, torch.as_tensor(obs, dtype=torch.float32, device=self.learner.device))
        scale, center = self.module._affine(out["mean"])
        return (torch.tanh(out["mean"]) * scale + center).cpu().numpy()
