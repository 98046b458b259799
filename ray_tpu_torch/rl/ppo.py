"""PPO (the counterpart of ray_tpu/rl/ppo.py).

Re-design of the reference's PPO (reference: rllib/algorithms/ppo/ppo.py,
training_step :400-466: synchronous_parallel_sample -> learner_group
update -> env_runner weight sync; losses rllib/algorithms/ppo/torch/
ppo_torch_learner.py). GAE is numpy (a copy of the JAX package's), the loss
torch on the learner's device; minibatches come from
`np.random.default_rng(seed)` as in the JAX package. `train()` also reports
its sample, learn and weight-sync seconds.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .env_runner import EnvRunnerGroup
from .learner import LearnerGroup
from .module import RLModule, build_module_for_env, masked_mean


@dataclasses.dataclass
class PPOConfig:
    """Builder-style config (reference: algorithm_config.py:106 +
    ppo.py PPOConfig)."""

    env: str = "CartPole-v1"
    num_env_runners: int = 2
    num_envs_per_runner: int = 4
    rollout_length: int = 64
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_param: float = 0.2
    vf_coeff: float = 0.5
    entropy_coeff: float = 0.01
    lr: float = 3e-4
    grad_clip: Optional[float] = 0.5
    num_epochs: int = 4
    minibatch_size: int = 128
    num_learners: int = 1
    hidden: Tuple[int, ...] = (64, 64)
    seed: int = 0
    device: Any = None  # the learner's: CUDA unless "cpu"

    # fluent-ish setters for call-site parity with the reference
    def environment(self, env: str) -> "PPOConfig":
        self.env = env
        return self

    def env_runners(self, num_env_runners: int, num_envs_per_runner: int = 4) -> "PPOConfig":
        self.num_env_runners = num_env_runners
        self.num_envs_per_runner = num_envs_per_runner
        return self

    def training(self, **kw) -> "PPOConfig":
        for k, v in kw.items():
            if not hasattr(self, k):
                raise AttributeError(k)
            setattr(self, k, v)
        return self

    def build(self) -> "PPO":
        return PPO(self)


def compute_gae(
    rewards, values, dones, last_values, gamma: float, lam: float, terminateds=None
):
    """Generalized advantage estimation over [T, N] arrays (reference:
    rllib/evaluation/postprocessing.py compute_gae_for_sample_batch).

    Truncation (time limit) bootstraps through the boundary: the delta uses
    (1 - terminated) so V(final_obs) still backs up the truncated step,
    while the recursion cuts at ANY episode end via (1 - done) — matching
    the reference's truncation handling."""
    if terminateds is None:
        terminateds = dones
    T = rewards.shape[0]
    adv = np.zeros_like(rewards)
    last_gae = np.zeros_like(rewards[0])
    next_values = last_values
    for t in reversed(range(T)):
        bootstrap = 1.0 - terminateds[t]
        boundary = 1.0 - dones[t]
        delta = rewards[t] + gamma * next_values * bootstrap - values[t]
        last_gae = delta + gamma * lam * boundary * last_gae
        adv[t] = last_gae
        next_values = values[t]
    returns = adv + values
    return adv, returns


def ppo_loss(module: RLModule, params, batch, *, clip: float, vf_coeff: float, ent_coeff: float):
    """Clipped surrogate + value loss + entropy bonus (reference:
    ppo_torch_learner.py compute_loss_for_module). Autoreset padding steps
    carry mask=0 and contribute nothing."""
    out = module.forward_train(params, batch["obs"])
    logp, entropy = module.logp_entropy(out, batch["actions"])
    mask = batch.get("mask")
    ratio = torch.exp(logp - batch["logp"])
    adv = batch["advantages"]
    surrogate = torch.minimum(ratio * adv, torch.clamp(ratio, 1 - clip, 1 + clip) * adv)
    policy_loss = -masked_mean(surrogate, mask)
    vf_loss = masked_mean((out["vf"] - batch["returns"]) ** 2, mask)
    ent = masked_mean(entropy, mask)
    total = policy_loss + vf_coeff * vf_loss - ent_coeff * ent
    return total, {
        "policy_loss": policy_loss,
        "vf_loss": vf_loss,
        "entropy": ent,
        "kl_approx": masked_mean(batch["logp"] - logp, mask),
    }


class PPO:
    """(reference: Algorithm + PPO.training_step, ppo.py:400)"""

    def __init__(self, config: PPOConfig):
        import functools

        self.config = config
        self.module = build_module_for_env(config.env, config.hidden)
        loss = functools.partial(
            ppo_loss,
            clip=config.clip_param,
            vf_coeff=config.vf_coeff,
            ent_coeff=config.entropy_coeff,
        )
        self.learner_group = LearnerGroup(
            self.module,
            loss,
            num_learners=config.num_learners,
            lr=config.lr,
            grad_clip=config.grad_clip,
            seed=config.seed,
            device=config.device,
        )
        self.env_runner_group = EnvRunnerGroup(
            config.env,
            self.module,
            num_runners=config.num_env_runners,
            num_envs_per_runner=config.num_envs_per_runner,
            seed=config.seed,
        )
        self.env_runner_group.sync_weights(self.learner_group.get_weights())
        self.iteration = 0
        self._rng = np.random.default_rng(config.seed)

    # -------------------------------------------------------------- train
    def train(self) -> Dict[str, Any]:
        """One training iteration (reference: ppo.py training_step :400)."""
        import time

        cfg = self.config
        t0 = time.perf_counter()
        rollouts = self.env_runner_group.sample(cfg.rollout_length)
        sample_s = time.perf_counter() - t0
        if not rollouts:
            return {"iteration": self.iteration, "no_samples": True}

        # Assemble [B, ...] train batch with GAE.
        parts = []
        for ro in rollouts:
            adv, ret = compute_gae(
                ro["rewards"], ro["values"], ro["dones"], ro["last_values"],
                cfg.gamma, cfg.gae_lambda, terminateds=ro["terminateds"],
            )
            # Actions keep their trailing action dims (continuous modules).
            act_shape = tuple(getattr(self.module, "action_shape", ()) or ())
            flat = {
                "obs": ro["obs"].reshape(-1, ro["obs"].shape[-1]),
                "actions": ro["actions"].reshape((-1,) + act_shape),
                "logp": ro["logp"].reshape(-1),
                "advantages": adv.reshape(-1),
                "returns": ret.reshape(-1),
                "mask": ro["mask"].reshape(-1),
            }
            parts.append(flat)
        batch = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
        # Advantage normalization over valid steps (standard PPO practice).
        adv, m = batch["advantages"], batch["mask"]
        mean = (adv * m).sum() / max(m.sum(), 1.0)
        std = np.sqrt(((adv - mean) ** 2 * m).sum() / max(m.sum(), 1.0))
        batch["advantages"] = (adv - mean) / (std + 1e-8)

        B = batch["obs"].shape[0]
        t0 = time.perf_counter()
        all_metrics: List[Dict[str, float]] = []
        for _ in range(cfg.num_epochs):
            perm = self._rng.permutation(B)
            for start in range(0, B, cfg.minibatch_size):
                idx = perm[start : start + cfg.minibatch_size]
                mb = {k: v[idx] for k, v in batch.items()}
                all_metrics.append(self.learner_group.update(mb))
        metrics = {
            k: float(np.mean([m[k] for m in all_metrics])) for k in all_metrics[0]
        } if all_metrics else {}
        learn_s = time.perf_counter() - t0

        t0 = time.perf_counter()
        self.env_runner_group.sync_weights(self.learner_group.get_weights())
        sync_s = time.perf_counter() - t0
        self.iteration += 1

        returns = self.env_runner_group.episode_returns()
        result = {
            "iteration": self.iteration,
            "num_env_steps_sampled": B,
            "episode_return_mean": float(np.mean(returns)) if returns else float("nan"),
            "num_episodes": len(returns),
            "sample_s": sample_s,
            "learn_s": learn_s,
            "sync_s": sync_s,
            **metrics,
        }
        return result

    # --------------------------------------------------------- checkpoint
    def save(self, directory: str) -> None:
        from ..train.checkpoint import save_pytree

        save_pytree({"params": self.learner_group.get_weights()}, directory)

    def restore(self, directory: str) -> None:
        from ..train.checkpoint import load_pytree

        params = load_pytree(directory)["params"]
        self.learner_group.set_weights(params)
        self.env_runner_group.sync_weights(params)
