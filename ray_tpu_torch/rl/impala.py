"""IMPALA: async sampling + V-trace off-policy correction (the counterpart
of ray_tpu/rl/impala.py).

Re-design of the reference's IMPALA (reference:
rllib/algorithms/impala/impala.py:607 training_step — async
foreach_actor_async sampling through FaultTolerantActorManager
(utils/actor_manager.py:464) and vtrace (impala/vtrace_torch.py,
originally DeepMind's vtrace paper). Sampling overlaps learning: the
algorithm keeps a sample request in flight per env runner and consumes
whichever lands first; vtrace corrects for the policy lag.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from .. import api
from .env_runner import EnvRunnerGroup
from .learner import LearnerGroup
from .module import RLModule, build_discrete_module, logp_entropy, masked_mean


def vtrace(
    behavior_logp,
    target_logp,
    rewards,
    values,
    dones,
    last_values,
    *,
    gamma: float,
    clip_rho: float = 1.0,
    clip_c: float = 1.0,
    terminateds=None,
    mask=None,
):
    """V-trace targets over [T, N] tensors (Espeholt et al. 2018 eq. 1; a
    reverse loop where the JAX package scans).

    Truncated episodes bootstrap through the time limit ((1-terminated) on
    the delta) while the correction chain cuts at any boundary ((1-done)).
    Returns (vs, pg_advantages), both detached."""
    if terminateds is None:
        terminateds = dones
    with torch.no_grad():
        ratio = torch.exp(target_logp - behavior_logp)
        rho = torch.clamp(ratio, max=clip_rho)
        c = torch.clamp(ratio, max=clip_c)
        bootstrap = gamma * (1.0 - terminateds)
        chain = gamma * (1.0 - dones)
        values_tp1 = torch.cat([values[1:], last_values[None]], dim=0)
        deltas = rho * (rewards + bootstrap * values_tp1 - values)
        if mask is not None:
            # Autoreset padding rows (mask=0) hold V(final_obs) of the episode
            # that just truncated, and their done flag is 0: zero the delta
            # AND cut the chain there, so vs[padding] is exactly that value.
            deltas = deltas * mask
            chain = chain * mask
        acc = torch.zeros_like(values[0])
        vs_minus_v = torch.empty_like(values)
        for t in range(values.shape[0] - 1, -1, -1):
            acc = deltas[t] + chain[t] * c[t] * acc
            vs_minus_v[t] = acc
        vs = vs_minus_v + values
        vs_tp1 = torch.cat([vs[1:], last_values[None]], dim=0)
        pg_adv = rho * (rewards + bootstrap * vs_tp1 - values)
    return vs, pg_adv


def impala_loss(
    module: RLModule,
    params,
    batch,
    *,
    gamma: float,
    vf_coeff: float,
    ent_coeff: float,
):
    """V-trace policy gradient + value + entropy (reference:
    impala_torch_learner.py). The bootstrap value is recomputed from
    last_obs under CURRENT params — mixing the actor's stale tail value
    into vs would bias every target. Autoreset padding steps (mask=0)
    contribute nothing."""
    T, N = batch["rewards"].shape
    obs = batch["obs"]  # [T, N, D]
    out = module.forward_train(params, obs.reshape(T * N, -1))
    logits = out["logits"].reshape(T, N, -1)
    values = out["vf"].reshape(T, N)
    last_values = module.forward_train(params, batch["last_obs"])["vf"]
    logp, entropy = logp_entropy(logits, batch["actions"])
    vs, pg_adv = vtrace(
        batch["logp"], logp, batch["rewards"], values, batch["dones"],
        last_values, gamma=gamma, terminateds=batch.get("terminateds"),
        mask=batch.get("mask"),
    )
    mask = batch.get("mask")
    policy_loss = -masked_mean(logp * pg_adv, mask)
    vf_loss = 0.5 * masked_mean((values - vs) ** 2, mask)
    ent = masked_mean(entropy, mask)
    total = policy_loss + vf_coeff * vf_loss - ent_coeff * ent
    return total, {"policy_loss": policy_loss, "vf_loss": vf_loss, "entropy": ent}


@dataclasses.dataclass
class IMPALAConfig:
    env: str = "CartPole-v1"
    num_env_runners: int = 2
    num_envs_per_runner: int = 4
    rollout_length: int = 32
    gamma: float = 0.99
    vf_coeff: float = 0.5
    entropy_coeff: float = 0.01
    lr: float = 5e-4
    grad_clip: Optional[float] = 1.0
    hidden: Tuple[int, ...] = (64, 64)
    seed: int = 0
    device: Any = None  # the learner's: CUDA unless "cpu"
    broadcast_interval: int = 1  # learner->runner weight pushes per N updates

    def build(self) -> "IMPALA":
        return IMPALA(self)


class IMPALA:
    """(reference: impala.py:607 training_step; async sample pipeline)"""

    def __init__(self, config: IMPALAConfig):
        self.config = config
        self.module = build_discrete_module(config.env, config.hidden)
        loss = self._make_loss(config)
        self.learner_group = LearnerGroup(
            self.module, loss, lr=config.lr, grad_clip=config.grad_clip, seed=config.seed,
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
        self._updates_since_broadcast = 0
        from collections import deque

        self._recent_returns: "deque" = deque(maxlen=100)
        # Async pipeline: one in-flight sample request per runner.
        self._inflight: Dict[Any, Any] = {
            r.sample.remote(config.rollout_length): r
            for r in self.env_runner_group.runners
        }

    def _make_loss(self, config):
        """Loss factory — APPO overrides with the clipped surrogate."""
        import functools

        return functools.partial(
            impala_loss,
            gamma=config.gamma,
            vf_coeff=config.vf_coeff,
            ent_coeff=config.entropy_coeff,
        )

    def train(self) -> Dict[str, Any]:
        """Consume the first finished rollout, update, re-issue the request
        (async pipeline; vtrace absorbs the policy lag)."""
        cfg = self.config
        refs = list(self._inflight.keys())
        ready, _ = api.wait(refs, num_returns=1, timeout=None)
        ref = ready[0]
        runner = self._inflight.pop(ref)
        try:
            rollout = api.get(ref)
        except Exception:
            # Dead runner: replace it (with current weights) and re-issue on
            # the REPLACEMENT — re-sampling a dead actor would starve the
            # pipeline (reference: FaultTolerantActorManager restart).
            fresh = self.env_runner_group.replace_runner(runner)
            self._inflight[fresh.sample.remote(cfg.rollout_length)] = fresh
            return {"iteration": self.iteration, "dropped_rollout": True}

        batch = {
            "obs": rollout["obs"],
            "actions": rollout["actions"],
            "logp": rollout["logp"],
            "rewards": rollout["rewards"],
            "dones": rollout["dones"],
            "terminateds": rollout["terminateds"],
            "mask": rollout["mask"],
            "last_obs": rollout["last_obs"],
        }
        metrics = self.learner_group.update(batch)
        self.iteration += 1
        self._updates_since_broadcast += 1

        if self._updates_since_broadcast >= cfg.broadcast_interval:
            # Push to the idle (just-consumed) runner only, and refresh the
            # group's weight cache so replacement runners start current.
            ref = api.put(self.learner_group.get_weights())
            self.env_runner_group.cache_weights(ref)
            api.get(runner.set_weights.remote(ref))
            self._updates_since_broadcast = 0
        # Re-issue sampling on the consumed runner.
        self._inflight[runner.sample.remote(cfg.rollout_length)] = runner

        # Episode returns ride the rollout payload — probing the runner
        # actors here would queue behind their in-flight sample() calls and
        # serialize the async pipeline.
        self._recent_returns.extend(rollout.get("episode_returns", []))
        returns = list(self._recent_returns)
        return {
            "iteration": self.iteration,
            "episode_return_mean": float(np.mean(returns)) if returns else float("nan"),
            "num_env_steps_sampled": int(np.prod(rollout["rewards"].shape)),
            **metrics,
        }
