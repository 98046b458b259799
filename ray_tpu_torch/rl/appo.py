"""APPO: asynchronous PPO — IMPALA's pipeline with PPO's clipped loss (the
counterpart of ray_tpu/rl/appo.py).

Re-design of the reference's APPO (reference:
rllib/algorithms/appo/appo.py:278 — "APPO is an asynchronous variant of
PPO based on the IMPALA architecture"; loss in
appo_torch_learner.py: clipped surrogate over V-trace-corrected
advantages). Sampling stays fully async (one rollout in flight per env
runner, consumed as they land); the importance ratio does double duty:
V-trace's rho/c corrections absorb the actor-learner policy lag, and the
PPO clip bounds the update size.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from .impala import IMPALA, IMPALAConfig, vtrace
from .module import RLModule, logp_entropy, masked_mean


def appo_loss(
    module: RLModule,
    params,
    batch,
    *,
    gamma: float,
    vf_coeff: float,
    ent_coeff: float,
    clip_param: float,
):
    """Clipped surrogate over V-trace advantages (reference:
    appo_torch_learner.py _compute_loss: surrogate with is_ratio clipped,
    targets from vtrace)."""
    T, N = batch["rewards"].shape
    out = module.forward_train(params, batch["obs"].reshape(T * N, -1))
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
    ratio = torch.exp(logp - batch["logp"])
    surr = torch.minimum(
        ratio * pg_adv,
        torch.clamp(ratio, 1.0 - clip_param, 1.0 + clip_param) * pg_adv,
    )
    policy_loss = -masked_mean(surr, mask)
    vf_loss = 0.5 * masked_mean((values - vs) ** 2, mask)
    ent = masked_mean(entropy, mask)
    total = policy_loss + vf_coeff * vf_loss - ent_coeff * ent
    return total, {"policy_loss": policy_loss, "vf_loss": vf_loss, "entropy": ent}


@dataclasses.dataclass
class APPOConfig(IMPALAConfig):
    clip_param: float = 0.3

    def build(self) -> "APPO":  # type: ignore[override]
        return APPO(self)


class APPO(IMPALA):
    """Async PPO on the IMPALA pipeline (reference: appo.py:278)."""

    def _make_loss(self, config):
        return functools.partial(
            appo_loss,
            gamma=config.gamma,
            vf_coeff=config.vf_coeff,
            ent_coeff=config.entropy_coeff,
            clip_param=config.clip_param,
        )
