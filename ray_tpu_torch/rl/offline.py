"""Offline RL: datasets of recorded experience + behavior cloning (the
counterpart of ray_tpu/rl/offline.py, over the port's data, whose blocks
are dicts of numpy columns).

Re-design of the reference's offline stack (reference:
rllib/offline/offline_data.py — ray.data-backed experience reading;
rllib/algorithms/bc/bc.py BehaviorCloning over the new API stack). Rollout
capture flows through ray_tpu_torch.data Datasets, so offline training reuses
the same block/streaming machinery as supervised pipelines.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, List

import numpy as np
import torch

from ..data import dataset as ds
from .learner import TorchLearner
from .module import RLModule


def rollouts_to_dataset(rollouts: Iterable[Dict[str, np.ndarray]], gamma: float = 0.99):
    """Flattens env-runner rollouts ([T, N, ...] arrays) into a Dataset of
    per-transition columns (reference: offline_data writing SampleBatches).
    Vectorized: mask-filtered column arrays, no per-row Python objects.
    Also emits a discounted return-to-go column (reverse scan with done
    resets) — the regression target MARWIL's value baseline needs."""
    cols: Dict[str, List[np.ndarray]] = {
        "obs": [], "action": [], "reward": [], "done": [], "return": []
    }
    for ro in rollouts:
        obs, act = np.asarray(ro["obs"]), np.asarray(ro["actions"])
        T, N = act.shape[:2]
        rewards = np.asarray(ro["rewards"], np.float32).reshape(T, N)
        dones = np.asarray(ro["dones"], np.float32).reshape(T, N)
        rtg = np.zeros((T, N), np.float32)
        acc = np.zeros(N, np.float32)
        for t in _reversed_range(T):
            acc = rewards[t] + gamma * acc * (1.0 - dones[t])
            rtg[t] = acc
        keep = np.ones(T * N, bool)
        mask = ro.get("mask")
        if mask is not None:
            keep = np.asarray(mask).reshape(-1) != 0.0
        cols["obs"].append(obs.reshape((T * N,) + obs.shape[2:])[keep])
        cols["action"].append(act.reshape((T * N,) + act.shape[2:])[keep])
        cols["reward"].append(rewards.reshape(-1)[keep])
        cols["done"].append(dones.reshape(-1)[keep])
        cols["return"].append(rtg.reshape(-1)[keep])
    merged = {k: np.concatenate(v) if v else np.zeros((0,)) for k, v in cols.items()}
    return ds.from_numpy(merged)


def _reversed_range(n: int):
    return range(n - 1, -1, -1)


def bc_loss(module: RLModule, params, batch):
    """Negative log-likelihood of the dataset actions (reference:
    bc_torch_learner.py compute_loss_for_module)."""
    out = module.forward_train(params, batch["obs"])
    logp, _ = module.logp_entropy(out, batch["actions"])
    loss = -torch.mean(logp)
    return loss, {"bc_nll": loss}


@dataclasses.dataclass
class BCConfig:
    """(reference: bc.py BCConfig)"""

    module: RLModule = None
    lr: float = 1e-3
    batch_size: int = 128
    seed: int = 0
    device: Any = None  # the learner's: CUDA unless "cpu"

    def build(self) -> "BC":
        return BC(self)


class BC:
    """Behavior cloning over an offline Dataset of transitions."""

    def __init__(self, config: BCConfig):
        self.config = config
        self.learner = TorchLearner(
            config.module, bc_loss, lr=config.lr, seed=config.seed, device=config.device
        )
        self.iteration = 0

    def _make_batch(self, batch) -> Dict[str, np.ndarray]:
        """Columns the loss consumes; subclasses extend (MARWIL adds the
        return-to-go regression target)."""
        return {
            "obs": np.asarray(batch["obs"], np.float32),
            "actions": np.asarray(batch["action"]),
        }

    def train_on_dataset(self, dataset, *, epochs: int = 1) -> Dict[str, float]:
        """One or more passes over the dataset in batch_size minibatches."""
        metrics: Dict[str, float] = {}
        for _ in range(epochs):
            for batch in dataset.iter_batches(
                batch_size=self.config.batch_size, batch_format="numpy"
            ):
                metrics = self.learner.update(self._make_batch(batch))
                self.iteration += 1
        if not metrics:
            raise ValueError("offline dataset produced no batches (empty after masking?)")
        return metrics

    def get_weights(self):
        return self.learner.get_weights()

    def action_accuracy(self, dataset) -> float:
        """Fraction of dataset transitions where the greedy policy matches
        the recorded action (a quick offline evaluation)."""
        params = self.learner.params
        total, correct = 0, 0
        for batch in dataset.iter_batches(
            batch_size=self.config.batch_size, batch_format="numpy"
        ):
            obs = torch.as_tensor(np.asarray(batch["obs"], np.float32), device=self.learner.device)
            with torch.no_grad():
                out = self.config.module.forward_inference(params, obs)
            pred = torch.argmax(out["logits"], dim=-1).cpu().numpy()
            actions = np.asarray(batch["action"])
            correct += int((pred == actions).sum())
            total += len(actions)
        return correct / max(1, total)


def marwil_loss(module: RLModule, params, batch, *, beta: float = 1.0, vf_coeff: float = 1.0):
    """Advantage-weighted behavior cloning + value regression (reference:
    rllib/algorithms/marwil/ — MARWIL's exponentially-weighted imitation
    loss; beta=0 degenerates to plain BC). Advantages come from the
    monte-carlo return-to-go minus the learned value baseline."""
    out = module.forward_train(params, batch["obs"])
    logp, _ = module.logp_entropy(out, batch["actions"])
    returns = batch["returns"]
    adv = returns - out["vf"]
    # Weights use a stopped-gradient advantage (the policy must not inflate
    # its own weights by wrecking the baseline), clipped for stability.
    w = torch.clamp(torch.exp(beta * adv.detach()), max=20.0)
    policy_loss = -torch.mean(w * logp)
    vf_loss = torch.mean(adv**2)
    loss = policy_loss + vf_coeff * vf_loss
    return loss, {
        "marwil_policy_loss": policy_loss,
        "marwil_vf_loss": vf_loss,
        "marwil_mean_weight": torch.mean(w),
    }


@dataclasses.dataclass
class MARWILConfig:
    """(reference: marwil.py MARWILConfig — beta, vf_coeff knobs)"""

    module: RLModule = None
    beta: float = 1.0
    vf_coeff: float = 1.0
    lr: float = 1e-3
    batch_size: int = 128
    seed: int = 0
    device: Any = None  # the learner's: CUDA unless "cpu"

    def build(self) -> "MARWIL":
        return MARWIL(self)


class MARWIL(BC):
    """Monotonic Advantage Re-Weighted Imitation Learning over an offline
    Dataset that carries return-to-go (rollouts_to_dataset provides it).
    Shares BC's epoch/minibatch loop; only the loss and the batch columns
    differ."""

    def __init__(self, config: MARWILConfig):
        import functools

        self.config = config
        loss = functools.partial(
            marwil_loss, beta=config.beta, vf_coeff=config.vf_coeff
        )
        self.learner = TorchLearner(config.module, loss, lr=config.lr, seed=config.seed,
                                    device=config.device)
        self.iteration = 0

    def _make_batch(self, batch) -> Dict[str, np.ndarray]:
        out = super()._make_batch(batch)
        out["returns"] = np.asarray(batch["return"], np.float32)
        return out


def rollouts_to_transitions(rollouts: Iterable[Dict[str, np.ndarray]]):
    """Transition-level dataset (obs, action, reward, next_obs, done) for
    off-policy offline algorithms (CQL). next_obs is the following step's
    observation. A rollout's final step is kept when `done` terminates it
    (the target needs no bootstrap, and terminal steps often carry the
    reward) with a zero next_obs placeholder; an unterminated final step
    is dropped (its bootstrap target is unknown). Honors the optional
    per-step `mask` like rollouts_to_dataset."""
    cols: Dict[str, List[np.ndarray]] = {
        "obs": [], "action": [], "reward": [], "next_obs": [], "done": []
    }
    for ro in rollouts:
        obs = np.asarray(ro["obs"], np.float32)
        act = np.asarray(ro["actions"], np.float32)
        T, N = act.shape[:2]
        rewards = np.asarray(ro["rewards"], np.float32).reshape(T, N)
        dones = np.asarray(ro["dones"], np.float32).reshape(T, N)
        mask = ro.get("mask")
        valid = (
            np.asarray(mask, np.float32).reshape(T, N) != 0.0
            if mask is not None
            else np.ones((T, N), bool)
        )
        # Steps 0..T-2 pair with the next step; step T-1 survives only
        # where done — its next_obs placeholder is never used (done=1
        # zeroes the bootstrap).
        next_obs = np.concatenate([obs[1:], np.zeros_like(obs[:1])], axis=0)
        keep = valid.copy()
        keep[T - 1] &= dones[T - 1] != 0.0
        flat_keep = keep.reshape(-1)

        def flat(x):
            return x.reshape((-1,) + x.shape[2:])[flat_keep]

        cols["obs"].append(flat(obs))
        cols["action"].append(flat(act))
        cols["reward"].append(rewards.reshape(-1)[flat_keep])
        cols["next_obs"].append(flat(next_obs))
        cols["done"].append(dones.reshape(-1)[flat_keep])
    merged = {k: np.concatenate(v) if v else np.zeros((0,)) for k, v in cols.items()}
    return ds.from_numpy(merged)
