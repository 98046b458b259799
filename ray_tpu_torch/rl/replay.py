"""Replay buffers for off-policy learning (a copy of ray_tpu/rl/replay.py,
which is numpy only: the same seed draws the same indices).

Re-design of the reference's replay stack (reference:
rllib/utils/replay_buffers/replay_buffer.py ReplayBuffer.sample /
episode_replay_buffer.py EpisodeReplayBuffer): a capacity-bounded ring of
transitions stored as preallocated numpy arrays (cheap uniform sampling,
no per-item Python objects), fed from env-runner rollouts.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


class TransitionReplayBuffer:
    """Uniform-sampling ring buffer of (obs, action, reward, next_obs,
    terminated) transitions."""

    def __init__(self, capacity: int, seed: int = 0):
        self.capacity = int(capacity)
        self._rng = np.random.default_rng(seed)
        self._storage: Optional[Dict[str, np.ndarray]] = None
        self._next = 0
        self._size = 0

    def __len__(self) -> int:
        return self._size

    def _alloc(self, sample: Dict[str, np.ndarray]) -> None:
        self._storage = {
            k: np.zeros((self.capacity,) + v.shape[1:], v.dtype)
            for k, v in sample.items()
        }

    def add(self, transitions: Dict[str, np.ndarray]) -> None:
        """Adds a batch of transitions ([B, ...] per key)."""
        if self._storage is None:
            self._alloc(transitions)
        n = len(next(iter(transitions.values())))
        idx = (self._next + np.arange(n)) % self.capacity
        for k, v in transitions.items():
            self._storage[k][idx] = v
        self._next = (self._next + n) % self.capacity
        self._size = min(self._size + n, self.capacity)

    def add_rollout(self, ro: Dict[str, np.ndarray]) -> int:
        """Flattens an env-runner rollout ([T, N, ...]) into transitions.

        next_obs for step t is obs[t+1] within the rollout; the final step
        of each env uses last_obs. Autoreset padding rows (mask=0) are
        dropped — their obs is the new episode's first observation.
        """
        obs, act = ro["obs"], ro["actions"]
        T, N = obs.shape[:2]
        next_obs = np.concatenate([obs[1:], ro["last_obs"][None]], axis=0)
        mask = ro.get("mask")
        keep = np.ones((T, N), bool) if mask is None else mask.astype(bool)
        # A done step's "next obs" is the reset obs — that's fine: the
        # (1 - terminated) factor removes it from the bootstrap.
        flat = {
            "obs": obs[keep],
            "actions": act[keep],
            "rewards": ro["rewards"][keep].astype(np.float32),
            "next_obs": next_obs[keep],
            "terminateds": ro["terminateds"][keep].astype(np.float32),
        }
        self.add(flat)
        return int(keep.sum())

    def sample(self, batch_size: int) -> Dict[str, np.ndarray]:
        assert self._size > 0, "buffer is empty"
        idx = self._rng.integers(0, self._size, size=batch_size)
        return {k: v[idx] for k, v in self._storage.items()}
