"""Connectors: observation pipelines between env and module (a copy of
ray_tpu/rl/connectors.py, which is numpy only).

Re-design of the reference's ConnectorV2 (reference:
rllib/connectors/connector_v2.py:31 — env-to-module pipelines composed of
small stateful pieces). A connector maps raw env observations to module
inputs; pipelines compose left to right. Stateful connectors (running
normalization) update during sampling; the transformed observations are
what the rollout buffer stores, so training sees exactly what the policy
saw.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np


class Connector:
    """One env-to-module transform (reference: connector_v2.py:31)."""

    def __call__(self, obs: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def get_state(self) -> Dict[str, Any]:
        return {}

    def set_state(self, state: Dict[str, Any]) -> None:
        pass


class FlattenObs(Connector):
    """[B, ...] -> [B, prod(...)] (the default MLP input adapter)."""

    def __call__(self, obs: np.ndarray) -> np.ndarray:
        obs = np.asarray(obs, np.float32)
        return obs.reshape(obs.shape[0], -1)


class ClipObs(Connector):
    def __init__(self, low: float = -10.0, high: float = 10.0):
        self.low, self.high = low, high

    def __call__(self, obs: np.ndarray) -> np.ndarray:
        return np.clip(obs, self.low, self.high)


class NormalizeObs(Connector):
    """Running mean/std normalization (reference: the MeanStdFilter
    connector). Stats update during sampling; freeze() for evaluation."""

    def __init__(self, eps: float = 1e-8):
        self.eps = eps
        self.count = 0.0
        self.mean: Optional[np.ndarray] = None
        self.m2: Optional[np.ndarray] = None
        self.frozen = False

    def __call__(self, obs: np.ndarray) -> np.ndarray:
        obs = np.asarray(obs, np.float32)
        if self.mean is None:
            self.mean = np.zeros(obs.shape[1:], np.float64)
            self.m2 = np.ones(obs.shape[1:], np.float64)
        if not self.frozen and len(obs):
            # Batched (Chan) Welford merge: O(1) vectorized ops per batch
            # instead of a per-row Python loop on the sampling hot path.
            b = float(len(obs))
            b_mean = obs.mean(axis=0, dtype=np.float64)
            b_m2 = ((obs - b_mean) ** 2).sum(axis=0, dtype=np.float64)
            delta = b_mean - self.mean
            total = self.count + b
            self.mean += delta * (b / total)
            self.m2 += b_m2 + delta**2 * (self.count * b / total)
            self.count = total
        var = self.m2 / max(1.0, self.count)
        return ((obs - self.mean) / np.sqrt(var + self.eps)).astype(np.float32)

    def freeze(self) -> None:
        self.frozen = True

    def get_state(self) -> Dict[str, Any]:
        return {"count": self.count, "mean": self.mean, "m2": self.m2}

    def set_state(self, state: Dict[str, Any]) -> None:
        self.count = state["count"]
        self.mean = state["mean"]
        self.m2 = state["m2"]


class ConnectorPipeline(Connector):
    """Left-to-right composition (reference: ConnectorPipelineV2)."""

    def __init__(self, connectors: List[Connector]):
        import inspect

        self.connectors = list(connectors)
        # Probed once: signature inspection is too slow for the per-step
        # sampling hot path.
        self._takes_dones = [
            "dones" in inspect.signature(c.__call__).parameters
            for c in self.connectors
        ]

    def __call__(self, obs: np.ndarray, dones: Optional[np.ndarray] = None) -> np.ndarray:
        for c, takes in zip(self.connectors, self._takes_dones):
            # Stateful connectors (FrameStack) take the episode-boundary
            # signal; stateless ones keep the 1-arg signature.
            obs = c(obs, dones=dones) if takes else c(obs)
        return obs

    def get_state(self) -> Dict[str, Any]:
        return {i: c.get_state() for i, c in enumerate(self.connectors)}

    def set_state(self, state: Dict[str, Any]) -> None:
        for i, c in enumerate(self.connectors):
            if i in state:
                c.set_state(state[i])


class FrameStack(Connector):
    """Stacks the last k observations along the feature axis — the classic
    Atari/velocity-from-position transform (reference: the frame-stacking
    env-to-module connector). Stateful per vector-env slot; a done resets
    that slot's stack (the runner passes `dones` from the previous step)."""

    def __init__(self, k: int = 4):
        self.k = k
        self._stack: Optional[np.ndarray] = None  # [N, k, feat]

    def __call__(self, obs: np.ndarray, dones: Optional[np.ndarray] = None) -> np.ndarray:
        obs = np.asarray(obs, np.float32)
        obs = obs.reshape(obs.shape[0], -1)
        n, feat = obs.shape
        if self._stack is None or self._stack.shape[0] != n or self._stack.shape[2] != feat:
            self._stack = np.zeros((n, self.k, feat), np.float32)
            self._stack[:] = obs[:, None, :]  # cold start: repeat first frame
        elif dones is not None and dones.any():
            idx = np.nonzero(dones)[0]
            self._stack[idx] = obs[idx, None, :]
        self._stack = np.roll(self._stack, shift=-1, axis=1)
        self._stack[:, -1] = obs
        return self._stack.reshape(n, self.k * feat)

    def get_state(self) -> Dict[str, Any]:
        return {"k": self.k, "stack": self._stack}

    def set_state(self, state: Dict[str, Any]) -> None:
        self.k = state["k"]
        self._stack = state["stack"]


# ----------------------------------------------------- module-to-env side


class ActionConnector:
    """One module-to-env transform on the ACTION path (reference:
    connectors/module_to_env/ pipelines — the other half of ConnectorV2).
    The buffer keeps the module's raw action (so (action, logp) stay
    consistent); only the env sees the transformed one."""

    def __call__(self, action: np.ndarray) -> np.ndarray:
        raise NotImplementedError


class ClipAction(ActionConnector):
    def __init__(self, low, high):
        self.low, self.high = np.asarray(low), np.asarray(high)

    def __call__(self, action: np.ndarray) -> np.ndarray:
        return np.clip(action, self.low, self.high)


class UnsquashAction(ActionConnector):
    """Maps a tanh-squashed [-1, 1] module action onto the env's bounds
    (reference: module_to_env normalize/unsquash connector)."""

    def __init__(self, low, high):
        self.low, self.high = np.asarray(low, np.float32), np.asarray(high, np.float32)

    def __call__(self, action: np.ndarray) -> np.ndarray:
        a = np.clip(np.asarray(action, np.float32), -1.0, 1.0)
        return self.low + (a + 1.0) * 0.5 * (self.high - self.low)


class ActionPipeline(ActionConnector):
    def __init__(self, connectors: List[ActionConnector]):
        self.connectors = list(connectors)

    def __call__(self, action: np.ndarray) -> np.ndarray:
        for c in self.connectors:
            action = c(action)
        return action
