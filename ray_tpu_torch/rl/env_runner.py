"""EnvRunner: vectorized sampling actors (the counterpart of
ray_tpu/rl/env_runner.py).

An env runner holds a vector env (rl/envs.py), its own copy of the module's
params and a torch.Generator seeded from `seed`; `sample(num_steps)` steps
the envs through forward_exploration and returns flat numpy rollouts. The
policy runs on the CPU, and the runner says so (`device="cpu"`, passed by
the group, whose actors lease no GPU): per-step device hops would dominate
at CartPole scale. The module and its connectors travel as objects (the
port's core/serialization.py), the weights as the JAX package's numpy tree.

A runner in a worker process (an actor of the cluster runtime) owns that
process and sets one torch intra-op thread: with torch's default of one per
core, runners sampling at once contend for the cores over ops too small to
split, and a sample takes tens of times longer. A runner in the caller's
process (`init(local_mode=True)`, or built directly) leaves its threads
alone.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from .. import api
from .module import RLModule


def one_thread_in_a_worker() -> None:
    """One torch intra-op thread when this process is a worker of the
    cluster runtime (the module docstring says why)."""
    from ..core.runtime_base import maybe_runtime

    rt = maybe_runtime()
    if rt is not None and not rt.is_driver():
        torch.set_num_threads(1)


class SingleAgentEnvRunner:
    """One sampling worker (reference: single_agent_env_runner.py:64)."""

    def __init__(
        self,
        env_name: str,
        module: RLModule,
        num_envs: int,
        seed: int = 0,
        connector=None,
        action_connector=None,
        device="cpu",
    ):
        import inspect

        from .envs import make_vec

        one_thread_in_a_worker()
        self.envs = make_vec(env_name, num_envs)
        self.module = module
        self.device = torch.device(device)
        # env-to-module connector pipeline: applied to every observation; the
        # buffer stores the TRANSFORMED obs so training sees what the policy
        # saw. Its signature is probed once: a TypeError from inside a
        # partly run stateful pipeline must surface, not re-roll FrameStack.
        self.connector = connector
        self._connector_takes_dones = bool(
            connector is not None and "dones" in inspect.signature(connector.__call__).parameters)
        # module-to-env action pipeline: the env sees its output, the buffer
        # keeps the raw action so (action, logp) stay consistent.
        self.action_connector = action_connector
        self.num_envs = num_envs
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self._params = None
        obs, _ = self.envs.reset(seed=seed)
        self._obs = self._flatten(obs)
        self._episode_returns = np.zeros(num_envs)
        self._completed_returns: List[float] = []
        # NEXT_STEP autoreset: the step after done=True is a reset-padding
        # step whose action is ignored; it is masked out of training.
        self._prev_done = np.zeros(num_envs, np.float32)

    def _flatten(self, obs: np.ndarray, dones=None) -> np.ndarray:
        """Default env-to-module transform: flatten to the MLP layout; a
        configured connector pipeline replaces it."""
        if self.connector is not None:
            if self._connector_takes_dones:
                out = self.connector(np.asarray(obs), dones=dones)
            else:
                out = self.connector(np.asarray(obs))
            return np.asarray(out, np.float32)
        return np.asarray(obs, np.float32).reshape(obs.shape[0], -1)

    def set_weights(self, params) -> bool:
        """params: the JAX package's numpy tree (a learner's get_weights)."""
        from ..models.convert import rl_params_from_numpy

        self._params = rl_params_from_numpy(params, device=self.device)
        return True

    def _policy(self, obs: np.ndarray):
        out = self.module.forward_exploration(
            self._params, torch.from_numpy(obs).to(self.device))
        action, logp = self.module.sample_with_params(self._params, self._gen, out)
        return out, action.cpu().numpy(), logp.cpu().numpy()

    @torch.inference_mode()
    def sample(self, num_steps: int) -> Dict[str, np.ndarray]:
        """Rolls out num_steps per env; returns [T, N, ...] arrays."""
        import time

        from ..utils import internal_metrics as imet

        assert self._params is not None, "set_weights before sample"
        sample_t0 = time.perf_counter()
        T, N = num_steps, self.num_envs
        obs_buf = np.zeros((T, N) + self._obs.shape[1:], np.float32)
        if self.module.action_kind == "continuous":
            act_buf = np.zeros((T, N) + tuple(self.module.action_shape), np.float32)
        else:
            act_buf = np.zeros((T, N), np.int64)
        logp_buf = np.zeros((T, N), np.float32)
        val_buf = np.zeros((T, N), np.float32)
        rew_buf = np.zeros((T, N), np.float32)
        term_buf = np.zeros((T, N), np.float32)  # terminated: no bootstrap
        done_buf = np.zeros((T, N), np.float32)  # terminated OR truncated
        mask_buf = np.zeros((T, N), np.float32)  # 0 = autoreset padding step

        obs = self._obs
        completed_this_sample: List[float] = []
        for t in range(T):
            out, action, logp = self._policy(obs)
            obs_buf[t] = obs
            act_buf[t] = action
            logp_buf[t] = logp
            if "vf" in out:  # value-less modules (DQN's Q net)
                val_buf[t] = out["vf"].cpu().numpy()
            mask_buf[t] = 1.0 - self._prev_done
            if self.action_connector is not None:
                env_action = np.asarray(self.action_connector(action))
            else:
                env_action = np.asarray(self.module.clip_action(action))
            obs, rew, terminated, truncated, _ = self.envs.step(env_action)
            done = np.logical_or(terminated, truncated)
            # NEXT_STEP autoreset: the obs of THIS step is the new episode's
            # reset obs iff the PREVIOUS step finished, so the stack-reset
            # signal is prev_done, not this step's done.
            obs = self._flatten(obs, dones=self._prev_done.astype(bool))
            rew_buf[t] = rew
            term_buf[t] = terminated
            done_buf[t] = done
            self._episode_returns += rew
            for i in np.nonzero(done)[0]:
                completed_this_sample.append(float(self._episode_returns[i]))
                self._episode_returns[i] = 0.0
            self._prev_done = done.astype(np.float32)
        self._obs = obs
        self._completed_returns.extend(completed_this_sample)

        # Bootstrap value of the final observation (the GAE tail); last_obs
        # lets off-policy learners (vtrace) recompute it under current
        # params. At a truncation NEXT_STEP autoreset returns the episode's
        # FINAL observation, so the padding row's value is V(final_obs).
        last_out = self.module.forward_exploration(
            self._params, torch.from_numpy(obs).to(self.device))
        last_val = (last_out["vf"].cpu().numpy() if "vf" in last_out
                    else np.zeros((N,), np.float32))
        imet.RL_ENV_STEPS.inc(T * N)
        imet.RL_SAMPLE_TIME.observe((time.perf_counter() - sample_t0) * 1e3)
        return {
            "obs": obs_buf,
            "actions": act_buf,
            "logp": logp_buf,
            "values": val_buf,
            "rewards": rew_buf,
            "terminateds": term_buf,
            "dones": done_buf,
            "mask": mask_buf,
            "last_obs": obs.copy(),
            "last_values": last_val,
            "episode_returns": completed_this_sample,
        }

    def episode_returns(self, clear: bool = True) -> List[float]:
        out = list(self._completed_returns)
        if clear:
            self._completed_returns = []
        return out

    def get_connector_state(self):
        return self.connector.get_state() if self.connector is not None else None

    def set_connector_state(self, state) -> bool:
        if self.connector is not None and state is not None:
            self.connector.set_state(state)
        return True

    def ping(self) -> bool:
        return True


class EnvRunnerGroup:
    """Fault-tolerant group of env-runner actors (reference:
    env_runner_group.py:70 + FaultTolerantActorManager: probe and replace
    dead runners instead of failing the run). The actors lease no GPU and
    run their policy on the CPU."""

    def __init__(
        self,
        env_name: str,
        module: RLModule,
        *,
        num_runners: int = 2,
        num_envs_per_runner: int = 4,
        seed: int = 0,
        connector=None,
        action_connector=None,
    ):
        self._env_name = env_name
        self._module = module
        self._connector = connector
        self._action_connector = action_connector
        self._num_envs = num_envs_per_runner
        self._seed = seed
        self._restarts = 0
        self._last_weights_ref = None  # re-seeds replacement runners
        self._last_connector_state = None
        self._cls = api.remote(max_concurrency=1, num_gpus=0)(SingleAgentEnvRunner)
        self._runners = [self._make_runner(i) for i in range(num_runners)]

    def _make_runner(self, idx: int):
        runner = self._cls.remote(self._env_name, self._module, self._num_envs,
                                  self._seed + 1000 * idx, self._connector,
                                  self._action_connector, "cpu")
        if self._last_weights_ref is not None:
            api.get(runner.set_weights.remote(self._last_weights_ref))
        if self._last_connector_state is not None:
            # A replacement must not restart stateful connectors (obs
            # normalization) from zero: its observations would arrive at
            # another scale than the policy was trained on.
            api.get(runner.set_connector_state.remote(self._last_connector_state))
        return runner

    def replace_runner(self, runner) -> Any:
        """Swaps a dead runner for a fresh one (with current weights) and
        returns the replacement."""
        for i, r in enumerate(self._runners):
            if r is runner or r._id == getattr(runner, "_id", None):
                self._restarts += 1
                self._runners[i] = self._make_runner(i)
                return self._runners[i]
        raise ValueError("runner not in group")

    @property
    def runners(self):
        return list(self._runners)

    @property
    def num_restarts(self) -> int:
        return self._restarts

    def cache_weights(self, ref) -> None:
        """Records the current-weights ref that seeds replacement runners
        (for callers that push weights to runners one by one: IMPALA)."""
        self._last_weights_ref = ref

    def sync_weights(self, params) -> None:
        self._last_weights_ref = api.put(params)
        api.get([r.set_weights.remote(self._last_weights_ref) for r in self._runners])

    def sample(self, num_steps_per_runner: int) -> List[Dict[str, np.ndarray]]:
        refs = [r.sample.remote(num_steps_per_runner) for r in self._runners]
        out = []
        first_alive = None
        for i, ref in enumerate(refs):
            try:
                out.append(api.get(ref))
                if first_alive is None:
                    first_alive = self._runners[i]
            except Exception:  # noqa: BLE001 - probe-and-restart: the sample is skipped
                self._restarts += 1
                self._runners[i] = self._make_runner(i)
        if self._connector is not None and first_alive is not None:
            # Cache mature connector stats for replacements and checkpoints,
            # and broadcast them so stateful connectors do not drift apart
            # across runners.
            try:
                self._last_connector_state = api.get(first_alive.get_connector_state.remote())
                if self._last_connector_state is not None:
                    for r in self._runners:
                        if r is not first_alive:
                            r.set_connector_state.remote(self._last_connector_state)
            except Exception:  # noqa: BLE001 - logged: losing the stats skews training
                from ..observability.logs import get_logger

                get_logger("rl").warning("connector-state restore after runner churn failed",
                                         exc_info=True)
        return out

    def connector_state(self):
        """Latest stateful-connector state (for checkpoints and evaluation)."""
        return self._last_connector_state

    def episode_returns(self) -> List[float]:
        outs = api.get([r.episode_returns.remote() for r in self._runners])
        return [v for sub in outs for v in sub]
