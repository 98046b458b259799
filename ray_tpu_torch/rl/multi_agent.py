"""Multi-agent RL: env API, env runner, and multi-policy PPO (the
counterpart of ray_tpu/rl/multi_agent.py; the env constructor, the modules
and the mapping function travel as objects, and the runner's policy runs on
the CPU with its own torch.Generator).

Re-design of the reference's multi-agent stack (reference:
rllib/env/multi_agent_env.py:32 MultiAgentEnv — dict-keyed obs/reward/
done per agent; env/multi_agent_env_runner.py MultiAgentEnvRunner;
algorithm_config.multi_agent(policies=..., policy_mapping_fn=...)). Each
module (policy) owns its own param pytree and learner; agents map to
modules via `policy_mapping_fn`, so parameter sharing is just mapping
several agents to one module id.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import api
from .env_runner import one_thread_in_a_worker
from .learner import LearnerGroup
from .module import RLModule
from .ppo import compute_gae, ppo_loss


class MultiAgentEnv:
    """ABC (reference: multi_agent_env.py:32). Dict-keyed per-agent API;
    an episode ends when "__all__" is set in terminateds/truncateds."""

    possible_agents: List[str] = []

    def reset(self, *, seed: Optional[int] = None) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        raise NotImplementedError

    def step(
        self, actions: Dict[str, Any]
    ) -> Tuple[Dict[str, Any], Dict[str, float], Dict[str, bool], Dict[str, bool], Dict]:
        raise NotImplementedError


class MultiAgentEnvRunner:
    """Samples a MultiAgentEnv with per-module policies (reference:
    env/multi_agent_env_runner.py). Returns one flat rollout per module id
    so each learner trains on exactly its own agents' experience."""

    def __init__(
        self,
        env_ctor: Callable[[], MultiAgentEnv],
        modules: Dict[str, RLModule],
        policy_mapping_fn: Callable[[str], str],
        seed: int = 0,
        device="cpu",
    ):
        one_thread_in_a_worker()
        self.env: MultiAgentEnv = env_ctor()
        self.modules: Dict[str, RLModule] = dict(modules)
        self.policy_mapping_fn = policy_mapping_fn
        self.device = torch.device(device)
        self._params: Dict[str, Any] = {}
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self._obs, _ = self.env.reset(seed=seed)
        self._episode_return = 0.0
        self._completed: List[float] = []

    def set_weights(self, params_by_module: Dict[str, Any]) -> bool:
        """{module id: the JAX package's numpy param tree}."""
        from ..models.convert import rl_params_from_numpy

        self._params.update({mid: rl_params_from_numpy(tree, device=self.device)
                             for mid, tree in params_by_module.items()})
        return True

    def _forward(self, mid: str, obs):
        obs_t = torch.as_tensor(np.asarray(obs, np.float32)[None], device=self.device)
        return self.modules[mid].forward_exploration(self._params[mid], obs_t)

    @torch.inference_mode()
    def _value_of(self, mid: str, obs) -> float:
        out = self._forward(mid, obs)
        return float(out["vf"][0]) if "vf" in out else 0.0

    @torch.inference_mode()
    def sample(self, num_steps: int) -> Dict[str, List[Dict[str, np.ndarray]]]:
        """Returns per-module LISTS of per-agent trajectory segments: GAE
        must run per agent stream (interleaving agents of a shared policy
        would back values up across unrelated trajectories)."""
        # (mid, agent) -> per-key lists; flushed into `segments` at episode
        # boundaries so each segment is one contiguous single-agent stream.
        bufs: Dict[Tuple[str, str], Dict[str, list]] = {}
        segments: Dict[str, List[Dict[str, np.ndarray]]] = {mid: [] for mid in self.modules}

        def flush(key, last_value: float):
            buf = bufs.pop(key, None)
            if not buf or not buf["obs"]:
                return
            mid = key[0]
            seg = {k: np.asarray(v, np.float32) for k, v in buf.items()}
            seg["obs"] = np.stack(buf["obs"]).astype(np.float32)
            seg["actions"] = np.asarray(buf["actions"])
            seg["last_value"] = np.float32(last_value)
            segments[mid].append(seg)

        for _ in range(num_steps):
            actions: Dict[str, Any] = {}
            step_records: Dict[str, Tuple[str, Any, Any, float]] = {}
            for agent_id, obs in self._obs.items():
                mid = self.policy_mapping_fn(agent_id)
                module = self.modules[mid]
                out = self._forward(mid, obs)
                action, logp = module.sample_with_params(self._params[mid], self._gen, out)
                action = action.cpu().numpy()[0]
                # Bounds apply only at the env interface (as in the
                # single-agent runner); the buffer keeps the raw action.
                actions[agent_id] = np.asarray(module.clip_action(action))
                value = float(out["vf"][0]) if "vf" in out else 0.0
                step_records[agent_id] = (mid, obs, (action, float(logp[0])), value)
            next_obs, rewards, terms, truncs, _ = self.env.step(actions)
            done_all = bool(terms.get("__all__", False) or truncs.get("__all__", False))
            for agent_id, (mid, obs, (act, logp), value) in step_records.items():
                term = bool(terms.get(agent_id, False)) or bool(terms.get("__all__", False))
                done = term or bool(truncs.get(agent_id, False)) or done_all
                buf = bufs.setdefault(
                    (mid, agent_id),
                    {k: [] for k in ("obs", "actions", "logp", "values", "rewards",
                                     "dones", "terminateds")},
                )
                buf["obs"].append(np.asarray(obs, np.float32))
                buf["actions"].append(act)
                buf["logp"].append(logp)
                buf["values"].append(value)
                buf["rewards"].append(float(rewards.get(agent_id, 0.0)))
                buf["dones"].append(1.0 if done else 0.0)
                buf["terminateds"].append(1.0 if term else 0.0)
                if done:
                    flush((mid, agent_id), 0.0)  # boundary: no bootstrap
            self._episode_return += sum(float(r) for r in rewards.values())
            if done_all:
                self._completed.append(self._episode_return)
                self._episode_return = 0.0
                next_obs, _ = self.env.reset()
            self._obs = next_obs

        # Mid-episode rollout ends bootstrap with V(current obs).
        for (mid, agent_id) in list(bufs):
            obs = self._obs.get(agent_id)
            last_v = self._value_of(mid, obs) if obs is not None else 0.0
            flush((mid, agent_id), last_v)
        return segments

    def episode_returns(self, clear: bool = True) -> List[float]:
        out = list(self._completed)
        if clear:
            self._completed = []
        return out


@dataclasses.dataclass
class MultiAgentPPOConfig:
    """(reference: AlgorithmConfig.multi_agent(policies, policy_mapping_fn))"""

    env_ctor: Callable[[], MultiAgentEnv] = None
    policies: Dict[str, RLModule] = None  # module_id -> RLModule
    policy_mapping_fn: Callable[[str], str] = None
    rollout_length: int = 64
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_param: float = 0.2
    vf_coeff: float = 0.5
    entropy_coeff: float = 0.01
    lr: float = 3e-4
    grad_clip: Optional[float] = 0.5
    num_epochs: int = 2
    seed: int = 0
    device: Any = None  # the learners': CUDA unless "cpu"

    def build(self) -> "MultiAgentPPO":
        return MultiAgentPPO(self)


class MultiAgentPPO:
    """One PPO learner per module id; shared-policy training is agents
    mapping to the same module (reference: rllib multi-agent training with
    the new API stack's per-module learners)."""

    def __init__(self, config: MultiAgentPPOConfig):
        import functools

        self.config = config
        loss = functools.partial(
            ppo_loss,
            clip=config.clip_param,
            vf_coeff=config.vf_coeff,
            ent_coeff=config.entropy_coeff,
        )
        self.learners: Dict[str, LearnerGroup] = {
            mid: LearnerGroup(
                m,
                loss,
                num_learners=1,
                lr=config.lr,
                grad_clip=config.grad_clip,
                seed=config.seed,
                device=config.device,
            )
            for mid, m in config.policies.items()
        }
        runner_cls = api.remote(max_concurrency=1, num_gpus=0)(MultiAgentEnvRunner)
        self.runner = runner_cls.remote(
            config.env_ctor, dict(config.policies), config.policy_mapping_fn, config.seed, "cpu")
        self._sync_weights()
        self.iteration = 0

    def _sync_weights(self) -> None:
        api.get(
            self.runner.set_weights.remote(
                {mid: lg.get_weights() for mid, lg in self.learners.items()}
            )
        )

    def train(self) -> Dict[str, Any]:
        cfg = self.config
        rollouts = api.get(self.runner.sample.remote(cfg.rollout_length), timeout=300)
        metrics: Dict[str, Any] = {}
        total_steps = 0
        for mid, segs in rollouts.items():
            if not segs:
                continue
            parts = []
            for seg in segs:
                # GAE per contiguous single-agent segment, with the
                # runner-computed V(last_obs) bootstrap and terminateds.
                adv, ret = compute_gae(
                    seg["rewards"][:, None],
                    seg["values"][:, None],
                    seg["dones"][:, None],
                    np.asarray([seg["last_value"]], np.float32),
                    cfg.gamma,
                    cfg.gae_lambda,
                    terminateds=seg["terminateds"][:, None],
                )
                parts.append(
                    {
                        "obs": seg["obs"],
                        "actions": seg["actions"],
                        "logp": seg["logp"],
                        "advantages": adv[:, 0],
                        "returns": ret[:, 0],
                    }
                )
            batch = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
            adv = batch["advantages"]
            batch["advantages"] = (adv - adv.mean()) / (adv.std() + 1e-8)
            total_steps += batch["obs"].shape[0]
            for _ in range(cfg.num_epochs):
                metrics[mid] = self.learners[mid].update(batch)
        self._sync_weights()
        self.iteration += 1
        returns = api.get(self.runner.episode_returns.remote())
        return {
            "iteration": self.iteration,
            "num_env_steps_sampled": total_steps,
            "episode_return_mean": float(np.mean(returns)) if returns else float("nan"),
            "module_metrics": metrics,
        }

    def get_weights(self) -> Dict[str, Any]:
        return {mid: lg.get_weights() for mid, lg in self.learners.items()}

    def shutdown(self) -> None:
        for lg in self.learners.values():
            lg.shutdown()
