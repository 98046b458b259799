"""DQN: off-policy Q-learning over the replay buffer (the counterpart of
ray_tpu/rl/dqn.py).

Re-design of the reference's DQN (reference: rllib/algorithms/dqn/dqn.py
training_step — sample -> store -> replay -> learner update -> target-net
sync; loss rllib/algorithms/dqn/torch/dqn_torch_learner.py). The Q network,
the Huber TD loss and the double-Q targets run on the learner's device; the
target network is a copy of the params taken every `target_update_freq`
updates; epsilon-greedy exploration rides the synced params (the buffer
"epsilon"), so env runners decay epsilon with every weight broadcast.
`argmax` takes the first maximum, as jnp.argmax does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from .env_runner import EnvRunnerGroup
from .learner import LearnerGroup, batch_to_device
from .module import MLP, DiscretePolicyConfig, RLModule, RLParams
from .replay import TransitionReplayBuffer


class QModule(RLModule):
    """MLP Q-network with epsilon-greedy exploration carried in params."""

    action_kind = "discrete"

    def __init__(self, config: DiscretePolicyConfig):
        self.config = config

    def init_params(self, generator, device=None) -> RLParams:
        c = self.config
        return RLParams(
            nets={"q": MLP((c.obs_dim,) + tuple(c.hidden) + (c.n_actions,), generator,
                           dtype=c.dtype, device=device)},
            buffers={"epsilon": torch.tensor(1.0, dtype=torch.float32, device=device)})

    def forward_inference(self, params, obs):
        return {"q": params.q(obs)}

    def sample_with_params(self, params, generator, fwd_out):
        q = fwd_out["q"]
        greedy = torch.argmax(q, dim=-1)
        random_a = torch.randint(0, q.shape[-1], greedy.shape, generator=generator,
                                 device=q.device)
        explore = torch.rand(greedy.shape, generator=generator, device=q.device) < params.epsilon
        action = torch.where(explore, random_a, greedy)
        return action, torch.zeros_like(q[..., 0])  # logp unused off-policy


def dqn_loss(module: RLModule, params, batch):
    """Huber TD error against precomputed targets (the targets come from
    the frozen target network, outside the learner)."""
    q = module.forward_train(params, batch["obs"])["q"]
    q_taken = torch.gather(q, -1, batch["actions"].long()[..., None])[..., 0]
    td = q_taken - batch["targets"]
    huber = torch.where(torch.abs(td) <= 1.0, 0.5 * td**2, torch.abs(td) - 0.5)
    loss = torch.mean(huber)
    return loss, {"td_error_mean": torch.mean(torch.abs(td)), "q_mean": torch.mean(q_taken)}


@dataclasses.dataclass
class DQNConfig:
    """(reference: dqn.py DQNConfig)"""

    env: str = "CartPole-v1"
    num_env_runners: int = 1
    num_envs_per_runner: int = 8
    rollout_length: int = 16
    buffer_capacity: int = 50_000
    learning_starts: int = 500
    train_batch_size: int = 64
    updates_per_iteration: int = 16
    gamma: float = 0.99
    lr: float = 5e-4
    grad_clip: Optional[float] = 10.0
    target_update_freq: int = 200      # learner updates between target syncs
    epsilon_initial: float = 1.0
    epsilon_final: float = 0.05
    epsilon_decay_steps: int = 5_000   # env steps to reach epsilon_final
    double_q: bool = True
    hidden: Tuple[int, ...] = (64, 64)
    seed: int = 0
    device: Any = None  # the learner's: CUDA unless "cpu"

    def environment(self, env: str) -> "DQNConfig":
        self.env = env
        return self

    def env_runners(self, num_env_runners: int, num_envs_per_runner: int = 8) -> "DQNConfig":
        self.num_env_runners = num_env_runners
        self.num_envs_per_runner = num_envs_per_runner
        return self

    def training(self, **kw) -> "DQNConfig":
        for k, v in kw.items():
            if not hasattr(self, k):
                raise AttributeError(k)
            setattr(self, k, v)
        return self

    def build(self) -> "DQN":
        return DQN(self)


class DQN:
    """(reference: Algorithm + DQN.training_step)"""

    def __init__(self, config: DQNConfig):
        from .envs import spaces

        self.config = config
        obs_space, act_space = spaces(config.env)
        self.module = QModule(DiscretePolicyConfig(
            obs_dim=int(math.prod(obs_space.shape)), n_actions=int(act_space.n),
            hidden=tuple(config.hidden)))
        self.learner_group = LearnerGroup(
            self.module, dqn_loss, num_learners=1, lr=config.lr,
            grad_clip=config.grad_clip, seed=config.seed, device=config.device)
        self.device = self.learner_group.device
        self.env_runner_group = EnvRunnerGroup(
            config.env, self.module,
            num_runners=config.num_env_runners,
            num_envs_per_runner=config.num_envs_per_runner,
            seed=config.seed,
        )
        self.buffer = TransitionReplayBuffer(config.buffer_capacity, seed=config.seed)
        self.target_params = self._on_device(self.learner_group.get_weights())
        self.num_env_steps = 0
        self.num_updates = 0
        self.iteration = 0
        self._sync_epsilon()

    # -------------------------------------------------------------- misc
    def _on_device(self, weights) -> RLParams:
        from ..models.convert import rl_params_from_numpy

        return rl_params_from_numpy(weights, device=self.device).requires_grad_(False)

    def _epsilon(self) -> float:
        c = self.config
        frac = min(1.0, self.num_env_steps / max(1, c.epsilon_decay_steps))
        return float(c.epsilon_initial + frac * (c.epsilon_final - c.epsilon_initial))

    def _sync_epsilon(self) -> None:
        params = dict(self.learner_group.get_weights())
        params["epsilon"] = np.asarray(self._epsilon(), np.float32)
        self.learner_group.set_weights(params)
        self.env_runner_group.sync_weights(params)

    @torch.no_grad()
    def _compute_targets(self, target_params, online_params, batch):
        c = self.config
        q_next_t = self.module.forward_inference(target_params, batch["next_obs"])["q"]
        if c.double_q:
            # Double-Q: the online net selects, the target net evaluates.
            q_next_o = self.module.forward_inference(online_params, batch["next_obs"])["q"]
            best = torch.argmax(q_next_o, dim=-1)
            q_next = torch.gather(q_next_t, -1, best[..., None])[..., 0]
        else:
            q_next = torch.max(q_next_t, dim=-1).values
        return batch["rewards"] + c.gamma * (1.0 - batch["terminateds"]) * q_next

    # -------------------------------------------------------------- train
    def train(self) -> Dict[str, Any]:
        cfg = self.config
        rollouts = self.env_runner_group.sample(cfg.rollout_length)
        for ro in rollouts:
            self.num_env_steps += self.buffer.add_rollout(ro)

        metrics: Dict[str, float] = {}
        if len(self.buffer) >= cfg.learning_starts:
            accum = []
            # One weight fetch per iteration for double-Q action selection:
            # <= updates_per_iteration staleness in the SELECTION net is
            # benign (the target net is far staler by design).
            online = self._on_device(self.learner_group.get_weights())
            for _ in range(cfg.updates_per_iteration):
                batch = batch_to_device(self.buffer.sample(cfg.train_batch_size), self.device)
                batch["targets"] = self._compute_targets(self.target_params, online, batch)
                accum.append(self.learner_group.update(batch))
                self.num_updates += 1
                if self.num_updates % cfg.target_update_freq == 0:
                    self.target_params = self._on_device(self.learner_group.get_weights())
            metrics = {k: float(np.mean([m[k] for m in accum])) for k in accum[0]}

        self._sync_epsilon()
        self.iteration += 1
        returns = self.env_runner_group.episode_returns()
        return {
            "iteration": self.iteration,
            "num_env_steps_sampled": self.num_env_steps,
            "num_updates": self.num_updates,
            "epsilon": self._epsilon(),
            "buffer_size": len(self.buffer),
            "episode_return_mean": float(np.mean(returns)) if returns else float("nan"),
            "num_episodes": len(returns),
            **metrics,
        }

    # --------------------------------------------------------- checkpoint
    def save(self, directory: str) -> None:
        from ..models.convert import rl_params_to_numpy
        from ..train.checkpoint import save_pytree

        save_pytree(
            {
                "params": self.learner_group.get_weights(),
                "target": rl_params_to_numpy(self.target_params),
                "counters": {
                    "num_env_steps": self.num_env_steps,
                    "num_updates": self.num_updates,
                    "iteration": self.iteration,
                },
            },
            directory,
        )

    def restore(self, directory: str) -> None:
        from ..train.checkpoint import load_pytree

        data = load_pytree(directory)
        self.learner_group.set_weights(data["params"])
        self.target_params = self._on_device(data["target"])
        counters = data.get("counters", {})
        # Counters drive epsilon decay and the target cadence: without them a
        # restored near-greedy policy would revert to fully random.
        self.num_env_steps = int(counters.get("num_env_steps", 0))
        self.num_updates = int(counters.get("num_updates", 0))
        self.iteration = int(counters.get("iteration", 0))
        self._sync_epsilon()
