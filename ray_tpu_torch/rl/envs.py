"""The two environments the RL stack runs, as numpy copies of gymnasium's.

The port has no gymnasium dependency (a machine with the card need not have
it), so it keeps its own copies of the only two environments the JAX
package's RL stack and its tests use, `CartPole-v1` and `Pendulum-v1`, with
the behaviour `gymnasium.make_vec(name, num_envs)` gives them in gymnasium
1.2.2, bit for bit under the same seed and actions
(tests/test_torch_rl_envs.py):

- `CartPole-v1` is gymnasium's own vector class `CartPoleVectorEnv`: one
  numpy Generator for every env, the state laid out (4, N), resets drawn as
  `uniform(-0.05, 0.05, size=(4, n))`, NEXT_STEP autoreset (the step after
  a done re-draws only the done columns and zeroes their reward,
  terminated and truncated), truncation at 500 steps, float32
  observations from `state.T`.
- `Pendulum-v1` is a `SyncVectorEnv` of `PendulumEnv` under
  `TimeLimit(200)`, env i seeded `seed + i`, with NEXT_STEP autoreset.

Any other name raises: this is the one difference by design from the JAX
package, whose env runners take any gymnasium id.

The dynamics below are copied from gymnasium (gymnasium/envs/
classic_control/cartpole.py, pendulum.py; gymnasium/vector/
sync_vector_env.py; gymnasium/wrappers/common.py TimeLimit) under its
licence:

    The MIT License

    Copyright (c) 2016 OpenAI
    Copyright (c) 2022 Farama Foundation

    Permission is hereby granted, free of charge, to any person obtaining a
    copy of this software and associated documentation files (the
    "Software"), to deal in the Software without restriction, including
    without limitation the rights to use, copy, modify, merge, publish,
    distribute, sublicense, and/or sell copies of the Software, and to
    permit persons to whom the Software is furnished to do so, subject to
    the following conditions:

    The above copyright notice and this permission notice shall be included
    in all copies or substantial portions of the Software.

    THE SOFTWARE IS PROVIDED "AS IS", WITHOUT WARRANTY OF ANY KIND, EXPRESS
    OR IMPLIED, INCLUDING BUT NOT LIMITED TO THE WARRANTIES OF
    MERCHANTABILITY, FITNESS FOR A PARTICULAR PURPOSE AND NONINFRINGEMENT.
    IN NO EVENT SHALL THE AUTHORS OR COPYRIGHT HOLDERS BE LIABLE FOR ANY
    CLAIM, DAMAGES OR OTHER LIABILITY, WHETHER IN AN ACTION OF CONTRACT,
    TORT OR OTHERWISE, ARISING FROM, OUT OF OR IN CONNECTION WITH THE
    SOFTWARE OR THE USE OR OTHER DEALINGS IN THE SOFTWARE.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional, Tuple

import numpy as np

ENV_NAMES = ("CartPole-v1", "Pendulum-v1")


def np_random(seed: Optional[int] = None) -> np.random.Generator:
    """gymnasium.utils.seeding.np_random: PCG64 over a SeedSequence."""
    if seed is not None and not (isinstance(seed, int) and seed >= 0):
        raise ValueError(f"seed must be a non-negative int, got {seed!r}")
    return np.random.Generator(np.random.PCG64(np.random.SeedSequence(seed)))


@dataclasses.dataclass(frozen=True)
class Discrete:
    n: int


@dataclasses.dataclass(frozen=True)
class Box:
    low: np.ndarray
    high: np.ndarray

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.low.shape)


# ------------------------------------------------------------------ CartPole


class CartPoleVectorEnv:
    """gymnasium's CartPoleVectorEnv (Euler integration, reward 1 a step)."""

    def __init__(self, num_envs: int = 1, max_episode_steps: int = 500):
        self.num_envs = num_envs
        self.max_episode_steps = max_episode_steps
        self.gravity = 9.8
        self.masscart = 1.0
        self.masspole = 0.1
        self.total_mass = self.masspole + self.masscart
        self.length = 0.5  # half the pole's length
        self.polemass_length = self.masspole * self.length
        self.force_mag = 10.0
        self.tau = 0.02  # seconds between state updates
        self.theta_threshold_radians = 12 * 2 * math.pi / 360
        self.x_threshold = 2.4
        high = np.array([self.x_threshold * 2, np.inf, self.theta_threshold_radians * 2,
                         np.inf], dtype=np.float32)
        self.single_observation_space = Box(-high, high)
        self.single_action_space = Discrete(2)
        self.low, self.high = -0.05, 0.05
        self.state: Optional[np.ndarray] = None
        self.steps = np.zeros(num_envs, dtype=np.int32)
        self.prev_done = np.zeros(num_envs, dtype=np.bool_)
        self._np_random: Optional[np.random.Generator] = None

    @property
    def np_random(self) -> np.random.Generator:
        if self._np_random is None:
            self._np_random = np_random()
        return self._np_random

    def reset(self, *, seed: Optional[int] = None, options=None):
        if seed is not None:
            self._np_random = np_random(seed)
        self.state = self.np_random.uniform(low=self.low, high=self.high,
                                            size=(4, self.num_envs))
        self.steps = np.zeros(self.num_envs, dtype=np.int32)
        self.prev_done = np.zeros(self.num_envs, dtype=np.bool_)
        return self.state.T.astype(np.float32), {}

    def step(self, action: np.ndarray):
        action = np.asarray(action)
        if action.shape != (self.num_envs,) or action.dtype.kind not in "iu":
            raise ValueError(f"{action!r} is not {self.num_envs} integer actions")
        if self.state is None:
            raise RuntimeError("call reset before step")
        x, x_dot, theta, theta_dot = self.state
        force = np.sign(action - 0.5) * self.force_mag
        costheta = np.cos(theta)
        sintheta = np.sin(theta)
        temp = (force + self.polemass_length * np.square(theta_dot) * sintheta
                ) / self.total_mass
        thetaacc = (self.gravity * sintheta - costheta * temp) / (
            self.length * (4.0 / 3.0 - self.masspole * np.square(costheta) / self.total_mass))
        xacc = temp - self.polemass_length * thetaacc * costheta / self.total_mass
        x = x + self.tau * x_dot
        x_dot = x_dot + self.tau * xacc
        theta = theta + self.tau * theta_dot
        theta_dot = theta_dot + self.tau * thetaacc
        self.state = np.stack((x, x_dot, theta, theta_dot))
        terminated = ((x < -self.x_threshold) | (x > self.x_threshold)
                      | (theta < -self.theta_threshold_radians)
                      | (theta > self.theta_threshold_radians))
        self.steps += 1
        truncated = self.steps >= self.max_episode_steps
        reward = np.ones_like(terminated, dtype=np.float32)
        # NEXT_STEP autoreset: the envs done at the previous step restart now.
        self.state[:, self.prev_done] = self.np_random.uniform(
            low=self.low, high=self.high, size=(4, self.prev_done.sum()))
        self.steps[self.prev_done] = 0
        reward[self.prev_done] = 0.0
        terminated[self.prev_done] = False
        truncated[self.prev_done] = False
        self.prev_done = np.logical_or(terminated, truncated)
        return self.state.T.astype(np.float32), reward, terminated, truncated, {}

    def close(self) -> None:
        pass


# ------------------------------------------------------------------ Pendulum


def angle_normalize(x):
    return ((x + np.pi) % (2 * np.pi)) - np.pi


class PendulumEnv:
    """gymnasium's PendulumEnv (g = 10)."""

    def __init__(self, g: float = 10.0):
        self.max_speed = 8
        self.max_torque = 2.0
        self.dt = 0.05
        self.g = g
        self.m = 1.0
        self.l = 1.0  # noqa: E741 - gymnasium's name
        high = np.array([1.0, 1.0, self.max_speed], dtype=np.float32)
        self.observation_space = Box(-high, high)
        self.action_space = Box(np.array([-self.max_torque], np.float32),
                                np.array([self.max_torque], np.float32))
        self.state: Optional[np.ndarray] = None
        self._np_random: Optional[np.random.Generator] = None

    @property
    def np_random(self) -> np.random.Generator:
        if self._np_random is None:
            self._np_random = np_random()
        return self._np_random

    def step(self, u):
        th, thdot = self.state
        g, m, l, dt = self.g, self.m, self.l, self.dt  # noqa: E741
        u = np.clip(u, -self.max_torque, self.max_torque)[0]
        costs = angle_normalize(th) ** 2 + 0.1 * thdot**2 + 0.001 * (u**2)
        newthdot = thdot + (3 * g / (2 * l) * np.sin(th) + 3.0 / (m * l**2) * u) * dt
        newthdot = np.clip(newthdot, -self.max_speed, self.max_speed)
        newth = th + newthdot * dt
        self.state = np.array([newth, newthdot])
        return self._get_obs(), -costs, False, False, {}

    def reset(self, *, seed: Optional[int] = None, options=None):
        if seed is not None:
            self._np_random = np_random(seed)
        high = np.array([np.pi, 1.0])
        self.state = self.np_random.uniform(low=-high, high=high)
        return self._get_obs(), {}

    def _get_obs(self):
        theta, thetadot = self.state
        return np.array([np.cos(theta), np.sin(theta), thetadot], dtype=np.float32)


class TimeLimit:
    """Truncates an episode after `max_episode_steps` steps."""

    def __init__(self, env, max_episode_steps: int):
        self.env = env
        self.max_episode_steps = max_episode_steps
        self.observation_space = env.observation_space
        self.action_space = env.action_space
        self._elapsed_steps = 0

    def step(self, action):
        obs, reward, terminated, truncated, info = self.env.step(action)
        self._elapsed_steps += 1
        if self._elapsed_steps >= self.max_episode_steps:
            truncated = True
        return obs, reward, terminated, truncated, info

    def reset(self, *, seed: Optional[int] = None, options=None):
        self._elapsed_steps = 0
        return self.env.reset(seed=seed, options=options)


class SyncVectorEnv:
    """gymnasium's SyncVectorEnv with NEXT_STEP autoreset: an env that ended
    at the previous step is reset (its reward, terminated and truncated
    zeroed) and the action given for it is ignored."""

    def __init__(self, env_fns: List[Callable[[], object]]):
        self.envs = [fn() for fn in env_fns]
        self.num_envs = len(self.envs)
        self.single_observation_space = self.envs[0].observation_space
        self.single_action_space = self.envs[0].action_space
        obs_shape = self.single_observation_space.shape
        self._observations = np.zeros((self.num_envs,) + obs_shape, np.float32)
        self._env_obs: List[Optional[np.ndarray]] = [None] * self.num_envs
        self._rewards = np.zeros((self.num_envs,), dtype=np.float64)
        self._terminations = np.zeros((self.num_envs,), dtype=np.bool_)
        self._truncations = np.zeros((self.num_envs,), dtype=np.bool_)
        self._autoreset_envs = np.zeros((self.num_envs,), dtype=np.bool_)

    def reset(self, *, seed=None, options=None):
        if seed is None:
            seed = [None] * self.num_envs
        elif isinstance(seed, int):
            seed = [seed + i for i in range(self.num_envs)]
        self._terminations = np.zeros((self.num_envs,), dtype=np.bool_)
        self._truncations = np.zeros((self.num_envs,), dtype=np.bool_)
        self._autoreset_envs = np.zeros((self.num_envs,), dtype=np.bool_)
        for i, (env, single_seed) in enumerate(zip(self.envs, seed)):
            self._env_obs[i], _ = env.reset(seed=single_seed, options=options)
        self._observations = np.stack(self._env_obs).astype(np.float32)
        return self._observations.copy(), {}

    def step(self, actions):
        actions = np.asarray(actions)
        for i, (action, env) in enumerate(zip(actions, self.envs)):
            if self._autoreset_envs[i]:
                self._env_obs[i], _ = env.reset()
                self._rewards[i] = 0.0
                self._terminations[i] = False
                self._truncations[i] = False
            else:
                (self._env_obs[i], self._rewards[i], self._terminations[i],
                 self._truncations[i], _) = env.step(action)
        self._observations = np.stack(self._env_obs).astype(np.float32)
        self._autoreset_envs = np.logical_or(self._terminations, self._truncations)
        return (self._observations.copy(), np.copy(self._rewards),
                np.copy(self._terminations), np.copy(self._truncations), {})

    def close(self) -> None:
        pass


# ------------------------------------------------------------------ make


def _unknown(name: str) -> ValueError:
    return ValueError(f"unknown environment {name!r}: the port has only {list(ENV_NAMES)} "
                      "(numpy copies of gymnasium's; the JAX package takes any gymnasium id)")


def make_vec(name: str, num_envs: int):
    """What `gymnasium.make_vec(name, num_envs=num_envs)` returns for the two
    names the port has."""
    if name == "CartPole-v1":
        return CartPoleVectorEnv(num_envs=num_envs, max_episode_steps=500)
    if name == "Pendulum-v1":
        return SyncVectorEnv([lambda: TimeLimit(PendulumEnv(), max_episode_steps=200)
                              for _ in range(num_envs)])
    raise _unknown(name)


def spaces(name: str):
    """(observation space, action space) of one env of `name`: what
    `gymnasium.make(name)`'s spaces hold (obs shape, `n` or the action
    shape, low/high)."""
    if name == "CartPole-v1":
        env = CartPoleVectorEnv(num_envs=1)
    elif name == "Pendulum-v1":
        env = SyncVectorEnv([PendulumEnv])
    else:
        raise _unknown(name)
    return env.single_observation_space, env.single_action_space
