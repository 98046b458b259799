"""The port's own CartPole and Pendulum (ray_tpu_torch/rl/envs.py) against
gymnasium 1.2.2, bit for bit.

Under the same seed and the same random actions, `make_vec(name, n)` must
give exactly what `gymnasium.make_vec(name, num_envs=n)` gives: float32
observations, rewards (float32 for CartPole, float64 for Pendulum's
SyncVectorEnv), terminated and truncated, with their dtypes, through the
resets of NEXT_STEP autoreset. A CartPole with a 20-step limit and
Pendulum's 200-step TimeLimit make truncation and autoreset rows occur. An
unknown name raises, naming the two the port has.
"""

import numpy as np
import pytest

gym = pytest.importorskip("gymnasium")

from ray_tpu_torch.rl import envs  # noqa: E402


def _run(ours, theirs, steps, action, seed):
    """Steps both envs with the same actions, asserting equal outputs;
    returns the truncations counted over the run."""
    got, _ = ours.reset(seed=seed)
    want, _ = theirs.reset(seed=seed)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    rng = np.random.default_rng(seed + 100)
    truncs = 0
    for t in range(steps):
        a = action(rng)
        mine, gyms = ours.step(a)[:4], theirs.step(a)[:4]
        for g, w, what in zip(mine, gyms, ("obs", "reward", "terminated", "truncated")):
            assert g.dtype == w.dtype, (t, what, g.dtype, w.dtype)
            assert np.array_equal(g, w), (t, what, g, w)
        truncs += int(gyms[3].sum())
    return truncs


@pytest.mark.parametrize("seed", [0, 7])
def test_cartpole_make_vec_is_gymnasiums(seed):
    n = 8
    theirs = gym.make_vec("CartPole-v1", num_envs=n)
    assert type(theirs).__name__ == "CartPoleVectorEnv"
    _run(envs.make_vec("CartPole-v1", n), theirs, 1200,
         lambda rng: rng.integers(0, 2, size=n), seed)


def test_cartpole_truncation_and_autoreset_rows():
    from gymnasium.envs.classic_control.cartpole import CartPoleVectorEnv

    n = 8
    truncs = _run(envs.CartPoleVectorEnv(num_envs=n, max_episode_steps=20),
                  CartPoleVectorEnv(num_envs=n, max_episode_steps=20), 400,
                  lambda rng: rng.integers(0, 2, size=n), 3)
    assert truncs > 0


@pytest.mark.parametrize("seed", [0, 11])
def test_pendulum_make_vec_is_gymnasiums(seed):
    n = 3
    theirs = gym.make_vec("Pendulum-v1", num_envs=n)
    truncs = _run(envs.make_vec("Pendulum-v1", n), theirs, 450,
                  lambda rng: rng.uniform(-3.0, 3.0, size=(n, 1)).astype(np.float32), seed)
    assert truncs == 2 * n  # two 200-step limits, each env


def test_spaces_are_gymnasiums():
    for name in envs.ENV_NAMES:
        obs_space, act_space = envs.spaces(name)
        probe = gym.make(name)
        assert obs_space.shape == probe.observation_space.shape
        np.testing.assert_array_equal(obs_space.low, probe.observation_space.low)
        np.testing.assert_array_equal(obs_space.high, probe.observation_space.high)
        if hasattr(probe.action_space, "n"):
            assert act_space.n == probe.action_space.n
        else:
            assert act_space.shape == probe.action_space.shape
            np.testing.assert_array_equal(act_space.low, probe.action_space.low)
            np.testing.assert_array_equal(act_space.high, probe.action_space.high)
        probe.close()


def test_unknown_name_raises_naming_the_two():
    for bad in ("MountainCar-v0", "CartPole-v0"):
        with pytest.raises(ValueError, match="CartPole-v1.*Pendulum-v1"):
            envs.make_vec(bad, 2)
        with pytest.raises(ValueError, match="CartPole-v1.*Pendulum-v1"):
            envs.spaces(bad)
