"""Learning-regression gates: tuned configs with pass/fail reward targets
(the counterpart of ray_tpu/rl/tuned_examples.py, with the same configs and
targets; each factory and `run_regression` take the learner's `device`,
CUDA unless "cpu").

Re-design of the reference's tuned_examples (reference:
rllib/tuned_examples/ yaml configs executed as bazel CI tests,
rllib/BUILD:156-166 — "learning_tests" that FAIL the build when an
algorithm stops reaching its known reward). Each entry pairs a tuned
config factory with the stop criteria: target episode return, an env-step
budget, and a wall-clock cap; `run_regression` trains until the first of
those trips and reports pass/fail.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict


@dataclasses.dataclass
class RegressionSpec:
    name: str
    build: Callable[..., Any]  # (device=None) -> algorithm with .train() -> metrics dict
    target_return: float
    max_env_steps: int
    max_seconds: float
    # Mean over this many recent episodes must cross the target.
    metric: str = "episode_return_mean"


def _ppo_cartpole(device=None):
    from .ppo import PPOConfig

    return (
        PPOConfig()
        .environment("CartPole-v1")
        .env_runners(2, num_envs_per_runner=8)
        .training(
            rollout_length=64,
            lr=3e-4,
            num_epochs=6,
            minibatch_size=256,
            entropy_coeff=0.005,
            device=device,
        )
        .build()
    )


def _appo_cartpole(device=None):
    from .appo import APPOConfig

    cfg = APPOConfig(
        env="CartPole-v1",
        num_env_runners=2,
        num_envs_per_runner=8,
        rollout_length=64,
        lr=5e-4,
        entropy_coeff=0.003,
        clip_param=0.3,
        device=device,
    )
    return cfg.build()


def _dqn_cartpole(device=None):
    from .dqn import DQNConfig

    cfg = DQNConfig(
        env="CartPole-v1",
        buffer_capacity=100_000,
        train_batch_size=128,
        updates_per_iteration=64,
        target_update_freq=500,
        epsilon_decay_steps=20_000,
        lr=1e-3,
        device=device,
    )
    return cfg.build()


def _sac_pendulum(device=None):
    from .sac import SACConfig

    cfg = SACConfig(env="Pendulum-v1", device=device)
    return cfg.build()


REGRESSIONS: Dict[str, RegressionSpec] = {
    "ppo_cartpole": RegressionSpec(
        "ppo_cartpole", _ppo_cartpole, target_return=475.0,
        max_env_steps=600_000, max_seconds=420.0,
    ),
    "appo_cartpole": RegressionSpec(
        "appo_cartpole", _appo_cartpole, target_return=450.0,
        max_env_steps=1_500_000, max_seconds=420.0,
    ),
    "dqn_cartpole": RegressionSpec(
        "dqn_cartpole", _dqn_cartpole, target_return=450.0,
        max_env_steps=50_000_000, max_seconds=480.0,
    ),
    "sac_pendulum": RegressionSpec(
        "sac_pendulum", _sac_pendulum, target_return=-250.0,
        max_env_steps=50_000_000, max_seconds=600.0,
    ),
}


def run_regression(name: str, verbose: bool = False, device=None) -> Dict[str, Any]:
    """Trains `name` until target / step budget / wall cap; returns
    {"passed", "best_return", "env_steps", "seconds", "iterations"}."""
    spec = REGRESSIONS[name]
    algo = spec.build(device=device)
    t0 = time.monotonic()
    best = float("-inf")
    env_steps = 0
    iters = 0
    try:
        while True:
            metrics = algo.train()
            iters += 1
            env_steps += int(metrics.get("num_env_steps_sampled", 0) or 0)
            r = metrics.get(spec.metric)
            if r is not None and r == r:  # not NaN
                best = max(best, float(r))
            elapsed = time.monotonic() - t0
            if verbose and iters % 10 == 0:
                print(  # console-output: explicit verbose=True progress
                    f"[{spec.name}] iter={iters} steps={env_steps} "
                    f"return={r} best={best:.1f} t={elapsed:.0f}s",
                    flush=True,
                )
            if best >= spec.target_return:
                break
            if env_steps >= spec.max_env_steps or elapsed >= spec.max_seconds:
                break
    finally:
        stop = getattr(algo, "stop", None)
        if callable(stop):
            try:
                stop()
            except Exception:  # lint: swallow-ok(best-effort algo stop after the run completed)
                pass
    return {
        "passed": best >= spec.target_return,
        "best_return": best,
        "env_steps": env_steps,
        "seconds": round(time.monotonic() - t0, 1),
        "iterations": iters,
        "target": spec.target_return,
    }
