"""The port's learning-regression gates: tests/test_rl_learning.py's four
tuned examples (ray_tpu_torch/rl/tuned_examples.py: PPO CartPole 475, APPO
CartPole 450, DQN CartPole 450, SAC Pendulum -250) with their wall-clock
caps, on the port's runtime with the learners on the CPU. The slow tier, as
tests/test_rl_learning.py is; RAY_TPU_SKIP_LEARNING_TESTS=1 skips them.
"""

import os

import pytest

pytestmark = pytest.mark.slow

skip_learning = pytest.mark.skipif(
    os.environ.get("RAY_TPU_SKIP_LEARNING_TESTS") == "1",
    reason="RAY_TPU_SKIP_LEARNING_TESTS=1",
)


@pytest.fixture
def rt():
    import ray_tpu_torch as rtpu

    rtpu.shutdown()
    rtpu.init(local_mode=True, num_cpus=8)
    yield rtpu
    rtpu.shutdown()


def _gate(name: str):
    from ray_tpu_torch.rl.tuned_examples import run_regression

    result = run_regression(name, verbose=True, device="cpu")
    assert result["passed"], (
        f"{name} failed its learning gate: best={result['best_return']:.1f} "
        f"target={result['target']} after {result['env_steps']} env steps "
        f"/ {result['seconds']}s / {result['iterations']} iters"
    )


@skip_learning
@pytest.mark.parametrize("name", ["ppo_cartpole", "appo_cartpole", "dqn_cartpole",
                                  "sac_pendulum"])
def test_learning_gate(rt, name):
    _gate(name)
