"""The port's membership soak (ray_tpu_torch/chaos/soak.py) with the trainer
arm and the command line of tools/chaos_soak.py: a seeded campaign with an
elastic TorchTrainer whose history must equal the fault-free golden run,
the golden run against the JAX tool's, the loop through TorchTrainer in
process, and `main` (`python -m ray_tpu_torch.chaos.soak`) with its exit
codes. Cases that boot a cluster run under torch_modes.case_time_limit, as
tests/test_torch_partition.py's do.
"""

import importlib
import os
import sys

import pytest

import torch_modes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

SOAK_SEED = int(os.environ.get("RAY_TPU_CHAOS_SEED", "1030") or 1030)
CLUSTER_LIMIT_S = 240
UNIT_LIMIT_S = 60


@pytest.fixture
def cluster_limit(request, monkeypatch):
    # The campaign's settings, put back after the case.
    monkeypatch.setenv("RAY_TPU_HEARTBEAT_INTERVAL_S", "0.25")
    monkeypatch.setenv("RAY_TPU_HEARTBEAT_TIMEOUT_S", "1.5")
    monkeypatch.setenv("RAY_TPU_CHAOS_SEED", str(SOAK_SEED))
    importlib.import_module("ray_tpu_torch").shutdown()
    with torch_modes.case_time_limit(request, CLUSTER_LIMIT_S):
        yield


@pytest.fixture
def unit_limit(request):
    with torch_modes.case_time_limit(request, UNIT_LIMIT_S):
        yield


def test_soak_with_trainer_arm(cluster_limit):
    """A 25-second seeded campaign: partition, heal, kill and preempt events
    against the counter, the task workload and an elastic trainer; every
    invariant holds and the trainer's history is the golden run's."""
    from ray_tpu_torch.chaos.soak import run_soak

    result = run_soak(SOAK_SEED, 25.0, nodes=2, event_period_s=1.5, use_trainer=True)
    assert result.ok, f"soak violations: {result.summary()}\n{result.events}"
    assert result.trainer_ok is True, result.summary()
    assert "trainer_ok=True" in result.summary()
    assert len(result.ops_acked) > 25, result.summary()
    assert result.task_rounds > 5, result.summary()


@pytest.mark.parametrize("n_steps", [1, 20, 57])
def test_golden_trajectory_matches_the_jax_tool(n_steps):
    from ray_tpu_torch.chaos.soak import _golden_trajectory

    jax_tool = importlib.import_module("tools.chaos_soak")
    golden = _golden_trajectory(n_steps)
    assert golden == jax_tool._golden_trajectory(n_steps)
    assert [step for step, _ in golden] == list(range(n_steps))


def test_deterministic_loop_resumes_onto_the_golden_run(unit_limit, tmp_path):
    """The trainer arm's loop through TorchTrainer in process, once without a
    fault and once failing after a checkpoint: both histories are the golden
    run's, every step once."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import train
    from ray_tpu_torch.chaos import soak

    n_steps = 12
    fail_marker = tmp_path / "failed_once"

    def failing_loop(config):
        ckpt = train.get_checkpoint()
        if ckpt is None:
            # Steps 0-4, then a crash: the retry resumes from step 4's checkpoint.
            soak._train_loop(5, 0.0, config)
            fail_marker.write_text("1")
            raise RuntimeError("planted failure after step 4")
        soak._train_loop(n_steps, 0.0, config)

    rt.shutdown()
    rt.init(local_mode=True, num_cpus=2)
    try:
        histories = {}
        for name, loop in (("clean", soak._deterministic_train_loop(n_steps, 0.0)),
                           ("failing", failing_loop)):
            result = train.TorchTrainer(
                loop, scaling_config=train.ScalingConfig(num_workers=1, use_gpu=False),
                run_config=train.RunConfig(name=name, storage_path=str(tmp_path),
                                           failure_config=train.FailureConfig(max_failures=2)),
            ).fit()
            assert result.error is None, result.error
            histories[name] = [tuple(x) for x in result.checkpoint.to_dict()["history"]]
    finally:
        rt.shutdown()
    assert fail_marker.exists()
    golden = soak._golden_trajectory(n_steps)
    assert histories == {"clean": golden, "failing": golden}


def test_trainer_waits_for_capacity_when_its_gang_cannot_be_placed(cluster_limit, tmp_path):
    """No node offers the gang's resource when fit() starts, and one joins 2 s
    later: an attempt that cannot be placed is a capacity event, retried after
    the wait for capacity on the preemption budget, so fit() succeeds with
    max_failures=0 instead of failing at once (the soak's trainer arm spent
    max_failures=8 in bursts of SchedulingErrors and RpcUnavailableErrors while
    its nodes were down or cut off)."""
    import threading

    import ray_tpu_torch as rt
    from ray_tpu_torch import train
    from ray_tpu_torch.chaos import soak
    from ray_tpu_torch.core import runtime_base
    from ray_tpu_torch.core.cluster_runtime import Cluster

    cluster = torch_modes.boot_cluster(Cluster, num_cpus=2, num_gpus=0)
    runtime = cluster.runtime()
    runtime_base.set_runtime(runtime)
    try:
        joined = threading.Timer(2.0, lambda: cluster.add_node(
            num_cpus=2, resources={"train_slot": 1.0}))
        joined.start()
        result = train.TorchTrainer(
            soak._deterministic_train_loop(5, 0.0),
            scaling_config=train.ScalingConfig(
                num_workers=1, resources_per_worker={"train_slot": 1.0}, use_gpu=False),
            run_config=train.RunConfig(name="placement", storage_path=str(tmp_path),
                                       failure_config=train.FailureConfig(max_failures=0)),
        ).fit()
        joined.join(30)
        assert result.error is None, result.error
        history = [tuple(x) for x in result.checkpoint.to_dict()["history"]]
        assert history == soak._golden_trajectory(5)
        assert result.metrics["goodput_seconds"]["drain_wait"] > 0
    finally:
        torch_modes.shutdown_cluster(cluster, runtime.shutdown)
        rt.shutdown()


def test_trainer_fails_within_the_capacity_wait_when_no_node_can_host_its_gang(
        cluster_limit, tmp_path):
    """No node offers the gang's resource and none joins: the attempt that
    cannot be placed waits out capacity_wait_s once, then fit() fails with
    CapacityTimeoutError caused by the SchedulingError, with max_failures=0
    and without relaunching a doomed gang."""
    import time

    import ray_tpu_torch as rt
    from ray_tpu_torch import exceptions as exc
    from ray_tpu_torch import train
    from ray_tpu_torch.chaos import soak
    from ray_tpu_torch.core import runtime_base
    from ray_tpu_torch.core.cluster_runtime import Cluster

    wait_s = 3.0
    cluster = torch_modes.boot_cluster(Cluster, num_cpus=2, num_gpus=0)
    runtime = cluster.runtime()
    runtime_base.set_runtime(runtime)
    try:
        t0 = time.monotonic()
        result = train.TorchTrainer(
            soak._deterministic_train_loop(5, 0.0),
            scaling_config=train.ScalingConfig(
                num_workers=1, resources_per_worker={"train_slot": 1.0}, use_gpu=False,
                capacity_wait_s=wait_s),
            run_config=train.RunConfig(name="infeasible", storage_path=str(tmp_path),
                                       failure_config=train.FailureConfig(max_failures=0)),
        ).fit()
        elapsed = time.monotonic() - t0
        assert isinstance(result.error, exc.CapacityTimeoutError), repr(result.error)
        assert isinstance(result.error.__cause__, exc.SchedulingError), \
            repr(result.error.__cause__)
        assert result.checkpoint is None
        assert wait_s <= result.metrics["goodput_seconds"]["drain_wait"] < elapsed
        assert elapsed < wait_s + 30.0, elapsed
    finally:
        torch_modes.shutdown_cluster(cluster, runtime.shutdown)
        rt.shutdown()


def test_soak_cli_runs_a_short_campaign(cluster_limit, capsys):
    from ray_tpu_torch.chaos.soak import main

    rc = main(["--seed", str(SOAK_SEED), "--duration", "8", "--nodes", "2", "--trainer"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert f"soak[{SOAK_SEED}]:" in out and "trainer_ok=True" in out, out


def test_soak_cli_exit_code_follows_the_invariants(unit_limit, monkeypatch, capsys):
    from ray_tpu_torch.chaos import soak

    seen = {}

    def fake_run_soak(seed, duration_s, **kwargs):
        seen.update(seed=seed, duration_s=duration_s, **kwargs)
        result = soak.SoakResult()
        result.violations.append("planted violation")
        return result

    monkeypatch.setattr(soak, "run_soak", fake_run_soak)
    assert soak.main(["--seed", "7", "--duration", "3", "--event-period", "0.5"]) == 1
    assert seen == {"seed": 7, "duration_s": 3.0, "nodes": 2, "event_period_s": 0.5,
                    "use_trainer": False}
    assert "planted violation" in capsys.readouterr().out
