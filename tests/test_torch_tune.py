"""The port's Tune (ray_tpu_torch.tune) side by side with the JAX package's.

tests/test_tune.py's nine cases run on both packages' `init(local_mode=True)`
and on a cluster of each, whose trials are actors in worker processes
(tests/torch_modes.py), with the same objectives and assertions (the
trainer-wrapping case wraps a TorchTrainer with ScalingConfig(use_gpu=False)
on the port's side). Across the packages, seeded searchers suggest the same
trial configs, and ASHA, the median stopping rule and PBT, fed the same
results, make the same decisions (PBT exploits the same source trial with
the same perturbed config). Every wait has a deadline
(tests/torch_waits.py).
"""

import importlib
import json
import os
import sys
import tempfile
import threading
import time
import types

import pytest

import cloudpickle

import ray_tpu
import ray_tpu_torch
import torch_modes
from ray_tpu_torch.core import serialization
from torch_waits import bounded

# The trial functions below are module-level: on a cluster both packages
# send them by value to worker processes that cannot import this file.
serialization.register_pickle_by_value(sys.modules[__name__])
cloudpickle.register_pickle_by_value(sys.modules[__name__])

PACKAGES = ("jax", "torch")
FIT_TIMEOUT = 120.0


def _ns(name):
    if name == "jax":
        from ray_tpu import train, tune
        from ray_tpu.parallel import MeshSpec

        return types.SimpleNamespace(
            rt=ray_tpu, train=train, tune=tune, Trainer=train.JaxTrainer, gpu_kw={},
            scaling=lambda: train.ScalingConfig(num_workers=1, mesh=MeshSpec(data=-1)))
    from ray_tpu_torch import train, tune
    from ray_tpu_torch.parallel import MeshSpec

    return types.SimpleNamespace(
        rt=ray_tpu_torch, train=train, tune=tune, Trainer=train.TorchTrainer,
        gpu_kw={"use_gpu": False},
        scaling=lambda: train.ScalingConfig(num_workers=1, use_gpu=False,
                                            mesh=MeshSpec(data=-1)))


@pytest.fixture(autouse=True)
def _jax_flight_ring_left_as_found():
    """The JAX trainer records its restores in the JAX package's
    process-wide flight ring, and tests/test_chaos.py, when it runs later in
    the same worker, orders a restore by the earliest one in that ring: put
    the ring's slots back as they were."""
    from ray_tpu.observability import flight_recorder as frec

    saved = list(frec.RECORDER._buf)
    yield
    frec.RECORDER._buf[:] = saved


@pytest.fixture(scope="module")
def clusters():
    booted = torch_modes.Clusters(num_cpus=8)
    try:
        yield booted
    finally:
        booted.shutdown()


@pytest.fixture(params=torch_modes.PARAMS, ids=torch_modes.IDS)
def pkg(request):
    name, mode = request.param
    clusters = request.getfixturevalue("clusters") if mode == "cluster" else None
    with torch_modes.runtime_for(clusters, name, mode, num_cpus=8):
        ns = _ns(name)
        ns.name, ns.mode = name, mode
        yield ns


def _fit(tuner):
    return bounded(tuner.fit, FIT_TIMEOUT)


# ----------------------------------------------------- tests/test_tune.py


@pytest.mark.parametrize("name", PACKAGES)
def test_grid_and_random_spaces(name):
    s = _ns(name).tune.search
    gen = s.BasicVariantGenerator(
        {"a": s.grid_search([1, 2, 3]), "b": s.uniform(0.0, 1.0), "c": s.choice(["x", "y"]),
         "d": 7},
        num_samples=2,
        seed=0,
    )
    cfgs = [gen.suggest(f"t{i}") for i in range(gen.total_trials)]
    assert len(cfgs) == 6  # 3 grid values x 2 samples
    assert gen.suggest("extra") is None
    assert {c["a"] for c in cfgs} == {1, 2, 3}
    assert all(0.0 <= c["b"] <= 1.0 and c["c"] in ("x", "y") and c["d"] == 7 for c in cfgs)


def _quadratic(config):
    tune = importlib.import_module(config["tune"])
    tune.report({"score": -((config["x"] - 3) ** 2)})


def test_tuner_grid_search_end_to_end(pkg, tmp_path):
    tune = pkg.tune
    grid = tune.Tuner(
        _quadratic,
        param_space={"x": tune.grid_search([0, 1, 2, 3, 4, 5]), "tune": tune.__name__},
        tune_config=tune.TuneConfig(metric="score", mode="max", **pkg.gpu_kw),
        run_config=pkg.train.RunConfig(name="quad", storage_path=str(tmp_path)),
    )
    results = _fit(grid)
    assert len(results) == 6
    assert not results.errors
    assert results.get_best_result().metrics["score"] == 0  # x == 3


def _climb(config):
    tune = importlib.import_module(config["tune"])
    for step in range(20):
        tune.report({"acc": config["quality"] * (step + 1)})


def test_asha_stops_bad_trials(pkg, tmp_path):
    tune = pkg.tune
    # Strong trials launch first (max_concurrent=2), filling the rungs; the
    # weak trials then arrive below the recorded cutoffs and stop early.
    results = _fit(tune.Tuner(
        _climb,
        param_space={"quality": tune.grid_search([1.0, 0.5, 0.02, 0.01]),
                     "tune": tune.__name__},
        tune_config=tune.TuneConfig(
            metric="acc", mode="max", max_concurrent_trials=2, **pkg.gpu_kw,
            scheduler=tune.ASHAScheduler(metric="acc", mode="max", grace_period=2,
                                         reduction_factor=2, max_t=20),
        ),
        run_config=pkg.train.RunConfig(name="asha", storage_path=str(tmp_path)),
    ))
    iters = {r.metrics["trial_id"]: r.metrics["training_iteration"] for r in results}
    assert max(iters.values()) >= 19
    assert min(iters.values()) < 19


def _accumulate(config):
    tune = importlib.import_module(config["tune"])
    train = importlib.import_module(config["train"])
    ck = tune.get_checkpoint()
    w = float(train.load_pytree(ck.path)["w"]) if ck else 0.0
    for _ in range(12):
        time.sleep(config["pause"])
        w += config["lr"]
        d = tempfile.mkdtemp(prefix="pbt-")
        train.save_pytree({"w": w}, d)
        tune.report({"w": w}, checkpoint=train.Checkpoint(d))


def test_pbt_exploits_checkpoints(pkg, tmp_path):
    tune = pkg.tune
    pbt = tune.PopulationBasedTraining(
        metric="w", mode="max", perturbation_interval=3,
        hyperparam_mutations={"lr": tune.uniform(0.5, 1.0)}, seed=0,
    )
    results = _fit(tune.Tuner(
        _accumulate,
        # A trial exploits a peer only while both run: on a cluster each
        # starts in its own worker process, so their steps are paced to
        # overlap whatever the start-up times.
        param_space={"lr": tune.grid_search([0.001, 1.0]), "tune": tune.__name__,
                     "train": pkg.train.__name__,
                     "pause": 0.25 if pkg.mode == "cluster" else 0.0},
        tune_config=tune.TuneConfig(metric="w", mode="max", scheduler=pbt, **pkg.gpu_kw),
        run_config=pkg.train.RunConfig(name="pbt", storage_path=str(tmp_path)),
    ))
    assert not results.errors
    # The weak trial was pulled up by exploiting the strong one's
    # checkpoint: 12 * 0.001 alone could not pass 1.0.
    assert sorted(r.metrics["w"] for r in results)[0] > 1.0


def _scaled(config):
    train = importlib.import_module(config["train"])
    train.report({"final": config["scale"] * 10})


def test_tuner_wraps_the_trainer(pkg, tmp_path):
    """A JaxTrainer / TorchTrainer as the trainable: one fit per config."""
    tune = pkg.tune
    trainer = pkg.Trainer(
        _scaled,
        train_loop_config={"train": pkg.train.__name__},
        scaling_config=pkg.scaling(),
        run_config=pkg.train.RunConfig(storage_path=str(tmp_path / "inner")),
    )
    results = _fit(tune.Tuner(
        trainer,
        param_space={"scale": tune.grid_search([1, 5])},
        tune_config=tune.TuneConfig(metric="final", mode="max"),
        run_config=pkg.train.RunConfig(name="wrap", storage_path=str(tmp_path)),
    ))
    assert len(results) == 2
    assert results.get_best_result().metrics["final"] == 50


def _constant(config):
    tune = importlib.import_module(config["tune"])
    tune.report({"v": 1})


def test_experiment_state_saved(pkg, tmp_path):
    tune = pkg.tune
    _fit(tune.Tuner(
        _constant,
        param_space={"x": tune.grid_search([1, 2]), "tune": tune.__name__},
        tune_config=tune.TuneConfig(**pkg.gpu_kw),
        run_config=pkg.train.RunConfig(name="state", storage_path=str(tmp_path)),
    ))
    state = json.loads((tmp_path / "state" / "experiment_state.json").read_text())
    assert len(state["trials"]) == 2
    assert all(t["status"] == "TERMINATED" for t in state["trials"])


def test_function_trial_without_cuda_fails_unless_asked_for_the_cpu(tmp_path):
    """A function trial's mesh follows TuneConfig.use_gpu (default True): on
    a machine without a CUDA device the trial errors instead of training on
    the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this checks the refusal on a machine without a CUDA device")
    tune = _ns("torch").tune
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(local_mode=True, num_cpus=2)
    try:
        assert tune.TuneConfig().use_gpu
        results = _fit(tune.Tuner(
            _constant, param_space={"tune": tune.__name__},
            run_config=_ns("torch").train.RunConfig(name="gpu", storage_path=str(tmp_path)),
        ))
        assert len(results.errors) == 1
        assert "no CUDA device" in str(results.errors[0])
    finally:
        ray_tpu_torch.shutdown()


def _hundredfold(config):
    tune = importlib.import_module(config["tune"])
    tune.report({"v": config["x"] * 100})


def test_tuner_restore_resumes_unfinished(pkg, tmp_path):
    """Terminated trials keep their results; unfinished trials relaunch."""
    tune = pkg.tune
    exp_dir = tmp_path / "resume_me"
    os.makedirs(exp_dir)
    state = {
        "name": "resume_me", "metric": "v", "mode": "max",
        "trials": [
            {"trial_id": "trial_00000", "config": {"x": 1, "tune": tune.__name__},
             "status": "TERMINATED", "last_result": {"v": 100, "trial_id": "trial_00000"},
             "iterations": 1, "error": None, "checkpoint_index": 0,
             "latest_checkpoint": None},
            {"trial_id": "trial_00001", "config": {"x": 7, "tune": tune.__name__},
             "status": "RUNNING", "last_result": {}, "iterations": 0, "error": None,
             "checkpoint_index": 0, "latest_checkpoint": None},
        ],
    }
    (exp_dir / "experiment_state.json").write_text(json.dumps(state))
    results = _fit(tune.Tuner.restore(str(exp_dir), _hundredfold, **pkg.gpu_kw))
    assert len(results) == 2
    by_id = {r.metrics.get("trial_id"): r.metrics for r in results}
    assert by_id["trial_00000"]["v"] == 100  # carried over, not re-run
    assert by_id["trial_00001"]["v"] == 700  # resumed and completed


def _tpe_run(name):
    """60 TPE suggestions on a quadratic with a categorical penalty; returns
    the configs and losses."""
    s = _ns(name).tune.search
    searcher = s.TPESearcher(
        {"x": s.uniform(-1.0, 1.0), "y": s.uniform(-1.0, 1.0), "kind": s.choice(["a", "b"])},
        metric="loss", mode="min", num_samples=60, n_startup_trials=12, seed=3,
    )
    cfgs, losses = [], []
    for i in range(60):
        cfg = searcher.suggest(f"t{i}")
        assert cfg is not None
        loss = (cfg["x"] - 0.6) ** 2 + (cfg["y"] + 0.4) ** 2 + (0.0 if cfg["kind"] == "a" else 0.5)
        cfgs.append(cfg)
        losses.append(loss)
        searcher.on_trial_complete(f"t{i}", {"loss": loss})
    assert searcher.suggest("overflow") is None  # num_samples exhausted
    return cfgs, losses


@pytest.mark.parametrize("name", PACKAGES)
def test_tpe_searcher_concentrates(name):
    _, losses = _tpe_run(name)
    early, late = losses[:12], losses[12:]
    assert min(late) <= 0.12, min(late)
    assert sum(late) / len(late) < 0.3 * (sum(early) / len(early))
    assert sum(1 for v in late if v < 0.5) > len(late) * 0.6


def _tpe_objective(config):
    tune = importlib.import_module(config["tune"])
    tune.report({"score": -((config["lr"] - 0.3) ** 2)})


def test_tpe_with_tuner_end_to_end(pkg, tmp_path):
    tune = pkg.tune
    space = {"lr": tune.uniform(0.0, 1.0), "tune": tune.__name__}
    results = _fit(tune.Tuner(
        _tpe_objective,
        param_space=space,
        tune_config=tune.TuneConfig(
            metric="score", mode="max", **pkg.gpu_kw,
            search_alg=tune.TPESearcher(space, metric="score", mode="max", num_samples=25,
                                        n_startup_trials=8, seed=3),
        ),
        run_config=pkg.train.RunConfig(name="tpe", storage_path=str(tmp_path)),
    ))
    assert len(results) == 25 and not results.errors
    assert results.get_best_result().metrics["score"] > -0.01


# ------------------------------------------------- the same decisions in both


def test_seeded_searchers_suggest_the_same_configs():
    def variants(name):
        s = _ns(name).tune.search
        gen = s.BasicVariantGenerator(
            {"a": s.grid_search([1, 2, 3]), "b": s.loguniform(1e-4, 1e-1),
             "c": s.choice(["x", "y", "z"]), "d": s.randint(0, 100), "e": s.lograndint(1, 64),
             "f": s.quniform(0.0, 1.0, 0.125)},
            num_samples=4, seed=11,
        )
        return [gen.suggest(f"t{i}") for i in range(gen.total_trials)]

    assert variants("jax") == variants("torch")
    assert _tpe_run("jax") == _tpe_run("torch")


def _schedule(name, make, results):
    sch = make(_ns(name).tune)
    return [sch.on_result(tid, dict(r)) for tid, r in results]


def test_schedulers_decide_alike():
    """ASHA, the median stopping rule and PBT, fed one interleaved stream
    of results from four trials, stop the same trials at the same results
    and exploit the same checkpoints with the same perturbed configs."""
    quality = {"t0": 1.0, "t1": 0.5, "t2": 0.02, "t3": 0.01}
    results = [(tid, {"acc": q * (it + 1), "training_iteration": it + 1})
               for it in range(20) for tid, q in quality.items()]

    def pbt(tune):
        sch = tune.PopulationBasedTraining(
            metric="acc", mode="max", perturbation_interval=3,
            hyperparam_mutations={"lr": tune.uniform(0.5, 1.0), "wd": [0.0, 0.1]}, seed=0)
        for tid, q in quality.items():
            sch.register_config(tid, {"lr": q, "wd": 0.0})
        return sch

    makers = {
        "asha": lambda tune: tune.ASHAScheduler(metric="acc", mode="max", grace_period=2,
                                                reduction_factor=2, max_t=20),
        "median": lambda tune: tune.schedulers.MedianStoppingRule(metric="acc", mode="max",
                                                                  grace_period=2),
        "pbt": pbt,
    }
    for kind, make in makers.items():
        jd, td = _schedule("jax", make, results), _schedule("torch", make, results)
        norm = [d if isinstance(d, str) else ("EXPLOIT", d.source_trial_id, d.new_config)
                for d in td]
        assert norm == [d if isinstance(d, str) else ("EXPLOIT", d.source_trial_id,
                                                      d.new_config) for d in jd], kind
        assert any(d != "CONTINUE" for d in norm), kind  # each one did decide something


# -------------------------------------------------------- the launch counter


def test_kernel_launch_counts_add_up_across_threads():
    """Two Tune trials on one card launch the same kernels from two threads:
    no count may be lost (more threads than cores, a short switch
    interval)."""
    from ray_tpu_torch.ops import flash_attention as fa

    n_threads, per_thread = 16, 2000
    old_interval, old_count = sys.getswitchinterval(), fa.flash_fwd.launches
    sys.setswitchinterval(1e-6)
    try:
        fa.flash_fwd.launches = 0
        threads = [threading.Thread(
            target=lambda: [fa._count_launch(fa.flash_fwd) for _ in range(per_thread)])
            for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert fa.flash_fwd.launches == n_threads * per_thread
    finally:
        sys.setswitchinterval(old_interval)
        fa.flash_fwd.launches = old_count
