"""The port's trainer (ray_tpu_torch.train.TorchTrainer) side by side with
the JAX package's JaxTrainer.

Every runtime case runs on both packages' `init(local_mode=True)`, with
the same loop, the same seeded numpy inputs and the same assertions:
tests/test_train.py's runtime cases (keep-K manager, worker group execute,
MLP end-to-end fit, failure then resume, sessions not crosswired),
tests/test_metrics_history.py's trainer telemetry cases (goodput ledger,
MFU helper, goodput/MFU/phases in the result, flops_per_token feeding
MFU), tests/test_elastic.py's goodput weighting and
tests/test_data_plane.py's unknown dataset_config. The port runs with
ScalingConfig(use_gpu=False) on one CPU device; the JAX package on its
8-device CPU mesh.

Cross-package agreement, each with its tolerance:
  - the MLP fit from the same weights (JAX's init_params, carried over by
    models/convert.py): every loss and the final checkpoint within 1e-5
    (fp32; JAX sums the batch over 8 devices, the port over one);
  - a 2-layer `tiny` transformer, 3 AdamW steps in each trainer (JAX's
    build_train_step with optax at `highest` matmul precision, its flash
    kernel in interpret mode): the first loss within 1e-5 absolute, the
    trajectory within 1e-5 relative, tests/test_torch_train.py's
    tolerances.
The port's failure-then-resume of that transformer must equal an
uninterrupted port run bit for bit. Every wait has a deadline
(tests/torch_waits.py).
"""

import gc
import hashlib
import importlib
import os
import tempfile
import time
import types
import weakref

import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch
from torch_waits import bounded

PACKAGES = ("jax", "torch")
LOSS_TOL = 1e-5
TRAJECTORY_RTOL = 1e-5
FIT_TIMEOUT = 120.0


def _ns(name):
    """The package's runtime, trainer class and a CPU ScalingConfig maker."""
    if name == "jax":
        from ray_tpu import train, tune
        from ray_tpu.observability import goodput
        from ray_tpu.parallel import MeshSpec

        return types.SimpleNamespace(
            rt=ray_tpu, train=train, tune=tune, goodput=goodput, Trainer=train.JaxTrainer,
            scaling=lambda n=1: train.ScalingConfig(num_workers=n, mesh=MeshSpec(data=-1)))
    from ray_tpu_torch import train, tune
    from ray_tpu_torch.observability import goodput
    from ray_tpu_torch.parallel import MeshSpec

    return types.SimpleNamespace(
        rt=ray_tpu_torch, train=train, tune=tune, goodput=goodput, Trainer=train.TorchTrainer,
        scaling=lambda n=1: train.ScalingConfig(num_workers=n, use_gpu=False,
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


@pytest.fixture(params=PACKAGES)
def pkg(request):
    ns = _ns(request.param)
    ns.name = request.param
    ns.rt.shutdown()
    ns.rt.init(local_mode=True, num_cpus=8)
    try:
        yield ns
    finally:
        ns.rt.shutdown()


def _fit(trainer):
    return bounded(trainer.fit, FIT_TIMEOUT)


# ------------------------------------------------------------ the mesh layout


@pytest.mark.parametrize("kw,n", [({}, 1), ({}, 8), ({"tensor": 2}, 8),
                                  ({"data": 2, "fsdp": -1, "seq": 2}, 8),
                                  ({"data": 3}, 8), ({"data": -1, "tensor": -1}, 8),
                                  ({"tensor": 3}, 8)])
def test_mesh_spec_resolves_as_jax(kw, n):
    from ray_tpu.parallel.mesh import MeshSpec as JSpec

    from ray_tpu_torch.parallel.mesh import AXIS_ORDER, MeshSpec

    assert AXIS_ORDER == ray_tpu.parallel.mesh.AXIS_ORDER
    try:
        want = JSpec(**kw).resolve(n)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e).split(" ")[0]):
            MeshSpec(**kw).resolve(n)
        return
    assert MeshSpec(**kw).resolve(n) == want


def test_build_mesh_on_the_cpu():
    from ray_tpu_torch.parallel.mesh import build_mesh

    mesh = build_mesh(use_gpu=False)
    assert mesh.devices.shape == (1,) * 6 and mesh.devices.size == 1
    assert mesh.devices.flat[0] == torch.device("cpu")
    assert mesh.axis_names == ("data", "fsdp", "stage", "expert", "seq", "tensor")
    with pytest.raises(ValueError, match="do not cover"):
        build_mesh({"data": 2}, use_gpu=False)


# ------------------------------------------------- tests/test_train.py cases


@pytest.mark.parametrize("name", PACKAGES)
def test_checkpoint_manager_keep_k(name, tmp_path):
    train = _ns(name).train
    mgr = train.CheckpointManager(num_to_keep=2, score_attribute="acc", score_order="max")
    paths = []
    for i, acc in enumerate([0.1, 0.9, 0.5, 0.2]):
        d = tmp_path / f"ck{i}"
        d.mkdir()
        (d / "x").write_text(str(i))
        mgr.register(train.Checkpoint(str(d)), {"acc": acc})
        paths.append(str(d))
    kept = {c.path for c in mgr.checkpoints}
    assert kept == {str(tmp_path / "ck1"), str(tmp_path / "ck2")}
    assert not os.path.exists(paths[0]) and not os.path.exists(paths[3])
    assert mgr.best_checkpoint.path == str(tmp_path / "ck1")
    assert mgr.latest_checkpoint.path == str(tmp_path / "ck2")


def _thread_name():
    import threading

    return threading.current_thread().name


def test_worker_group_execute(pkg):
    group = pkg.train.WorkerGroup(num_workers=2)
    try:
        names = bounded(lambda: group.execute(_thread_name), 30)
        assert len(names) == 2 and all(isinstance(n, str) for n in names)
        assert bounded(lambda: group.execute_single(1, lambda x: x + 1, 41), 30) == 42
    finally:
        group.shutdown()


def _mlp_inputs():
    """JAX's MLP init (seed 0) as numpy, and a seeded batch of 64 x 8."""
    import jax

    from ray_tpu.models import mlp

    cfg = mlp.MLPConfig(in_dim=8, hidden=(32,), n_classes=4)
    params = jax.tree_util.tree_map(np.asarray, mlp.init_params(jax.random.PRNGKey(0), cfg))
    x = np.random.default_rng(1).standard_normal((64, 8), dtype=np.float32)
    y = ((x.sum(-1) > 0).astype(np.int32) % 4).astype(np.int32)
    return {"params": params, "x": x, "y": y, "lr": 0.5, "epochs": 3}


def _jax_mlp_loop(config):
    import jax
    import jax.numpy as jnp

    from ray_tpu import train
    from ray_tpu.models import mlp
    from ray_tpu.parallel import shard_batch, shard_tree

    mesh = train.get_mesh()
    assert mesh is not None, "backend must provide the mesh"
    params = jax.tree_util.tree_map(jnp.asarray, config["params"])
    p = shard_tree(params, mesh, rules=((r".*", jax.sharding.PartitionSpec()),))
    batch = shard_batch({"x": jnp.asarray(config["x"]), "y": jnp.asarray(config["y"])}, mesh)

    @jax.jit
    def step(p, b):
        loss, g = jax.value_and_grad(mlp.loss_fn)(p, b)
        return loss, jax.tree_util.tree_map(lambda w, gw: w - config["lr"] * gw, p, g)

    losses = []
    for epoch in range(config["epochs"]):
        loss, p = step(p, batch)
        losses.append(float(loss))
        ckpt = None
        if epoch == config["epochs"] - 1:
            d = tempfile.mkdtemp(prefix="mlp-ck-")
            train.save_pytree(jax.device_get(p), d)
            ckpt = train.Checkpoint(d)
        train.report({"loss": float(loss), "epoch": epoch, "losses": list(losses)},
                     checkpoint=ckpt)


def _torch_mlp_loop(config):
    from ray_tpu_torch import train
    from ray_tpu_torch.models import mlp
    from ray_tpu_torch.models.convert import flatten, mlp_params_from_numpy

    mesh = train.get_mesh()
    assert mesh is not None, "backend must provide the mesh"
    device = mesh.devices.flat[0]
    cfg = mlp.MLPConfig(in_dim=8, hidden=(32,), n_classes=4)
    params = mlp_params_from_numpy(config["params"], cfg, device=device)
    leaves = flatten(params)[1]
    for t in leaves:
        t.requires_grad_(True)
    batch = {"x": torch.from_numpy(config["x"]).to(device),
             "y": torch.from_numpy(config["y"]).to(device)}
    losses = []
    for epoch in range(config["epochs"]):
        loss = mlp.loss_fn(params, batch)
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            for w, g in zip(leaves, grads):
                w.sub_(config["lr"] * g)
        losses.append(float(loss.detach()))
        ckpt = None
        if epoch == config["epochs"] - 1:
            d = tempfile.mkdtemp(prefix="mlp-ck-")
            train.save_pytree(params, d)
            ckpt = train.Checkpoint(d)
        train.report({"loss": losses[-1], "epoch": epoch, "losses": list(losses)},
                     checkpoint=ckpt)


def _mlp_fit(pkg, tmp_path, config):
    loop = _jax_mlp_loop if pkg.name == "jax" else _torch_mlp_loop
    trainer = pkg.Trainer(
        loop,
        train_loop_config=config,
        scaling_config=pkg.scaling(),
        run_config=pkg.train.RunConfig(
            name="mlp_e2e", storage_path=str(tmp_path),
            checkpoint_config=pkg.train.CheckpointConfig(num_to_keep=1)),
    )
    return _fit(trainer)


def _leaves(name, tree):
    if name == "jax":
        import jax

        return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]
    from ray_tpu_torch.models.convert import flatten

    return [t.numpy() for t in flatten(tree)[1]]


def test_mlp_end_to_end_fit(pkg, tmp_path):
    """test_train.py's MLP demo: report + checkpointing + result plumbing."""
    result = _mlp_fit(pkg, tmp_path, _mlp_inputs())
    assert result.error is None
    assert result.metrics["epoch"] == 2
    assert np.isfinite(result.metrics["loss"])
    assert result.checkpoint is not None
    assert result.checkpoint.path.startswith(str(tmp_path))
    tree = pkg.train.load_pytree(result.checkpoint.path)
    assert "layers" in tree and len(tree["layers"]) == 2


def test_mlp_fit_agrees_across_packages(tmp_path):
    """The same weights and batch through both trainers: every loss and
    the final checkpoint's leaves agree within 1e-5."""
    config = _mlp_inputs()
    out = {}
    for name in PACKAGES:
        ns = _ns(name)
        ns.name = name
        ns.rt.shutdown()
        ns.rt.init(local_mode=True, num_cpus=8)
        try:
            result = _mlp_fit(ns, tmp_path / name, config)
            assert result.error is None
            out[name] = (result.metrics["losses"],
                         _leaves(name, ns.train.load_pytree(result.checkpoint.path)))
        finally:
            ns.rt.shutdown()
    (jl, jtree), (tl, ttree) = out["jax"], out["torch"]
    assert len(jl) == len(tl) == 3 and jl[-1] < jl[0]
    np.testing.assert_allclose(tl, jl, rtol=0, atol=LOSS_TOL)
    assert [a.shape for a in jtree] == [b.shape for b in ttree]
    for a, b in zip(jtree, ttree):
        np.testing.assert_allclose(b, a, rtol=0, atol=LOSS_TOL)


def _failing_loop(config):
    import importlib

    train = importlib.import_module(config["train"])
    start = 0
    ck = train.get_checkpoint()
    if ck is not None:
        start = int(train.load_pytree(ck.path)["step"]) + 1
    for step in range(start, 4):
        d = tempfile.mkdtemp(prefix="fail-ck-")
        train.save_pytree({"step": step}, d)
        train.report({"step": step}, checkpoint=train.Checkpoint(d))
        if step == 1 and ck is None:
            raise RuntimeError("injected failure")


def test_trainer_failure_then_resume(pkg, tmp_path):
    """max_failures: the worker fails once and restarts from the latest
    checkpoint; the restart is restart_rework in the goodput ledger."""
    trainer = pkg.Trainer(
        _failing_loop,
        train_loop_config={"train": pkg.train.__name__},
        scaling_config=pkg.scaling(),
        run_config=pkg.train.RunConfig(
            name="resume_e2e", storage_path=str(tmp_path),
            failure_config=pkg.train.FailureConfig(max_failures=1),
            checkpoint_config=pkg.train.CheckpointConfig(num_to_keep=None)),
    )
    result = _fit(trainer)
    assert result.error is None
    assert result.metrics["step"] == 3
    assert result.metrics["goodput_seconds"]["restart_rework"] > 0
    recorder = (ray_tpu.observability.flight_recorder if pkg.name == "jax"
                else ray_tpu_torch.observability.flight_recorder)
    restores = [d for _, kind, d in recorder.RECORDER.snapshot() if kind == "train.restore"]
    assert restores and restores[-1][0].startswith(str(tmp_path / "resume_e2e"))


def _twice_failing_loop(config):
    from ray_tpu_torch import train

    ck = train.get_checkpoint()
    start = int(train.load_pytree(ck.path)["step"]) + 1 if ck else 0
    for step in range(start, 4):
        d = tempfile.mkdtemp(prefix="fail-ck-", dir=config["scratch"])
        train.save_pytree({"step": step}, d)
        train.report({"step": step}, checkpoint=train.Checkpoint(d))
        if step == start and step < 2:
            raise RuntimeError("injected failure")


def test_restarted_attempts_keep_their_checkpoints(tmp_path):
    """keep-1 with a checkpoint every step, and the first two attempts fail
    after their first step: each restart restores the checkpoint the
    attempt before it persisted. (The JAX package's trainer numbers each
    attempt's checkpoints from 0 again, so the second attempt persists over
    the kept checkpoint_000000, keep-1 deletes it as the older entry, and
    the third attempt finds no checkpoint to restore.)"""
    from ray_tpu_torch.train import (CheckpointConfig, FailureConfig, RunConfig,
                                     ScalingConfig, TorchTrainer, load_pytree)

    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(local_mode=True, num_cpus=2)
    try:
        result = _fit(TorchTrainer(
            _twice_failing_loop, train_loop_config={"scratch": str(tmp_path)},
            scaling_config=ScalingConfig(use_gpu=False),
            run_config=RunConfig(name="twice", storage_path=str(tmp_path),
                                 failure_config=FailureConfig(max_failures=2),
                                 checkpoint_config=CheckpointConfig(num_to_keep=1))))
    finally:
        ray_tpu_torch.shutdown()
    assert result.error is None and result.metrics["step"] == 3
    kept = [d for d in os.listdir(tmp_path / "twice") if d.startswith("checkpoint_")]
    assert kept == ["checkpoint_000003"]
    assert int(load_pytree(result.checkpoint.path)["step"]) == 3


def test_failure_without_retries_is_the_results_error(pkg, tmp_path):
    trainer = pkg.Trainer(
        _failing_loop,
        train_loop_config={"train": pkg.train.__name__},
        scaling_config=pkg.scaling(),
        run_config=pkg.train.RunConfig(name="no_retry", storage_path=str(tmp_path)),
    )
    result = _fit(trainer)
    assert isinstance(result.error, pkg.rt.exceptions.TaskError)
    assert "injected failure" in str(result.error)
    assert result.metrics["step"] == 1


def _two_worker_loop(config):
    import importlib

    train = importlib.import_module(config["train"])
    ctx = train.get_context()
    assert ctx.get_world_size() == 2
    for step in range(3):
        train.report({"rank": ctx.get_world_rank(), "step": step})


def test_multi_worker_sessions_not_crosswired(pkg, tmp_path):
    """num_workers=2 in the thread-based runtime: each worker's report()
    stream stays on its own session."""
    trainer = pkg.Trainer(
        _two_worker_loop,
        train_loop_config={"train": pkg.train.__name__},
        scaling_config=pkg.scaling(2),
        run_config=pkg.train.RunConfig(name="two_workers", storage_path=str(tmp_path)),
    )
    result = _fit(trainer)
    assert result.error is None
    assert result.metrics["rank"] == 0
    assert result.metrics["step"] == 2


# ------------------------------------ tests/test_metrics_history.py cases


@pytest.mark.parametrize("name", PACKAGES)
def test_goodput_accountant_classification(name):
    g = _ns(name).goodput
    clock = {"t": 0.0}
    acct = g.GoodputAccountant(clock=lambda: clock["t"])
    for t, cat in ((0.0, g.SETUP), (2.0, g.PRODUCTIVE), (10.0, g.CHECKPOINT),
                   (11.0, g.PRODUCTIVE), (15.0, g.DRAIN_WAIT), (18.0, g.RESTART_REWORK)):
        clock["t"] = t
        acct.begin(cat)
    clock["t"] = 20.0
    acct.finish()
    snap = acct.snapshot()
    assert snap["seconds"] == {
        g.SETUP: 2.0, g.PRODUCTIVE: 12.0, g.CHECKPOINT: 1.0,
        g.DRAIN_WAIT: 3.0, g.RESTART_REWORK: 2.0, "degraded": 0.0,
    }
    assert snap["goodput"] == pytest.approx(12.0 / 20.0)
    assert g.GoodputAccountant().fraction() == 1.0
    with pytest.raises(ValueError):
        acct.begin("napping")


@pytest.mark.parametrize("name", PACKAGES)
def test_goodput_degraded_category_weighting(name):
    g = _ns(name).goodput
    clock = [0.0]
    acct = g.GoodputAccountant(clock=lambda: clock[0])
    acct.begin(g.PRODUCTIVE)
    clock[0] = 10.0
    acct.set_weight(g.DEGRADED, 0.5)
    acct.begin(g.DEGRADED)
    clock[0] = 20.0
    acct.finish()
    snap = acct.snapshot()
    assert snap["seconds"]["productive"] == 10.0
    assert snap["seconds"]["degraded"] == 10.0
    assert abs(snap["goodput"] - 0.75) < 1e-9
    with pytest.raises(ValueError):
        acct.set_weight("bogus", 1.0)


@pytest.mark.parametrize("name", PACKAGES)
def test_mfu_helper(name, monkeypatch):
    g = _ns(name).goodput
    monkeypatch.setenv("RAY_TPU_PEAK_FLOPS", "1e6")
    assert g.mfu(100.0, 5000.0) == pytest.approx(0.5)
    assert g.mfu(100.0, 5000.0, peak_flops_per_s=2e6) == pytest.approx(0.25)
    monkeypatch.delenv("RAY_TPU_PEAK_FLOPS")
    if name == "torch" and not torch.cuda.is_initialized():
        assert g.peak_flops() is None  # no device peak to guess at: no MFU
        assert g.mfu(100.0, 5000.0) is None


def _telemetry_loop(config):
    import importlib

    train = importlib.import_module(config["train"])
    train.configure_telemetry(flops_per_token=1e6)
    for step in range(3):
        with train.phase("data_wait"):
            time.sleep(0.01)
        with train.phase("compute"):
            time.sleep(0.02)
        train.report({"step": step, "tokens_per_s": 500.0})


def test_trainer_reports_goodput_mfu_and_phases(pkg, tmp_path, monkeypatch):
    monkeypatch.setenv("RAY_TPU_PEAK_FLOPS", "1e9")
    imet = (ray_tpu.utils.internal_metrics if pkg.name == "jax"
            else ray_tpu_torch.utils.internal_metrics)
    result = _fit(pkg.Trainer(
        _telemetry_loop,
        train_loop_config={"train": pkg.train.__name__},
        scaling_config=pkg.scaling(),
        run_config=pkg.train.RunConfig(name="telemetry", storage_path=str(tmp_path)),
    ))
    assert result.error is None
    assert result.metrics["mfu"] == pytest.approx(0.5)  # 500 tok/s * 1e6 / 1e9
    assert 0.0 < result.metrics["goodput"] <= 1.0
    assert result.metrics["goodput_seconds"]["productive"] > 0
    phases = result.metrics["phase_seconds"]
    assert phases["data_wait"] > 0 and phases["compute"] > 0
    bound_phases = {dict(key).get("phase") for key in imet.TRAIN_PHASE_TIME._bound}
    assert {"data_wait", "compute"} <= bound_phases


def _fpt_loop(config):
    import importlib

    train = importlib.import_module(config["train"])
    train.configure_telemetry(flops_per_token=config["fpt"])
    train.report({"tokens_per_s": 1000.0})


def test_flops_per_token_feeds_mfu(pkg, tmp_path, monkeypatch):
    monkeypatch.setenv("RAY_TPU_PEAK_FLOPS", "1e12")
    if pkg.name == "jax":
        from ray_tpu.models.transformer import TransformerConfig, flops_per_token
    else:
        from ray_tpu_torch.models.transformer import TransformerConfig, flops_per_token
    cfg = TransformerConfig(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
                            n_kv_heads=4, d_ff=128, max_seq_len=64)
    fpt = flops_per_token(cfg, 64)
    result = _fit(pkg.Trainer(
        _fpt_loop,
        train_loop_config={"fpt": fpt, "train": pkg.train.__name__},
        scaling_config=pkg.scaling(),
        run_config=pkg.train.RunConfig(name="mfu_e2e", storage_path=str(tmp_path)),
    ))
    assert result.error is None
    assert result.metrics["mfu"] == pytest.approx(1000.0 * fpt / 1e12)


# ------------------------------------- tests/test_data_plane.py, the port's


@pytest.mark.parametrize("name", PACKAGES)
def test_trainer_rejects_unknown_dataset_config(name):
    with pytest.raises(ValueError, match="dataset_config"):
        _ns(name).Trainer(lambda config: None, dataset_config="teleport")


def _shard_ids_loop(config):
    """Reports the ids this rank's dataset shard holds, in the order read."""
    import importlib

    train = importlib.import_module(config["train"])
    ids = [int(v) for b in train.get_dataset_shard("train").iter_batches(batch_size=10)
           for v in b["id"]]
    train.report({"ids": ids, "rank": train.get_context().get_world_rank()})


def test_torch_trainer_datasets_wait_for_data():
    """The name is older than the port of Data: TorchTrainer(datasets=) no
    longer raises. `datasets={"train": data.range(...)}` over 2 workers
    gives rank 0 the ids the JaxTrainer's split gives its rank 0 (an equal
    split, in the order read)."""
    got = {}
    for name in PACKAGES:
        ns = _ns(name)
        data = importlib.import_module(f"{ns.rt.__name__}.data")
        ns.rt.shutdown()
        ns.rt.init(local_mode=True, num_cpus=8)
        try:
            result = _fit(ns.Trainer(
                _shard_ids_loop, train_loop_config={"train": ns.train.__name__},
                scaling_config=ns.scaling(2),
                run_config=ns.train.RunConfig(name="shards", storage_path=tempfile.mkdtemp()),
                datasets={"train": data.range(64, parallelism=4)}))
        finally:
            ns.rt.shutdown()
        assert result.error is None, result.error
        got[name] = result.metrics
    assert got["torch"]["rank"] == got["jax"]["rank"] == 0
    assert got["torch"]["ids"] == got["jax"]["ids"] and len(got["jax"]["ids"]) == 32


def _three_step_loop(config):
    import importlib

    train = importlib.import_module(config["train"])
    for step in range(3):
        train.report({"step": step})


# The port's ids keep their names; the JAX package's run the same fields.
_SCALING_FIELDS = [({"backend": "gloo"}, "torch"), ({"elastic": True}, "torch"),
                   ({"min_workers": 1}, "torch"), ({"capacity_wait_s": 5.0}, "torch"),
                   ({"elastic": True}, "jax"), ({"min_workers": 1}, "jax"),
                   ({"capacity_wait_s": 5.0}, "jax")]


@pytest.mark.parametrize("kw,name", _SCALING_FIELDS,
                         ids=[next(iter(kw)) + ("-jax" if name == "jax" else "")
                              for kw, name in _SCALING_FIELDS])
def test_cluster_only_scaling_fields_are_refused(kw, name, tmp_path):
    """`backend` is read by the cluster runtime's distributed setup and is
    accepted there (tests/test_torch_cluster_trainer.py runs it); the
    in-process runtime would ignore it, so fit() refuses it there. The
    elastic fields (`elastic`, `min_workers`, `capacity_wait_s`) are read on
    the cluster runtime after a preemption (tests/test_torch_elastic.py); the
    in-process runtime has no nodes to lose, so both packages accept them
    there and fit a one-worker run to the end: `_feasible_workers` reports
    the target and `_wait_for_capacity` returns True at once."""
    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchBackendConfig, TorchTrainer

    if "backend" in kw:
        ScalingConfig(backend=None, elastic=False, min_workers=None, capacity_wait_s=None)
        sc = ScalingConfig(use_gpu=False, backend=TorchBackendConfig(backend=kw["backend"]))
        assert sc.backend.backend == "gloo"
        ray_tpu_torch.shutdown()
        ray_tpu_torch.init(local_mode=True, num_cpus=2)
        try:
            with pytest.raises(NotImplementedError, match="cluster runtime"):
                TorchTrainer(lambda config: None, scaling_config=sc,
                             run_config=RunConfig(storage_path=str(tmp_path))).fit()
            assert not os.listdir(tmp_path)  # refused before any attempt
        finally:
            ray_tpu_torch.shutdown()
        return
    ns = _ns(name)
    if name == "jax":
        from ray_tpu.parallel import MeshSpec
    else:
        from ray_tpu_torch.parallel import MeshSpec

        kw = dict(kw, use_gpu=False)
    sc = ns.train.ScalingConfig(num_workers=1, mesh=MeshSpec(data=-1), **kw)
    ns.rt.shutdown()
    ns.rt.init(local_mode=True, num_cpus=2)
    try:
        trainer = ns.Trainer(_three_step_loop, train_loop_config={"train": ns.train.__name__},
                             scaling_config=sc,
                             run_config=ns.train.RunConfig(name="elastic_fields",
                                                           storage_path=str(tmp_path)))
        assert trainer._feasible_workers() == 1
        assert trainer._wait_for_capacity(1, timeout_s=0.1) is True
        result = _fit(trainer)
    finally:
        ns.rt.shutdown()
    assert result.error is None
    assert result.metrics["step"] == 2
    seconds = result.metrics["goodput_seconds"]
    assert seconds["drain_wait"] == 0 and seconds["degraded"] == 0


def test_torch_trainer_without_cuda_raises_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this checks the refusal on a machine without a CUDA device")
    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer

    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(local_mode=True, num_cpus=2)
    try:
        assert ScalingConfig().use_gpu
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TorchTrainer(lambda config: None,
                         run_config=RunConfig(storage_path=str(tmp_path))).fit()
        assert not os.listdir(tmp_path)  # refused before any attempt
    finally:
        ray_tpu_torch.shutdown()


# -------------------------------------------- the transformer in both trainers


@pytest.fixture
def _exact_matmuls():
    import jax

    old = jax.config.jax_default_matmul_precision
    jax.config.update("jax_default_matmul_precision", "highest")
    yield
    jax.config.update("jax_default_matmul_precision", old)


def _tfm_inputs(n_steps):
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import transformer as jtfm

    jcfg = jtfm.tiny(dtype=jnp.float32, attn_impl="full")
    params = jax.tree_util.tree_map(np.asarray, jtfm.init_params(jax.random.PRNGKey(0), jcfg))
    # Step i trains on a batch drawn from seed i: a resume at the wrong
    # step shows in its losses.
    batches = [np.random.default_rng(i).integers(0, jcfg.vocab_size, (2, 16), dtype=np.int32)
               for i in range(n_steps)]
    return {"params": params, "batches": batches, "lr": 1e-3}


def _jax_tfm_loop(config):
    import jax
    import jax.numpy as jnp
    import optax

    from ray_tpu import train
    from ray_tpu.models import transformer as jtfm

    jcfg = jtfm.tiny(dtype=jnp.float32, attn_impl="full")
    _, step = jtfm.build_train_step(jcfg, optax.adamw(config["lr"]), None, donate=False)
    params = jax.tree_util.tree_map(jnp.asarray, config["params"])
    opt = optax.adamw(config["lr"]).init(params)
    losses = []
    for i, tokens in enumerate(config["batches"]):
        params, opt, loss = step(params, opt, jnp.asarray(tokens))
        losses.append(float(loss))
        train.report({"step": i, "loss": float(loss), "losses": list(losses)})


def _params_sha256(params) -> str:
    from ray_tpu_torch.models.convert import flatten

    h = hashlib.sha256()
    for t in flatten(params)[1]:
        h.update(t.detach().cpu().contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _torch_tfm_loop(config):
    """3 AdamW steps of tiny() in float32. With "ckpt_at", an elastic
    checkpoint of params and AdamW state is reported at that step; with
    "fail_after", the first attempt raises after reporting that step. A
    restored attempt resumes at the step after its checkpoint's."""
    from ray_tpu_torch import train
    from ray_tpu_torch.models import convert
    from ray_tpu_torch.models import transformer as ttfm
    from ray_tpu_torch.train import elastic_checkpoint as ec

    device = train.get_mesh().devices.flat[0]
    tcfg = ttfm.tiny(dtype=torch.float32, attn_impl="full")
    _, step = ttfm.build_train_step(tcfg, ttfm.adamw(config["lr"]), device=device)
    params = convert.params_from_numpy(config["params"], tcfg, device=device)
    for t in ttfm.tree_leaves(params):
        t.requires_grad_(True)
    opt = ttfm.adamw(config["lr"])(ttfm.tree_leaves(params))
    start, ck = 0, train.get_checkpoint()
    if ck is not None:
        state = ec.load_state(ck.path)
        with torch.no_grad():
            for t, src in zip(convert.flatten(params)[1], convert.flatten(state["params"])[1]):
                t.copy_(src)
        convert.opt_state_from_numpy(state["opt_state"], opt, params)
        start = state["step"] + 1
    losses = {}
    n = len(config["batches"])
    for i in range(start, n):
        losses[i] = float(step(params, opt, torch.from_numpy(config["batches"][i])))
        metrics = {"step": i, "loss": losses[i], "losses": dict(losses)}
        if i == n - 1:
            metrics["params_sha256"] = _params_sha256(params)
        ckpt = None
        if i == config.get("ckpt_at"):
            d = tempfile.mkdtemp(prefix="tfm-ck-", dir=config["scratch"])
            ec.save_state(d, params, convert.opt_state_to_torch(opt, params), step=i,
                          world_size=1, rank=0)
            ckpt = train.Checkpoint(d)
        train.report(metrics, checkpoint=ckpt)
        if ck is None and i == config.get("fail_after"):
            raise RuntimeError("injected failure")


def test_transformer_fit_agrees_across_packages(tmp_path, _exact_matmuls):
    """tiny() with 2 layers, the same params and batches: 3 AdamW steps in
    the JaxTrainer (optax) and the TorchTrainer give the same losses."""
    config = _tfm_inputs(3)
    losses = {}
    for name, loop in (("jax", _jax_tfm_loop), ("torch", _torch_tfm_loop)):
        ns = _ns(name)
        ns.rt.shutdown()
        ns.rt.init(local_mode=True, num_cpus=8)
        try:
            result = _fit(ns.Trainer(
                loop, train_loop_config=config, scaling_config=ns.scaling(),
                run_config=ns.train.RunConfig(name="tfm", storage_path=str(tmp_path / name))))
        finally:
            ns.rt.shutdown()
        assert result.error is None and result.metrics["step"] == 2
        got = result.metrics["losses"]
        losses[name] = list(got.values()) if isinstance(got, dict) else got
    jl, tl = losses["jax"], losses["torch"]
    assert len(jl) == len(tl) == 3
    assert abs(tl[0] - jl[0]) < LOSS_TOL
    np.testing.assert_allclose(tl, jl, rtol=TRAJECTORY_RTOL, atol=0)


def test_torch_transformer_resume_is_bitwise(tmp_path):
    """4 steps uninterrupted against a run whose first attempt checkpoints
    at step 1 and fails after step 2: the resumed attempt's losses of
    steps 2-3 and its final params equal the uninterrupted run's bit for
    bit; one checkpoint directory is kept (num_to_keep=1)."""
    from ray_tpu_torch.train import (CheckpointConfig, FailureConfig, RunConfig,
                                     ScalingConfig, TorchTrainer)

    config = _tfm_inputs(4)
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(local_mode=True, num_cpus=4)
    results = {}
    try:
        for name, extra, failures in (("straight", {}, 0),
                                      ("resumed", {"ckpt_at": 1, "fail_after": 2}, 1)):
            scratch = tmp_path / f"{name}-scratch"
            scratch.mkdir()
            results[name] = _fit(TorchTrainer(
                _torch_tfm_loop,
                train_loop_config={**config, **extra, "scratch": str(scratch)},
                scaling_config=ScalingConfig(use_gpu=False),
                run_config=RunConfig(
                    name=name, storage_path=str(tmp_path),
                    failure_config=FailureConfig(max_failures=failures),
                    checkpoint_config=CheckpointConfig(num_to_keep=1))))
    finally:
        ray_tpu_torch.shutdown()
    a, b = results["straight"].metrics, results["resumed"].metrics
    assert results["resumed"].error is None and a["step"] == b["step"] == 3
    assert sorted(b["losses"]) == [2, 3]  # the second attempt resumed after step 1
    assert all(b["losses"][i] == a["losses"][i] for i in (2, 3))
    assert b["params_sha256"] == a["params_sha256"]
    assert [d for d in os.listdir(tmp_path / "resumed") if d.startswith("checkpoint_")] == [
        "checkpoint_000000"]
    assert a["goodput_seconds"]["restart_rework"] == 0
    assert b["goodput_seconds"]["restart_rework"] > 0


_PINNED = []


def _pinning_loop(config):
    big = torch.zeros(1 << 16)
    _PINNED.append(weakref.ref(big))
    raise RuntimeError("injected failure")


def test_failed_attempt_releases_its_tensors(tmp_path):
    """The error of a failed attempt stays on the Result with its traceback,
    but the failed loop's frames no longer hold its tensors."""
    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer

    _PINNED.clear()
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(local_mode=True, num_cpus=2)
    try:
        result = _fit(TorchTrainer(_pinning_loop, scaling_config=ScalingConfig(use_gpu=False),
                                   run_config=RunConfig(storage_path=str(tmp_path))))
    finally:
        ray_tpu_torch.shutdown()
    assert "injected failure" in str(result.error) and result.error.__traceback__ is not None
    gc.collect()
    assert len(_PINNED) == 1 and _PINNED[0]() is None
