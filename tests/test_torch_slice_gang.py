"""SLICE_GANG on both packages side by side: tests/test_slice_gang.py's four
cases (a gang lands on one slice; a bundle's worker sees its devices and the
slice's identity; a member's death moves the whole gang; a gang no slice can
take stays PENDING), test_ops_layer.py's autoscaler case (a pending gang gets
a whole slice), and a GCS restart that brings a RESCHEDULING gang back from
its log. The JAX package's slices carry TPUs and its workers read
TPU_VISIBLE_CHIPS, TPU_SLICE_NAME and TPU_WORKER_ID; the port's carry GPUs
(fake device ids on the CPU) and its workers read CUDA_VISIBLE_DEVICES,
RAY_TPU_SLICE_NAME and RAY_TPU_SLICE_WORKER_ID.

Each package boots two module clusters, under tests/torch_modes.py's fixture
limits: one with two labelled 2-host slices of 4 devices a host (the
node-killing case runs last on it), one with no slice (the pending, restart
and autoscaler cases, in that order, then the port's TorchTrainer surviving
a gang's co-fail). Every cluster case runs under `case_time_limit`. Plus the
port's slice detection and GpuTopology on injected `nvidia-smi -q` reports,
with a fabric and without.
"""

import importlib
import os
import sys
import types

import pytest

from ray_tpu_torch.core import serialization

import torch_modes
from torch_waits import wait_for

serialization.register_pickle_by_value(sys.modules[__name__])

PKGS = ("jax", "torch")
ROOT = {"jax": "ray_tpu", "torch": "ray_tpu_torch"}
ACCEL = {"jax": "TPU", "torch": "GPU"}
CASE_S = 120


def _boot(name, slices):
    """A cluster of `name`'s package (a head without devices) and `slices`
    labelled hosts of 4 devices each: {(slice, worker index): node id}."""
    rt = importlib.import_module(ROOT[name])
    base = importlib.import_module(f"{ROOT[name]}.core.runtime_base")
    Cluster = importlib.import_module(f"{ROOT[name]}.core.cluster_runtime").Cluster
    rt.shutdown()
    if name == "jax":
        cluster = torch_modes.boot_jax_cluster(num_cpus=2)
    else:
        cluster = torch_modes.boot_cluster(Cluster, num_cpus=2, num_gpus=0)
    c = types.SimpleNamespace(name=name, rt=rt, base=base, cluster=cluster, nodes={},
                              pg=importlib.import_module(f"{ROOT[name]}.core.placement_group"))
    with torch_modes.fixture_time_limit(torch_modes.BOOT_LIMIT_S,
                                        lambda: torch_modes.discard_cluster(cluster)):
        for sl in slices:
            for widx in range(2):
                c.nodes[(sl, widx)] = _add_host(c, sl, widx)
    c.runtime = cluster.runtime()
    base.set_runtime(c.runtime)
    return c


def _add_host(c, slice_name, widx):
    """One host of a slice: 4 TPUs (JAX) or 4 GPU ids (the port), 2 CPUs."""
    labels = {"slice_name": slice_name, "worker_index": widx}
    if c.name == "jax":
        return c.cluster.add_node(num_cpus=2, resources={"TPU": 4.0}, labels=labels)
    return c.cluster.add_node(num_cpus=2, num_gpus=4, labels=labels)


def _package_fixture(name, slices):
    # The port's fake GPU ids are "0".."3" only with no inherited restriction.
    saved = os.environ.pop("CUDA_VISIBLE_DEVICES", None)
    c = _boot(name, slices)
    try:
        yield c
    finally:
        try:
            torch_modes.shutdown_cluster(c.cluster, c.rt.shutdown)
        finally:
            c.base.set_runtime(None)
            if saved is not None:
                os.environ["CUDA_VISIBLE_DEVICES"] = saved


@pytest.fixture(scope="module")
def jax_slices():
    yield from _package_fixture("jax", ("slice-a", "slice-b"))


@pytest.fixture(scope="module")
def torch_slices():
    yield from _package_fixture("torch", ("slice-a", "slice-b"))


@pytest.fixture(scope="module")
def jax_plain():
    yield from _package_fixture("jax", ())


@pytest.fixture(scope="module")
def torch_plain():
    yield from _package_fixture("torch", ())


def _use(request, kind):
    c = request.getfixturevalue(f"{request.param}_{kind}")
    c.base.set_runtime(c.runtime)
    return c


@pytest.fixture(params=PKGS)
def c(request):
    c = _use(request, "slices")
    with torch_modes.case_time_limit(request, CASE_S):
        yield c


@pytest.fixture(params=PKGS)
def plain(request):
    c = _use(request, "plain")
    with torch_modes.case_time_limit(request, CASE_S):
        yield c


def _slice_of(c, node_id):
    return next((sl for (sl, _w), nid in c.nodes.items() if nid == node_id), None)


def _gang(c, n):
    bundle = {"CPU": 1.0, ACCEL[c.name]: 4.0}
    return c.pg.placement_group([dict(bundle) for _ in range(n)], strategy="SLICE_GANG")


def _pinned(c, fn, pg, index=0, **opts):
    return c.rt.remote(**opts)(fn).options(
        scheduling_strategy=c.pg.PlacementGroupSchedulingStrategy(
            placement_group=pg, placement_group_bundle_index=index))


def _table(c, pg):
    return c.runtime.placement_group_table().get(pg.id_hex)


def test_gang_lands_on_one_slice(c):
    pg = _gang(c, 2)
    try:
        placed = [pg.bundle_placements[0], pg.bundle_placements[1]]
        slices = {_slice_of(c, n) for n in placed}
        assert len(slices) == 1 and None not in slices, f"gang split across {slices}"
        assert len(set(placed)) == 2  # one bundle per host
    finally:
        c.pg.remove_placement_group(pg)


def test_gang_worker_sees_devices_and_slice(c):
    pg = _gang(c, 1)

    def read_env(names):
        import os

        return [os.environ.get(k) for k in names]

    names = (("TPU_VISIBLE_CHIPS", "TPU_SLICE_NAME", "TPU_WORKER_ID") if c.name == "jax" else
             ("CUDA_VISIBLE_DEVICES", "RAY_TPU_SLICE_NAME", "RAY_TPU_SLICE_WORKER_ID"))
    opts = {"num_tpus": 4} if c.name == "jax" else {"num_gpus": 4}
    try:
        devices, slice_name, worker_id = c.rt.get(
            _pinned(c, read_env, pg, num_cpus=1, **opts).remote(names), timeout=60)
        assert devices == "0,1,2,3"
        node = pg.bundle_placements[0]
        assert slice_name == _slice_of(c, node)
        assert (slice_name, int(worker_id)) in c.nodes
        assert c.nodes[(slice_name, int(worker_id))] == node
    finally:
        c.pg.remove_placement_group(pg)


def test_member_death_cofails_and_reschedules(c):
    """Runs last on the slices cluster: it kills a host."""
    pg = _gang(c, 2)
    first_nodes = [pg.bundle_placements[0], pg.bundle_placements[1]]
    first_slice = _slice_of(c, first_nodes[0])
    c.cluster.remove_node(first_nodes[0])
    table = {}

    def moved():
        table.update(_table(c, pg) or {})
        return table.get("state") == "CREATED" and set(table["placements"]) != set(first_nodes)

    assert wait_for(moved, timeout=30, interval=0.2), table
    # The WHOLE gang moved to the other slice.
    assert {_slice_of(c, n) for n in table["placements"]} == {"slice-a", "slice-b"} - {
        first_slice}, table["placements"]
    alive = {n["NodeID"]: n["Alive"] for n in c.runtime.nodes()}
    assert alive[first_nodes[1]] and not alive[first_nodes[0]]

    def ping():
        return "ok"

    assert c.rt.get(_pinned(c, ping, pg, num_cpus=1).remote(), timeout=60) == "ok"


def test_gang_pending_without_slices(plain):
    """Creation is asynchronous: a gang no slice can take registers as
    PENDING and ready() stays False."""
    pg = plain.pg.placement_group([{"CPU": 1.0}], strategy="SLICE_GANG")
    try:
        assert not pg.ready(timeout=2.0)
        assert _table(plain, pg)["state"] == "PENDING"
    finally:
        plain.pg.remove_placement_group(pg)


def test_restart_gcs_brings_a_rescheduling_gang_back(plain):
    """A gang whose member died and which no slice can take is RESCHEDULING;
    after a GCS restart the port's record comes back from the log as such,
    and a slice that joins later takes the whole gang. The JAX package's GCS
    never logs the co-fail (`_on_node_death` sets the state without a
    write-ahead record): its gang comes back CREATED on the dead member
    unless a periodic snapshot caught the co-fail first (ROADMAP Queue 3)."""
    c = plain
    mine = []
    for w in range(2):
        mine.append(_add_host(c, "slice-c", w))
        c.nodes[("slice-c", w)] = mine[-1]
    pg = _gang(c, 2)
    try:
        assert pg.ready(timeout=30)
        first = [pg.bundle_placements[0], pg.bundle_placements[1]]
        assert {_slice_of(c, n) for n in first} == {"slice-c"}
        c.cluster.remove_node(first[0])
        assert wait_for(lambda: (_table(c, pg) or {}).get("state") == "RESCHEDULING",
                        timeout=30, interval=0.2), _table(c, pg)
        c.cluster.restart_gcs()
        if c.name == "jax":
            table = {}
            assert wait_for(lambda: table.update(_table(c, pg) or {}) or table, timeout=30,
                            interval=0.2)
            # CREATED on the dead member unless a periodic snapshot caught
            # the co-fail before the restart
            assert (table["state"] == "CREATED" and first[0] in table["placements"]
                    or table["state"] == "RESCHEDULING"), table
            return
        states = []
        assert wait_for(lambda: states.append((_table(c, pg) or {}).get("state"))
                        or states[-1] == "RESCHEDULING", timeout=30, interval=0.2), states
        for w in range(2):
            mine.append(_add_host(c, "slice-d", w))
            c.nodes[("slice-d", w)] = mine[-1]
        table = {}
        assert wait_for(lambda: table.update(_table(c, pg) or {})
                        or table.get("state") == "CREATED", timeout=60, interval=0.25), table
        assert {_slice_of(c, n) for n in table["placements"]} == {"slice-d"}
    finally:
        c.pg.remove_placement_group(pg)
        # The autoscaler case after this one needs a cluster with no slice.
        for key in [k for k in c.nodes if k[0] in ("slice-c", "slice-d")]:
            del c.nodes[key]
        for nid in mine[1:]:
            c.cluster.remove_node(nid)


def test_autoscaler_provisions_slice_for_pending_gang(plain):
    """A SLICE_GANG no node can host goes PENDING; the v1 autoscaler asks its
    slice provider for a whole labelled slice and the gang lands on it."""
    c = plain
    scaling = importlib.import_module(f"{ROOT[c.name]}.autoscaler")
    provider = (scaling.LocalTPUSliceProvider if c.name == "jax"
                else scaling.LocalGPUSliceProvider)(c.cluster)
    pg = _gang(c, 2)
    assert not pg.ready(timeout=1.0)
    scaler = scaling.Autoscaler(provider, max_nodes=8, upscale_delay_s=0.5, interval_s=0.5)
    scaler.start()
    try:
        assert pg.ready(timeout=120), "gang never placed after the scale-up"
        assert scaler.num_upscales >= 1
        assert len(set(pg.bundle_placements.values())) == 2  # one bundle per host

        nodes = {n["NodeID"]: n for n in c.runtime.nodes()}
        labels = [nodes[pg.bundle_placements[i]]["Labels"] for i in range(2)]
        assert len({lab["slice_name"] for lab in labels}) == 1
        assert sorted(int(lab["worker_index"]) for lab in labels) == [0, 1]

        def node_of():
            import importlib

            for root in ("ray_tpu_torch", "ray_tpu"):
                try:
                    base = importlib.import_module(f"{root}.core.runtime_base")
                    return base.current_runtime().node_id()
                except Exception:  # noqa: BLE001 - the other package's worker
                    continue
            return None

        got = c.rt.get(_pinned(c, node_of, pg, num_cpus=1).remote(), timeout=90)
        assert got == pg.bundle_placements[0]
    finally:
        scaler.stop()
        c.pg.remove_placement_group(pg)


def _gang_train_loop(config):
    """Two ranks on a SLICE_GANG: a step counter checkpointed after every
    step by rank 0 (the checkpoint carries the record: each step once, and
    each attempt's ranks' slices); rank 0 marks each finished step."""
    import json
    import os
    import tempfile
    import time

    import torch.distributed as dist

    from ray_tpu_torch import train

    rank, world = train.get_context().get_world_rank(), train.get_context().get_world_size()
    start, record, ck = 0, {"steps": [], "attempts": []}, train.get_checkpoint()
    if ck is not None:
        with open(os.path.join(ck.path, "state.json")) as f:
            state = json.load(f)
        start, record = state["next"], state["record"]
    slices = [None] * world
    dist.all_gather_object(slices, os.environ.get("RAY_TPU_SLICE_NAME"))
    record["attempts"].append(slices)
    for i in range(start, config["steps"]):
        time.sleep(0.2)
        record["steps"].append(i)
        ckpt = None
        if rank == 0:
            d = tempfile.mkdtemp(dir=config["scratch"])
            with open(os.path.join(d, "state.json"), "w") as f:
                json.dump({"next": i + 1, "record": record}, f)
            ckpt = train.Checkpoint(d)
        train.report({"step": i, "record": record}, checkpoint=ckpt)
        if rank == 0:
            open(os.path.join(config["scratch"], f"step_{i}"), "w").close()


def test_trainer_survives_a_gang_cofail(torch_plain, request, tmp_path):
    """The port's TorchTrainer on SLICE_GANG bundles (max_failures=1): one
    member's host dies after step 1; the attempt fails, the next one runs
    on a gang on another slice and resumes from the last checkpoint, each
    step recorded once."""
    import threading

    from ray_tpu_torch.train import (FailureConfig, RunConfig, ScalingConfig,
                                     TorchTrainer)

    c = torch_plain
    c.base.set_runtime(c.runtime)
    mine = [_add_host(c, sl, w) for sl in ("train-a", "train-b") for w in range(2)]
    scratch = tmp_path / "scratch"
    scratch.mkdir()
    seen = {}

    def kill_member():
        if not wait_for(lambda: (scratch / "step_1").exists(), timeout=60, interval=0.05):
            return
        (pg,) = [p for p in c.runtime.placement_group_table().values()
                 if p["strategy"] == "SLICE_GANG" and p["state"] == "CREATED"]
        seen["victim"] = pg["placements"][1]
        c.cluster.remove_node(seen["victim"])

    killer = threading.Thread(target=kill_member, daemon=True)
    try:
        with torch_modes.case_time_limit(request, CASE_S):
            killer.start()
            result = TorchTrainer(
                _gang_train_loop, train_loop_config={"steps": 6, "scratch": str(scratch)},
                scaling_config=ScalingConfig(num_workers=2, use_gpu=False,
                                             placement_strategy="SLICE_GANG"),
                run_config=RunConfig(name="gang_cofail", storage_path=str(tmp_path),
                                     failure_config=FailureConfig(max_failures=1))).fit()
            killer.join(60)
    finally:
        for nid in mine:
            if nid != seen.get("victim"):
                c.cluster.remove_node(nid)
    assert "victim" in seen and result.error is None, result.error
    record = result.metrics["record"]
    assert record["steps"] == list(range(6))
    (first, *_), (second, *_) = record["attempts"][0], record["attempts"][-1]
    assert len(record["attempts"]) == 2
    assert all(sl == first for sl in record["attempts"][0]), record["attempts"]
    assert all(sl == second for sl in record["attempts"][1]), record["attempts"]
    # the smallest fitting slice goes first: the autoscaler case's, if left
    assert first != second and None not in (first, second), record["attempts"]


# --------------------------------------------------------- slice detection
# The fabric report follows the field layout of `nvidia-smi -q`'s Fabric
# section; it was written for this test, not captured from a multi-host
# NVLink domain.
FABRIC_REPORT = """Driver Version                            : 570.86.15
Attached GPUs                             : 4
GPU 00000008:01:00.0
    Product Name                          : NVIDIA GB200
    Fabric
        State                             : Completed
        Status                            : Success
        CliqueId                          : 32766
        ClusterUUID                       : 7dd0b1f2-1a3c-4c4e-9b6f-2cd0c1c2a3b4
    Processes                             : None
"""
NO_FABRIC_REPORT = """Driver Version                            : 570.86.15
Attached GPUs                             : 1
GPU 00000000:18:00.0
    Product Name                          : NVIDIA H100 80GB HBM3
    Fabric
        State                             : N/A
        Status                            : N/A
        CliqueId                          : N/A
        ClusterUUID                       : N/A
"""


@pytest.mark.parametrize("report,env,want", [
    (FABRIC_REPORT, {"RAY_TPU_SLICE_WORKER_ID": "3"},  # the worker-side variable: not read
     ("nvl-7dd0b1f2-1a3c-4c4e-9b6f-2cd0c1c2a3b4/32766", "gb200", 4, 1, 0)),
    (NO_FABRIC_REPORT, {}, ("host-node7", "h100", 1, 1, 0)),
    ("", {}, ("host-node7", "", 2, 1, 0)),  # no nvidia-smi: the raylet's own count
], ids=["fabric", "no_fabric", "no_smi"])
def test_detect_slice_spec_and_topology(report, env, want):
    from ray_tpu_torch.accelerators.gpu import GpuAcceleratorManager
    from ray_tpu_torch.parallel import GpuTopology

    mgr = GpuAcceleratorManager(env=env, device_count=lambda: 2, smi=lambda: report,
                                hostname=lambda: "node7")
    spec = mgr.detect_slice_spec(2)
    assert (spec.slice_name, spec.generation, spec.gpus_per_host, spec.hosts_per_slice,
            spec.worker_index) == want
    assert spec.total_gpus == want[2] * want[3]
    env_vars = mgr.worker_visibility_env(["0", "1"], slice_name=spec.slice_name,
                                         worker_index=spec.worker_index)
    assert env_vars == {"CUDA_VISIBLE_DEVICES": "0,1", "RAY_TPU_SLICE_NAME": spec.slice_name,
                        "RAY_TPU_SLICE_WORKER_ID": str(want[4])}
    topo = GpuTopology.detect(device_names=["NVIDIA H100 80GB HBM3"] * 8, slice_spec=spec)
    assert (topo.generation, topo.gpus_per_host, topo.num_hosts, topo.mesh_shape) == (
        "h100", 8, want[3], ())
    assert topo.num_gpus == 8 * want[3]
    assert GpuTopology.detect(use_gpu=False) == GpuTopology("cpu", 1, 1, ())


def test_detect_slice_spec_reads_the_report_once_per_host(tmp_path):
    """With a session dir, the host's first raylet reads `nvidia-smi -q` and
    the session's other raylets on it read that answer."""
    from ray_tpu_torch.accelerators.gpu import GpuAcceleratorManager

    reads = []

    def smi():
        reads.append(1)
        return NO_FABRIC_REPORT

    specs = [GpuAcceleratorManager(env={}, smi=smi, hostname=lambda: "node7")
             .detect_slice_spec(1, cache_dir=str(tmp_path)) for _ in range(3)]
    assert len(reads) == 1
    assert specs[0] == specs[1] == specs[2]
    assert (specs[0].slice_name, specs[0].generation) == ("host-node7", "h100")
    assert os.listdir(tmp_path) == ["slice_spec-node7.json"]


def test_status_shows_the_slice_beside_the_other_labels(monkeypatch, capsys):
    import argparse

    from ray_tpu_torch import scripts
    from ray_tpu_torch.utils import state

    node = {"NodeID": "a1b2c3d4e5f6a7b8", "Alive": True, "Resources": {"GPU": 1.0},
            "Available": {"GPU": 1.0},
            "Labels": {"slice_name": "host-node7", "worker_index": 0, "gpu_generation": "h100",
                       "ray_tpu_cloud_id": "local-3"}}
    monkeypatch.setattr(scripts, "_connect", lambda args: None)
    monkeypatch.setattr(scripts, "_status_tail", lambda stats, st: None)
    monkeypatch.setattr(state, "cluster_stats", lambda: {"nodes_alive": 1})
    monkeypatch.setattr(state, "node_summary", lambda: {"resources": {"GPU": 1.0}, "total": 1})
    monkeypatch.setattr(state, "list_nodes", lambda limit: [node])
    scripts.cmd_status(argparse.Namespace(limit=None, summary=False, verbose=False))
    out = capsys.readouterr().out
    assert "slice=host-node7[0] gpu=h100 labels=ray_tpu_cloud_id=local-3" in out, out
