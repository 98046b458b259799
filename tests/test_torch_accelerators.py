"""The port's GPU accelerator manager (ray_tpu_torch/accelerators/gpu.py)
beside the JAX package's TPU manager: tests/test_accelerators.py's
visibility cases (its lines 174-212 and 412), each on both families, then
the raylet's device leases on a CPU cluster with fake GPU resources:
CUDA_VISIBLE_DEVICES inside the worker, exclusive whole-device leases,
shared fractional ones, and bundles.
"""

import os
import sys
import threading
import time

import pytest

from ray_tpu.accelerators.tpu import TpuAcceleratorManager
from ray_tpu_torch.accelerators import get_accelerator_manager
from ray_tpu_torch.accelerators.gpu import GpuAcceleratorManager
from ray_tpu_torch.core import serialization

import torch_modes

serialization.register_pickle_by_value(sys.modules[__name__])


class _NoTransport:
    """The TPU manager's metadata transport; these cases make no request."""

    def get(self, *a, **kw):
        raise AssertionError("no metadata request expected")


def _manager(family, env):
    if family == "tpu":
        return TpuAcceleratorManager(env=env, transport=_NoTransport())
    return GpuAcceleratorManager(env=env, device_count=lambda: 4)


@pytest.mark.parametrize("family", ["tpu", "gpu"])
def test_worker_visibility_env(family):
    mgr = _manager(family, {})
    if family == "tpu":
        env = mgr.worker_visibility_env([0, 1, 2, 3], slice_name="s", worker_index=1)
        assert env["TPU_VISIBLE_CHIPS"] == "0,1,2,3"
        assert env["TPU_CHIPS_PER_HOST_BOUNDS"] == "1,1,4"
    else:
        assert mgr.worker_visibility_env(["0", "1", "2", "3"]) == {
            "CUDA_VISIBLE_DEVICES": "0,1,2,3"}
        # A worker that leased no GPU sees none.
        assert mgr.worker_visibility_env([]) == {"CUDA_VISIBLE_DEVICES": ""}


@pytest.mark.parametrize("family", ["tpu", "gpu"])
def test_visible_ids_respect_an_inherited_restriction(family):
    var = "TPU_VISIBLE_CHIPS" if family == "tpu" else "CUDA_VISIBLE_DEVICES"
    restricted = _manager(family, {var: "2,3"})
    unrestricted = _manager(family, {})
    if family == "tpu":
        assert restricted.visible_chip_ids(2) == [2, 3]
        assert unrestricted.visible_chip_ids(4) == [0, 1, 2, 3]
    else:
        assert restricted.visible_gpu_ids(2) == ["2", "3"]
        assert unrestricted.visible_gpu_ids(4) == ["0", "1", "2", "3"]
        # CUDA_VISIBLE_DEVICES may name devices by UUID.
        uuids = _manager(family, {var: "GPU-aa, GPU-bb"})
        assert uuids.visible_gpu_ids(2) == ["GPU-aa", "GPU-bb"]


@pytest.mark.parametrize("family", ["tpu", "gpu"])
def test_set_current_process_visible_accelerators(family):
    touched = (("TPU_VISIBLE_CHIPS", "TPU_CHIPS_PER_HOST_BOUNDS", "TPU_WORKER_ID")
               if family == "tpu" else ("CUDA_VISIBLE_DEVICES",))
    saved = {k: os.environ.get(k) for k in touched}
    mgr = _manager(family, {})
    try:
        mgr.set_current_process_visible_accelerators([1, 3] if family == "tpu" else ["1", "3"])
        var = "TPU_VISIBLE_CHIPS" if family == "tpu" else "CUDA_VISIBLE_DEVICES"
        assert os.environ[var] == "1,3"
    finally:
        # Scrub: a leaked restriction would shrink every raylet spawned later.
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def test_gpu_manager_counts_and_validates():
    mgr = GpuAcceleratorManager(env={}, device_count=lambda: 8)
    assert mgr.get_resource_name() == "GPU"
    assert mgr.get_current_node_num_accelerators() == 8
    assert mgr.validate_resource_request_quantity(0.5) == (True, None)
    assert not mgr.validate_resource_request_quantity(1.5)[0]
    broken = GpuAcceleratorManager(env={}, device_count=lambda: 1 / 0)
    assert broken.get_current_node_num_accelerators() == 0
    # The registry's GPU manager feeds detect_node_resources.
    from ray_tpu_torch.core.resources import detect_node_resources

    n = get_accelerator_manager("GPU").get_current_node_num_accelerators()
    assert detect_node_resources(num_cpus=2).get("GPU", 0.0) == float(n)
    assert detect_node_resources(num_cpus=2, num_gpus=3)["GPU"] == 3.0


# ----------------------------------------------------- leases on a cluster


@pytest.fixture(scope="module")
def gpu_cluster():
    """A port cluster on the CPU whose head declares two GPUs."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.core import runtime_base
    from ray_tpu_torch.core.cluster_runtime import Cluster

    rt.shutdown()
    saved = os.environ.pop("CUDA_VISIBLE_DEVICES", None)
    cluster = torch_modes.boot_cluster(Cluster, num_cpus=4, num_gpus=2)
    runtime_base.set_runtime(cluster.runtime())
    try:
        yield rt, cluster
    finally:
        torch_modes.shutdown_cluster(cluster, rt.shutdown)
        if saved is not None:
            os.environ["CUDA_VISIBLE_DEVICES"] = saved


class _Meeting:
    """Holds its callers until `n` arrived, so their leases overlap."""

    def __init__(self, n):
        self.n, self.count, self.cv = n, 0, threading.Condition()

    def arrive(self):
        with self.cv:
            self.count += 1
            self.cv.notify_all()
            return self.cv.wait_for(lambda: self.count >= self.n, timeout=60)


def _visible_at(meeting, rt):
    met = rt.get(meeting.arrive.remote(), timeout=90) if meeting is not None else True
    return os.environ.get("CUDA_VISIBLE_DEVICES"), met


def _meet(rt, n):
    return rt.remote(max_concurrency=n)(_Meeting).remote(n)


def test_worker_sees_exactly_its_devices(gpu_cluster):
    rt, _ = gpu_cluster
    assert rt.cluster_resources()["GPU"] == 2.0
    one = rt.remote(num_gpus=1)(_visible_at)
    two = rt.remote(num_gpus=2)(_visible_at)
    none = rt.remote(_visible_at)
    assert rt.get(one.remote(None, rt), timeout=60)[0] in ("0", "1")
    assert rt.get(two.remote(None, rt), timeout=60)[0] == "0,1"
    assert rt.get(none.remote(None, rt), timeout=60)[0] == ""
    with pytest.raises(ValueError, match="whole numbers"):
        rt.remote(num_gpus=1.5)(_visible_at).remote(None, rt)


def test_whole_gpu_leases_are_exclusive(gpu_cluster):
    rt, _ = gpu_cluster
    meeting = _meet(rt, 2)
    one = rt.remote(num_gpus=1)(_visible_at)
    try:
        got = rt.get([one.remote(meeting, rt) for _ in range(2)], timeout=120)
    finally:
        rt.kill(meeting)
    assert all(met for _, met in got)
    assert sorted(v for v, _ in got) == ["0", "1"]


def test_fractional_gpu_leases_share_one_device(gpu_cluster):
    rt, _ = gpu_cluster
    meeting = _meet(rt, 2)
    half = rt.remote(num_gpus=0.5)(_visible_at)
    try:
        got = rt.get([half.remote(meeting, rt) for _ in range(2)], timeout=120)
    finally:
        rt.kill(meeting)
    assert all(met for _, met in got)
    assert got[0][0] == got[1][0] and got[0][0] in ("0", "1")


def test_a_third_whole_gpu_task_waits_for_a_free_device(gpu_cluster):
    rt, _ = gpu_cluster
    hold = rt.remote(num_gpus=1)(time.sleep)
    one = rt.remote(num_gpus=1)(_visible_at)
    held = [hold.remote(2.0) for _ in range(2)]
    time.sleep(0.5)
    t0 = time.monotonic()
    visible, _ = rt.get(one.remote(None, rt), timeout=60)
    assert time.monotonic() - t0 > 0.8  # it ran only once a device came back
    rt.get(held, timeout=60)
    assert visible in ("0", "1")


def test_bundles_lease_devices(gpu_cluster):
    rt, _ = gpu_cluster
    pg = rt.placement_group([{"CPU": 1, "GPU": 1}, {"CPU": 1, "GPU": 0.5},
                             {"CPU": 1, "GPU": 0.5}], strategy="PACK")
    assert pg.ready(timeout=30)
    try:
        task = rt.remote(_visible_at)

        def run(i, gpus):
            strategy = rt.PlacementGroupSchedulingStrategy(placement_group=pg,
                                                           placement_group_bundle_index=i)
            return task.options(num_gpus=gpus, scheduling_strategy=strategy).remote(None, rt)

        whole, half_a, half_b = rt.get([run(0, 1), run(1, 0.5), run(2, 0.5)], timeout=60)
        assert whole[0] != half_a[0] and half_a[0] == half_b[0]
        assert {whole[0], half_a[0]} == {"0", "1"}
    finally:
        rt.remove_placement_group(pg)


def test_raylet_clamps_gpu_total_to_visible_ids(gpu_cluster):
    """A raylet started inside a device lease (an inherited
    CUDA_VISIBLE_DEVICES) advertises only the devices it can lease (the
    TPU case: test_accelerators.py:412)."""
    rt, cluster = gpu_cluster
    saved = os.environ.get("CUDA_VISIBLE_DEVICES")
    try:
        os.environ["CUDA_VISIBLE_DEVICES"] = "0,1"  # inherited by the raylet
        nid = cluster.add_node(num_cpus=1, resources={"GPU": 4.0})
    finally:
        if saved is None:
            os.environ.pop("CUDA_VISIBLE_DEVICES", None)
        else:
            os.environ["CUDA_VISIBLE_DEVICES"] = saved
    try:
        node = {n["NodeID"]: n for n in rt.nodes()}[nid]
        assert node["Resources"]["GPU"] == 2.0
    finally:
        cluster.remove_node(nid)


@pytest.mark.parametrize("gpus", [1, 0], ids=["fake_gpu", "no_gpu"])
def test_a_gpu_train_worker_without_cuda_raises(gpu_cluster, gpus):
    """A TorchTrainer worker with use_gpu=True that finds no CUDA device (a
    fake GPU lease here, or none: CUDA_VISIBLE_DEVICES="") raises in its
    distributed setup instead of building a CPU mesh, under gloo too; with
    use_gpu=False the same worker builds its mesh on the CPU."""
    from ray_tpu_torch.parallel.mesh import MeshSpec
    from ray_tpu_torch.train.backend import TorchBackendConfig, coordinator_address
    from ray_tpu_torch.train.worker_group import _TrainWorker

    rt, _ = gpu_cluster
    worker_cls = rt.remote(num_gpus=gpus)(_TrainWorker)
    worker = worker_cls.remote(0, 1)
    try:
        coord = coordinator_address(TorchBackendConfig())
        with pytest.raises(Exception, match="no CUDA device"):
            rt.get(worker.setup_distributed.remote(coord, MeshSpec(), True, "gloo"), timeout=60)
    finally:
        rt.kill(worker)
    if gpus:
        return
    worker = worker_cls.remote(0, 1)
    try:
        coord = coordinator_address(TorchBackendConfig())
        info = rt.get(worker.setup_distributed.remote(coord, MeshSpec(), False, "gloo"),
                      timeout=60)
    finally:
        rt.kill(worker)
    assert info["mesh_devices"] == 1 and info["device"] == "cpu"
