"""Ownership, reference counting, task retries and lineage reconstruction on
the port's cluster runtime against the JAX package's: the cases of
tests/test_recovery.py, each run on both packages with the same functions
and numpy inputs (refcount frees, task outputs freed, in-flight arguments
pinned, a borrowed ref, worker-death retries with and without retries, a
node's death retried elsewhere, a lineage chain two deep, the eager free of
a put that never escaped and the kept object of one that did).

test_recovery.py's `test_actor_pool` and `test_distributed_queue` wait for
the port's utils/actor_pool.py and utils/queue.py (ROADMAP Queue 1 item 3.8).

One cluster of each package serves the whole file (every JAX `Cluster()`
sweeps /dev/shm/rtpu_*, ROADMAP Queue 3). The cases that kill a node add
their own "spot" node under a resource name of their own, so no later case
can land on a node an earlier one left behind.
"""

import os
import sys
import time
import types

import numpy as np
import pytest

import ray_tpu as jrt
import ray_tpu_torch as trt
from ray_tpu import exceptions as jexc
from ray_tpu_torch import exceptions as texc
import torch_modes
from ray_tpu_torch.core import serialization

from torch_waits import wait_for

serialization.register_pickle_by_value(sys.modules[__name__])

PKGS = ("jax", "torch")


@pytest.fixture(scope="module")
def jax_cluster():
    from ray_tpu.core import runtime_base as jbase

    jrt.shutdown()
    jc = torch_modes.boot_jax_cluster(num_cpus=4, num_workers=2)
    try:
        jbase.set_runtime(jc.runtime())
        yield types.SimpleNamespace(rt=jrt, exc=jexc, cluster=jc, base=jbase)
    finally:
        torch_modes.shutdown_cluster(jc, jrt.shutdown)


@pytest.fixture(scope="module")
def torch_cluster():
    from ray_tpu_torch.core import runtime_base as tbase
    from ray_tpu_torch.core.cluster_runtime import Cluster as TorchCluster

    trt.shutdown()
    tc = torch_modes.boot_cluster(TorchCluster, num_cpus=4, num_gpus=0)
    try:
        tbase.set_runtime(tc.runtime())
        yield types.SimpleNamespace(rt=trt, exc=texc, cluster=tc, base=tbase)
    finally:
        torch_modes.shutdown_cluster(tc, trt.shutdown)


@pytest.fixture(params=PKGS)
def c(request):
    """The cluster of the case's package only (one module fixture each)."""
    return request.getfixturevalue(f"{request.param}_cluster")


def _store(c):
    return c.base.current_runtime()._store


# ------------------------------------------------------------------ (a)
def test_refcount_frees_pool_memory(c):
    store = _store(c)
    time.sleep(0.3)
    baseline = store.bytes_in_use()
    ref = c.rt.put(np.zeros(4 << 20, dtype=np.uint8))
    assert store.bytes_in_use() >= baseline + (4 << 20)
    del ref
    assert wait_for(lambda: store.bytes_in_use() <= baseline + (64 << 10), timeout=15), (
        f"pool did not return to baseline: {store.bytes_in_use()} vs {baseline}")


def test_refcount_task_outputs_freed(c):
    rt, store = c.rt, _store(c)

    @rt.remote
    def big():
        return np.ones(2 << 20, dtype=np.uint8)

    time.sleep(0.3)
    baseline = store.bytes_in_use()
    refs = [big.remote() for _ in range(4)]
    vals = rt.get(refs, timeout=60)
    assert all(v.nbytes == (2 << 20) for v in vals)
    del vals, refs
    assert wait_for(lambda: store.bytes_in_use() <= baseline + (256 << 10), timeout=15), (
        f"task outputs not freed: {store.bytes_in_use()} vs baseline {baseline}")


def test_inflight_args_pinned(c):
    rt = c.rt

    @rt.remote
    def slow_identity(x):
        time.sleep(0.5)
        return x

    ref = rt.put(np.arange(1024, dtype=np.int32))
    out = slow_identity.remote(ref)
    del ref  # only the in-flight task holds it now
    assert rt.get(out, timeout=60).sum() == np.arange(1024).sum()


def test_borrowed_ref_defers_owner_free(c):
    rt = c.rt

    @rt.remote
    class Holder:
        def __init__(self):
            self.ref = None

        def hold(self, box):
            self.ref = box[0]  # an ObjectRef passed by value inside a list

        def read(self):
            return int(rt.get(self.ref).sum())

    h = Holder.remote()
    try:
        ref = rt.put(np.ones(1000, dtype=np.int64))
        rt.get(h.hold.remote([ref]), timeout=60)
        time.sleep(0.3)  # let the borrow registration flush
        del ref  # the owner's last ref; the borrow must defer the free
        time.sleep(0.5)
        assert rt.get(h.read.remote(), timeout=10) == 1000
    finally:
        rt.kill(h)


# ------------------------------------------------------------------ (b)
def test_worker_death_retries(c, tmp_path):
    marker = str(tmp_path / "attempt")

    @c.rt.remote
    def flaky():
        if not os.path.exists(marker):
            with open(marker, "w") as f:
                f.write("1")
            os._exit(1)  # a worker crash on the first attempt
        return 42

    assert c.rt.get(flaky.remote(), timeout=30) == 42


def test_worker_death_no_retries_raises(c):
    @c.rt.remote(max_retries=0)
    def die():
        os._exit(1)

    with pytest.raises(c.exc.WorkerCrashedError):
        c.rt.get(die.remote(), timeout=30)


def test_node_death_task_retried_elsewhere(c, tmp_path):
    marker = str(tmp_path / "slow_marker")
    spot = c.cluster.add_node(num_cpus=2, resources={"spot_retry": 1.0})

    @c.rt.remote(resources={"spot_retry": 1.0})
    def compute(path):
        # Slow only on the first run, so the node dies mid-task; the retry
        # on the replacement node is fast.
        if not os.path.exists(path):
            with open(path, "w") as f:
                f.write("1")
            time.sleep(8.0)
        return "done"

    ref = compute.remote(marker)
    assert wait_for(lambda: os.path.exists(marker), timeout=30)
    c.cluster.remove_node(spot)
    spare = c.cluster.add_node(num_cpus=2, resources={"spot_retry": 1.0})
    try:
        assert c.rt.get(ref, timeout=40) == "done"
    finally:
        c.cluster.remove_node(spare)


# ------------------------------------------------------------------ (c)
def test_lineage_reconstruction_two_deep(c):
    rt = c.rt
    spot = c.cluster.add_node(num_cpus=2, resources={"spot_lineage": 1.0})

    @rt.remote(resources={"spot_lineage": 0.4})
    def produce():
        return np.full(1000, 7, dtype=np.int64)

    @rt.remote(resources={"spot_lineage": 0.4})
    def transform(x):
        return x * 2

    a = produce.remote()
    b = transform.remote(a)
    # Both finish on the spot node and are never pulled to the head; the
    # node's death loses both, and b comes back only by rebuilding a first.
    ready, _ = rt.wait([b], num_returns=1, timeout=20)
    assert ready
    c.cluster.remove_node(spot)
    spare = c.cluster.add_node(num_cpus=2, resources={"spot_lineage": 1.0})
    try:
        assert rt.get(b, timeout=60).sum() == 7 * 2 * 1000
    finally:
        c.cluster.remove_node(spare)


def test_eager_free_non_escaped_put(c):
    """An object whose ref never left the process leaves the pool in the
    last ref's drop itself, with no GCS round trip."""
    store = _store(c)
    baseline = store.bytes_in_use()
    ref = c.rt.put(np.zeros(8 << 20, dtype=np.uint8))
    assert store.bytes_in_use() >= baseline + (8 << 20)
    del ref
    assert store.bytes_in_use() <= baseline + (64 << 10)


def test_escaped_put_ref_not_eagerly_freed(c):
    """A ref shipped to a task keeps its object through the GCS's borrow
    grace; the value stays readable while the task runs."""
    rt = c.rt

    @rt.remote
    def consume(x):
        time.sleep(0.5)
        return float(x.sum())

    ref = rt.put(np.ones(1 << 20, dtype=np.float32))
    out_ref = consume.remote(ref)
    del ref  # the task (maybe not yet started) still needs the object
    assert rt.get(out_ref, timeout=60) == float(1 << 20)
