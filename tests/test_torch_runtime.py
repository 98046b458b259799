"""The port's in-process runtime side by side with the JAX package's.

Every test runs twice, once on `ray_tpu.init(local_mode=True)` and once on
`ray_tpu_torch.init(local_mode=True)`, with the same functions and the
same seeded inputs, and asserts the same outcome: tasks, actors, named
actors, `get`/`wait` with timeouts, ObjectRef streaming and placement
groups (the cases of tests/test_core_api.py that local mode covers, its
streaming cases included). Every wait has a deadline, and every runtime is
shut down in a `finally`.
"""

import os
import threading
import time

import numpy as np
import pytest

import ray_tpu
import ray_tpu_torch
from torch_waits import bounded

PACKAGES = {"jax": ray_tpu, "torch": ray_tpu_torch}


@pytest.fixture(params=sorted(PACKAGES))
def rt(request):
    pkg = PACKAGES[request.param]
    pkg.shutdown()
    pkg.init(local_mode=True, num_cpus=8)
    try:
        yield pkg
    finally:
        pkg.shutdown()


def test_put_get(rt):
    assert rt.get(rt.put(42), timeout=10) == 42
    arr = np.random.default_rng(0).standard_normal(100_000).astype(np.float32)
    np.testing.assert_array_equal(rt.get(rt.put(arr), timeout=10), arr)
    with pytest.raises(TypeError):
        rt.put(rt.put(1))


def test_tasks_options_dependencies_and_multiple_returns(rt):
    @rt.remote
    def add(a, b):
        return a + b

    @rt.remote(num_cpus=2)
    def inc(x):
        return x + 1

    @rt.remote(num_returns=3)
    def three():
        return 1, 2, 3

    @rt.remote
    def combine(a, b, c=0):
        return a + b + c

    assert rt.get(add.remote(1, 2), timeout=10) == 3
    ref = inc.options(num_cpus=1).remote(0)
    for _ in range(10):
        ref = inc.remote(ref)
    assert rt.get(ref, timeout=10) == 11
    assert rt.get(list(three.remote()), timeout=10) == [1, 2, 3]
    assert rt.get(combine.remote(rt.put(1), 2, c=rt.put(3)), timeout=10) == 6
    with pytest.raises(TypeError, match="cannot be called directly"):
        add(1, 2)


def test_task_error_propagates_through_dependencies(rt):
    @rt.remote
    def boom():
        raise ValueError("kapow")

    @rt.remote
    def dependent(x):
        return x

    with pytest.raises(rt.exceptions.TaskError, match="kapow"):
        rt.get(boom.remote(), timeout=10)
    with pytest.raises(rt.exceptions.TaskError, match="kapow"):
        rt.get(dependent.remote(boom.remote()), timeout=10)


# Module-level, so the JAX package's runtime (which cloudpickles task
# functions) pickles them by reference and not the events they read.
_RELEASE = threading.Event()
_GO = [threading.Event() for _ in range(3)]


def _blocked(t):
    _RELEASE.wait(timeout=t)
    return t


def _gated():
    for i, ev in enumerate(_GO):
        assert ev.wait(timeout=10)
        yield i


def test_get_and_wait_honour_their_timeouts(rt):
    _RELEASE.clear()
    blocked = rt.remote(_blocked)
    try:
        slow = blocked.remote(10.0)
        fast = blocked.remote(0.0)
        t0 = time.monotonic()
        with pytest.raises(rt.exceptions.GetTimeoutError):
            rt.get(slow, timeout=0.1)
        ready, pending = rt.wait([fast, slow], num_returns=1, timeout=2.0)
        assert ready == [fast] and pending == [slow]
        ready, pending = rt.wait([slow], num_returns=1, timeout=0.1)
        assert ready == [] and pending == [slow]
        assert time.monotonic() - t0 < 5.0
        with pytest.raises(ValueError):
            rt.wait([fast], num_returns=2)
    finally:
        _RELEASE.set()
    assert rt.get(slow, timeout=10) == 10.0


def test_actor_ordering_errors_and_death(rt):
    @rt.remote
    class Counter:
        def __init__(self, start=0):
            self.n = start

        def inc(self, k=1):
            self.n += k
            return self.n

        def fail(self):
            raise RuntimeError("nope")

    c = Counter.remote(10)
    assert rt.get([c.inc.remote() for _ in range(5)], timeout=10) == [11, 12, 13, 14, 15]
    with pytest.raises(rt.exceptions.TaskError, match="nope"):
        rt.get(c.fail.remote(), timeout=10)
    assert rt.get(c.inc.remote(0), timeout=10) == 15  # survives method errors
    rt.kill(c)
    with pytest.raises(rt.exceptions.ActorDiedError):
        rt.get(c.inc.remote(), timeout=10)


def test_named_actors_and_handle_passing(rt):
    @rt.remote
    class Store:
        def __init__(self):
            self.v = {}

        def set(self, k, v):
            self.v[k] = v
            return True

        def get(self, k):
            return self.v.get(k)

    @rt.remote
    def writer(store, k, v):
        return rt.get(store.set.remote(k, v), timeout=10)

    Store.options(name="reg").remote()
    s = rt.get_actor("reg")
    assert rt.get(writer.remote(s, "x", 99), timeout=10)
    assert rt.get(s.get.remote("x"), timeout=10) == 99
    with pytest.raises(ValueError):
        rt.get_actor("missing")
    with pytest.raises(ValueError, match="already taken"):
        Store.options(name="reg").remote()


def test_nested_tasks_and_max_concurrency(rt):
    @rt.remote
    def leaf(x):
        return x * 2

    @rt.remote
    def parent(x):
        return rt.get(leaf.remote(x), timeout=10) + 1

    @rt.remote(max_concurrency=4)
    class Par:
        def __init__(self):
            self.barrier = threading.Barrier(4, timeout=5)

        def meet(self):
            return self.barrier.wait()  # raises unless 4 calls run at once

    assert rt.get(parent.remote(10), timeout=10) == 21
    p = Par.remote()
    assert sorted(rt.get([p.meet.remote() for _ in range(4)], timeout=10)) == [0, 1, 2, 3]


def test_cluster_resources_and_reinit_guard(rt):
    assert rt.cluster_resources()["CPU"] == 8
    assert rt.available_resources()["CPU"] == 8
    assert rt.is_initialized()
    with pytest.raises(RuntimeError):
        rt.init(local_mode=True)
    rt.init(local_mode=True, ignore_reinit_error=True)


def test_placement_groups(rt):
    with pytest.raises(ValueError, match="unknown strategy"):
        rt.placement_group([{"CPU": 1}], strategy="NOPE")
    with pytest.raises(ValueError):
        rt.placement_group([])
    pg = rt.placement_group([{"CPU": 1}, {"CPU": 2}], strategy="SPREAD")
    assert pg.ready(timeout=10) and pg.wait(timeout_seconds=10)
    assert pg.bundle_count == 2 and pg.strategy == "SPREAD"

    @rt.remote
    def where():
        return "ran"

    strategy = rt.PlacementGroupSchedulingStrategy(pg, placement_group_bundle_index=1)
    assert rt.get(where.options(scheduling_strategy=strategy).remote(), timeout=10) == "ran"
    rt.remove_placement_group(pg)


def test_runtime_context_in_driver_and_task(rt):
    ctx = rt.get_runtime_context()
    assert ctx.get_task_id() is None

    @rt.remote
    def who():
        return rt.get_runtime_context().get_actor_id()

    assert rt.get(who.remote(), timeout=10) is None


def test_streaming_task_and_actor(rt):
    @rt.remote(num_returns="streaming")
    def gen(n):
        for i in range(n):
            yield i * 10

    @rt.remote(num_returns="streaming")
    def empty():
        return
        yield  # pragma: no cover

    @rt.remote(num_returns="streaming")
    def bad():
        yield 1
        raise ValueError("boom")

    @rt.remote
    class A:
        def stream(self, n):
            for i in range(n):
                yield i + 100

    assert bounded(lambda: [rt.get(r, timeout=10) for r in gen.remote(5)]) == [0, 10, 20, 30, 40]
    assert bounded(lambda: list(empty.remote())) == []
    it = iter(bad.remote())
    assert rt.get(bounded(lambda: next(it)), timeout=10) == 1
    with pytest.raises(rt.exceptions.TaskError, match="boom"):
        rt.get(bounded(lambda: next(it)), timeout=10)
    g = A.remote().stream.options(num_returns="streaming").remote(3)
    assert bounded(lambda: [rt.get(r, timeout=10) for r in g]) == [100, 101, 102]


def test_stream_is_incremental(rt):
    for ev in _GO:
        ev.clear()
    try:
        it = iter(rt.remote(num_returns="streaming")(_gated).remote())
        _GO[0].set()
        assert rt.get(bounded(lambda: next(it)), timeout=10) == 0  # before items 1 and 2 exist
        _GO[1].set()
        _GO[2].set()
        assert bounded(lambda: [rt.get(r, timeout=10) for r in it]) == [1, 2]
    finally:
        for ev in _GO:
            ev.set()


def test_init_without_local_mode_is_refused_by_the_port():
    """init() without local_mode starts the port's cluster, as the JAX
    package's does (ray_tpu/api.py): a GCS, a raylet and worker processes,
    torn down again by shutdown(). An address attaches to a running head: a
    tcp:// one as a remote client (tests/test_torch_tcp_cluster.py), a
    session dir as a driver (tests/test_torch_autoscaler.py); anything else
    is refused."""
    from ray_tpu_torch.core.cluster_runtime import ClusterRuntime

    ray_tpu_torch.shutdown()
    rt = ray_tpu_torch.init(num_cpus=1, num_gpus=0)
    try:
        assert isinstance(rt, ClusterRuntime) and ray_tpu_torch.is_initialized()
        assert ray_tpu_torch.cluster_resources() == {"CPU": 1.0}
        pid = ray_tpu_torch.get(ray_tpu_torch.remote(os.getpid).remote(), timeout=60)
        assert pid != os.getpid()
        procs = list(rt._cluster._procs.values())
    finally:
        ray_tpu_torch.shutdown()
    assert not ray_tpu_torch.is_initialized()
    assert all(p.poll() is not None for p in procs)
    with pytest.raises(ValueError, match="tcp://host:port"):
        ray_tpu_torch.init("/tmp/not-a-head.sock")
    assert not ray_tpu_torch.is_initialized()
    assert not ray_tpu_torch.is_initialized()


def test_port_counts_cuda_devices_and_num_gpus_overrides():
    """The port's node resources: CUDA devices as GPU (none here), and
    num_gpus= in their place, as num_tpus= overrides the TPU count in the
    JAX package; a task asking for a GPU then runs."""
    import torch

    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(local_mode=True, num_cpus=2)
    try:
        assert ray_tpu_torch.cluster_resources().get("GPU", 0) == torch.cuda.device_count()
    finally:
        ray_tpu_torch.shutdown()
    ray_tpu_torch.init(local_mode=True, num_cpus=2, num_gpus=2)
    try:
        assert ray_tpu_torch.cluster_resources()["GPU"] == 2

        @ray_tpu_torch.remote(num_gpus=1)
        def on_gpu():
            return "ran"

        assert ray_tpu_torch.get(on_gpu.remote(), timeout=10) == "ran"
    finally:
        ray_tpu_torch.shutdown()


@ray_tpu_torch.remote
def _one():
    return 1


@ray_tpu_torch.remote
def _holds_a_ref():
    return [_one.remote()]


def test_dropping_a_value_that_holds_refs_does_not_deadlock():
    """The last ref to a stored value that holds ObjectRefs frees the value,
    whose refs then release themselves through the same runtime: the port
    lets the value go after its object lock (the JAX package's local mode
    frees it under the lock and deadlocks, so only the port runs here)."""
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(local_mode=True, num_cpus=2)
    try:
        def drop():
            ref = _holds_a_ref.remote()
            inner = ray_tpu_torch.get(ref, timeout=10)
            assert ray_tpu_torch.get(inner[0], timeout=10) == 1
            del inner
            del ref  # the store held the list's only other reference
            return ray_tpu_torch.get(_one.remote(), timeout=10)

        assert bounded(drop, 30) == 1
    finally:
        ray_tpu_torch.shutdown()
