"""The port's cluster runtime (ray_tpu_torch/core/{gcs,raylet,worker_proc,
cluster_runtime}.py) against the JAX package's, case by case: the cases of
tests/test_cluster.py that one machine's cluster covers (tasks and chained
deps, put/get, errors, actors and named actors, nested tasks, wait, actor
restart after a crash, runtime context ids, dedupe, placement groups,
spread and node affinity, spillback and cross-node transfer on a two-node
Cluster, node failure), each run on both packages with the same functions
and numpy inputs.

One two-node cluster of each package serves the whole file (a module fixture
per package, booted on its first case): every JAX `Cluster()` sweeps
/dev/shm/rtpu_* and can unlink a starting node's pool in another test
process (ROADMAP Queue 3), so the JAX cluster boots once, through
tests/torch_modes.py's `boot_jax_cluster`. Test functions are defined inside the tests: cloudpickle sends
them to the JAX workers and the port's serializer by value to its own.
"""

import sys
import time
import types

import numpy as np
import pytest

import ray_tpu as jrt
import ray_tpu_torch as trt
import torch_modes
from ray_tpu_torch.core import serialization

serialization.register_pickle_by_value(sys.modules[__name__])

PKGS = ("jax", "torch")


@pytest.fixture(scope="module")
def jax_cluster():
    from ray_tpu.core import runtime_base as jbase

    jrt.shutdown()
    jc = torch_modes.boot_jax_cluster(num_cpus=2, num_workers=2)
    try:
        jn2 = jc.add_node(num_cpus=2, resources={"special": 2.0})
        jbase.set_runtime(jc.runtime())
        yield types.SimpleNamespace(rt=jrt, cluster=jc, node2=jn2, base=jbase)
    finally:
        torch_modes.shutdown_cluster(jc, jrt.shutdown)


@pytest.fixture(scope="module")
def torch_cluster():
    from ray_tpu_torch.core import runtime_base as tbase
    from ray_tpu_torch.core.cluster_runtime import Cluster as TorchCluster

    trt.shutdown()
    tc = torch_modes.boot_cluster(TorchCluster, num_cpus=2, num_gpus=0)
    try:
        tn2 = tc.add_node(num_cpus=2, resources={"special": 2.0})
        tbase.set_runtime(tc.runtime())
        yield types.SimpleNamespace(rt=trt, cluster=tc, node2=tn2, base=tbase)
    finally:
        torch_modes.shutdown_cluster(tc, trt.shutdown)


@pytest.fixture(params=PKGS)
def c(request):
    """The cluster of the case's package only: a failed boot of one package
    errors that package's cases and no others. A hang (a JAX-side case once
    held its xdist worker until the whole run was cut; ROADMAP Queue 3)
    fails its case instead."""
    cl = request.getfixturevalue(f"{request.param}_cluster")
    with torch_modes.case_time_limit(request, 180):
        yield cl


def test_tasks_and_chained_deps(c):
    rt = c.rt

    @rt.remote
    def add(a, b):
        return a + b

    ref = add.remote(1, 2)
    assert rt.get(ref, timeout=60) == 3
    assert rt.get(add.remote(ref, 10), timeout=60) == 13


def test_put_get_numpy_roundtrip(c):
    arr = np.arange(50000, dtype=np.float64)
    np.testing.assert_array_equal(c.rt.get(c.rt.put(arr)), arr)


def test_task_error_propagates(c):
    rt = c.rt

    @rt.remote
    def boom():
        raise ValueError("kapow")

    with pytest.raises(Exception, match="kapow"):
        rt.get(boom.remote(), timeout=60)


def test_actor_lifecycle_and_named(c):
    rt = c.rt

    @rt.remote
    class Counter:
        def __init__(self, start=0):
            self.n = start

        def inc(self):
            self.n += 1
            return self.n

    actor = Counter.options(name="the_counter").remote(10)
    try:
        assert rt.get(actor.inc.remote(), timeout=60) == 11
        again = rt.get_actor("the_counter")
        assert rt.get(again.inc.remote(), timeout=60) == 12
    finally:
        rt.kill(actor)


def test_nested_tasks(c):
    rt = c.rt

    @rt.remote
    def inner(x):
        return x * 2

    @rt.remote
    def outer(x):
        return rt.get(inner.remote(x)) + 1

    assert rt.get(outer.remote(5), timeout=90) == 11


def test_wait_semantics(c):
    rt = c.rt

    @rt.remote
    def fast():
        return 1

    @rt.remote
    def slow():
        time.sleep(3)
        return 2

    ready, pending = rt.wait([slow.remote(), fast.remote()], num_returns=1, timeout=30)
    assert len(ready) == 1 and len(pending) == 1


def test_spillback_to_feasible_node(c):
    rt = c.rt

    @rt.remote(resources={"special": 1.0})
    def on_special():
        return rt.get_runtime_context().get_node_id()

    assert rt.get(on_special.remote(), timeout=90) == c.node2


def test_cross_node_object_transfer(c):
    rt = c.rt

    @rt.remote(resources={"special": 1.0})
    def produce():
        return np.arange(10000)

    @rt.remote(num_cpus=1)
    def consume(arr):
        return int(arr.sum())

    assert rt.get(consume.remote(produce.remote()), timeout=120) == 49995000


def test_actor_restart_after_crash(c):
    rt = c.rt

    @rt.remote(max_restarts=1)
    class Flaky:
        def __init__(self):
            self.n = 0

        def crash(self):
            import os

            os._exit(1)

        def ok(self):
            self.n += 1
            return self.n

    f = Flaky.remote()
    try:
        assert rt.get(f.ok.remote(), timeout=60) == 1
        with pytest.raises(Exception):
            rt.get(f.crash.remote(), timeout=30)
        deadline = time.time() + 30
        result = None
        while time.time() < deadline:
            try:
                result = rt.get(f.ok.remote(), timeout=10)
                break
            except Exception:
                time.sleep(0.5)
        assert result == 1  # restarted fresh: state reset
    finally:
        rt.kill(f)


def test_node_failure_fails_tasks_not_cluster(c):
    rt, cluster = c.rt, c.cluster
    before = sum(1 for n in rt.nodes() if n["Alive"])
    doomed = cluster.add_node(num_cpus=1, resources={"doomed": 1.0})

    @rt.remote(resources={"doomed": 1.0})
    def stuck():
        time.sleep(60)
        return "never"

    ref = stuck.remote()
    time.sleep(2)  # let it dispatch to the doomed node
    cluster.remove_node(doomed)

    @rt.remote
    def alive():
        return "yes"

    assert rt.get(alive.remote(), timeout=60) == "yes"
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        if sum(1 for n in rt.nodes() if n["Alive"]) == before:
            break
        time.sleep(0.2)
    assert sum(1 for n in rt.nodes() if n["Alive"]) == before
    del ref


def test_placement_group_spread_across_nodes(c):
    rt = c.rt
    pg = rt.placement_group([{"CPU": 1}, {"CPU": 1}], strategy="STRICT_SPREAD")
    assert pg.ready(timeout=30)
    assert len(set(pg.bundle_placements.values())) == 2
    rt.remove_placement_group(pg)


def _settled_cpus(rt, want, timeout=15.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if rt.available_resources().get("CPU", 0) == pytest.approx(want):
            break
        time.sleep(0.2)
    return rt.available_resources().get("CPU", 0)


def test_placement_group_enforced_and_durable(c):
    """Bundle pinning holds for tasks and actors, and the reservation survives
    raylet heartbeats (it lives on the raylet, not in the GCS view)."""
    rt = c.rt
    expected = sum((n.get("Resources") or {}).get("CPU", 0.0) for n in rt.nodes() if n["Alive"])
    total_cpu = _settled_cpus(rt, expected)
    pg = rt.placement_group([{"CPU": 1}, {"CPU": 1}], strategy="STRICT_SPREAD")
    assert pg.ready(timeout=30)
    time.sleep(2.5)  # two heartbeat periods
    assert rt.available_resources().get("CPU", 0) == pytest.approx(total_cpu - 2)

    @rt.remote
    def where():
        return rt.get_runtime_context().get_node_id()

    def in_bundle(i):
        return rt.PlacementGroupSchedulingStrategy(placement_group=pg,
                                                   placement_group_bundle_index=i)

    nodes = rt.get([where.options(scheduling_strategy=in_bundle(i)).remote() for i in range(2)],
                   timeout=60)
    assert nodes == [pg.bundle_placements[0], pg.bundle_placements[1]]

    @rt.remote
    class WhereActor:
        def node(self):
            return rt.get_runtime_context().get_node_id()

    actors = [WhereActor.options(num_cpus=1, scheduling_strategy=in_bundle(i)).remote()
              for i in range(2)]
    anodes = rt.get([a.node.remote() for a in actors], timeout=60)
    assert anodes == [pg.bundle_placements[0], pg.bundle_placements[1]]
    for a in actors:
        rt.kill(a)
    rt.remove_placement_group(pg)
    assert _settled_cpus(rt, total_cpu, timeout=10) == pytest.approx(total_cpu)


def test_removed_pg_task_fails_fast(c):
    """A task pinned to a removed placement group raises instead of hanging."""
    rt = c.rt
    pg = rt.placement_group([{"CPU": 1}], strategy="PACK")
    assert pg.ready(timeout=10)
    strat = rt.PlacementGroupSchedulingStrategy(placement_group=pg,
                                                placement_group_bundle_index=0)

    @rt.remote
    def oversize():
        return 1

    with pytest.raises(Exception, match="only reserves"):
        rt.get(oversize.options(num_cpus=2, scheduling_strategy=strat).remote(), timeout=30)
    rt.remove_placement_group(pg)
    time.sleep(0.2)

    @rt.remote
    def pinned():
        return 2

    with pytest.raises(Exception, match="not\\b.*(reserved|schedulable)|removed"):
        rt.get(pinned.options(scheduling_strategy=strat).remote(), timeout=30)


def test_spread_scheduling_strategy(c):
    rt = c.rt

    @rt.remote(num_cpus=1)
    def where():
        return rt.get_runtime_context().get_node_id()

    seen = set(rt.get([where.options(scheduling_strategy="SPREAD").remote() for _ in range(8)],
                      timeout=60))
    assert len(seen) == 2, f"SPREAD used only nodes {seen}"


def test_node_affinity_hard_and_soft(c):
    rt, node2 = c.rt, c.node2
    nodes = {n["NodeID"] for n in rt.nodes() if n["Alive"]}
    assert node2 in nodes

    @rt.remote(num_cpus=1)
    def where():
        return rt.get_runtime_context().get_node_id()

    hard = rt.NodeAffinitySchedulingStrategy(node_id=node2, soft=False)
    got = rt.get([where.options(scheduling_strategy=hard).remote() for _ in range(3)], timeout=60)
    assert set(got) == {node2}
    bogus = rt.NodeAffinitySchedulingStrategy(node_id="f" * 32, soft=False)
    with pytest.raises(Exception, match="NodeAffinity"):
        rt.get(where.options(scheduling_strategy=bogus).remote(), timeout=30)
    soft = rt.NodeAffinitySchedulingStrategy(node_id="f" * 32, soft=True)
    assert rt.get(where.options(scheduling_strategy=soft).remote(), timeout=30) in nodes


def test_runtime_context_task_ids(c):
    rt = c.rt

    @rt.remote
    def ctx():
        cx = rt.get_runtime_context()
        return (cx.get_node_id(), cx.get_task_id(), cx.get_actor_id())

    node_id, task_id, actor_id = rt.get(ctx.remote(), timeout=60)
    assert node_id and task_id and actor_id is None

    @rt.remote
    class A:
        def ids(self):
            cx = rt.get_runtime_context()
            return (cx.get_task_id(), cx.get_actor_id())

    a = A.remote()
    try:
        task_id, actor_id = rt.get(a.ids.remote(), timeout=60)
        assert task_id and actor_id
    finally:
        rt.kill(a)
    driver = rt.get_runtime_context()
    assert driver.get_node_id() and driver.get_task_id() is None


def test_duplicate_submit_is_deduped(c, tmp_path):
    """A reconnect-resend duplicate of a one-way submit must not run the task
    twice: the raylet's ingress dedupes on (task_id, attempt)."""
    rt = c.rt
    runtime = c.base.current_runtime()
    runtime._fastpath._disabled = True  # force the raylet submit path
    raylet = runtime._raylet
    orig_notify = raylet.notify
    marker = tmp_path / "count.txt"

    def double_notify(method, *a, **kw):
        orig_notify(method, *a, **kw)
        if method in ("submit_task", "submit_task_batch"):
            orig_notify(method, *a, **kw)

    raylet.notify = double_notify

    @rt.remote
    def bump(path):
        with open(path, "a") as f:
            f.write("x")
        return 1

    try:
        assert rt.get(bump.remote(str(marker)), timeout=60) == 1
        time.sleep(1.0)  # a duplicate execution would land in this window
    finally:
        raylet.notify = orig_notify
        runtime._fastpath._disabled = False
    assert marker.read_text() == "x"


def test_cluster_task_imports_no_jax(torch_cluster):
    """The port's worker processes load neither jax nor ray_tpu. They fork
    from the zygote, which imported torch without initialising CUDA."""
    rt = torch_cluster.rt

    @rt.remote
    def modules():
        import torch

        loaded = sorted({m.split(".")[0] for m in sys.modules} & {"jax", "ray_tpu", "torch"})
        return loaded, torch.cuda.is_initialized()

    assert rt.get(modules.remote(), timeout=60) == (["torch"], False)


def test_a_ref_collected_under_the_ref_lock_does_not_deadlock(torch_cluster):
    """A garbage collection can run an ObjectRef's finalizer on a thread that
    holds the runtime's reference lock; the drop is queued, not taken on the
    held lock (the JAX copy deadlocks there: ROADMAP Queue 3), and the free
    loop applies it."""
    import gc

    c = torch_cluster
    runtime = c.base.current_runtime()

    class Cycle:
        pass

    cyc = Cycle()
    cyc.me, cyc.ref = cyc, c.rt.put(np.arange(10))
    h = cyc.ref.hex()
    assert h in runtime._owned
    del cyc
    with runtime._ref_lock:
        gc.collect()  # the ref's finalizer runs here, on the lock's holder
    deadline = time.monotonic() + 10
    while h in runtime._owned and time.monotonic() < deadline:
        time.sleep(0.05)
    assert h not in runtime._owned
