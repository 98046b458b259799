"""The runtime's `raytpu_*` instruments on the port's cluster against the JAX
package's: tests/test_internal_metrics.py's cases `hot_paths_emit_on_two_nodes`,
`flusher_pending_bounded_and_recovers`, `gcs_restart_metrics_keep_flowing` and
`metrics_cli_table`, each run on both packages, and cases in which both
packages must count alike: one `max_restarts` actor killed once, one task
whose worker dies mid-run, N puts into the shared-memory store, and the
recovery line of `status` on a fresh cluster that went through both.

One two-node cluster of each package serves the cluster cases (a module
fixture per package, booted through tests/torch_modes.py); the GCS restart
and the status line boot their own. Functions sent to workers are made
inside the tests: cloudpickle sends them to the JAX workers by value and the
port's serializer sends this module by value.
"""

import contextlib
import importlib
import io
import sys
import time
import types

import numpy as np
import pytest

import torch_modes
from ray_tpu_torch.core import serialization
from torch_waits import wait_for

serialization.register_pickle_by_value(sys.modules[__name__])

PKGS = ("jax", "torch")
ROOT = {"jax": "ray_tpu", "torch": "ray_tpu_torch"}
CASE_LIMIT_S = 180


def _pkg(name):
    mod = lambda m: importlib.import_module(f"{ROOT[name]}.{m}")  # noqa: E731
    return types.SimpleNamespace(
        name=name, rt=importlib.import_module(ROOT[name]), imet=mod("utils.internal_metrics"),
        state=mod("utils.state"), scripts=mod("scripts"), base=mod("core.runtime_base"),
        cluster_mod=mod("core.cluster_runtime"))


def _boot(p, **kw):
    if p.name == "jax":
        return torch_modes.boot_jax_cluster(**kw)
    return torch_modes.boot_cluster(p.cluster_mod.Cluster, num_gpus=0, **kw)


@contextlib.contextmanager
def _own_cluster(p, **kw):
    """A cluster of its own for one case; the module cluster's runtime, if
    any, is current again afterwards."""
    prev = p.base.maybe_runtime()
    cluster = _boot(p, **kw)
    runtime = cluster.runtime()
    p.base.set_runtime(runtime)
    try:
        yield cluster
    finally:
        try:
            torch_modes.shutdown_cluster(cluster, runtime.shutdown)
        finally:
            p.base.set_runtime(prev)


@contextlib.contextmanager
def _two_node(name):
    p = _pkg(name)
    p.rt.shutdown()
    cluster = _boot(p, num_cpus=2)
    try:
        node2 = cluster.add_node(num_cpus=2, resources={"special": 2.0})
        p.base.set_runtime(cluster.runtime())
        yield types.SimpleNamespace(p=p, rt=p.rt, cluster=cluster, node2=node2)
    finally:
        torch_modes.shutdown_cluster(cluster, p.rt.shutdown)


@pytest.fixture(scope="module")
def jax_cluster():
    with _two_node("jax") as c:
        yield c


@pytest.fixture(scope="module")
def torch_cluster():
    with _two_node("torch") as c:
        yield c


@pytest.fixture(params=PKGS)
def c(request):
    cl = request.getfixturevalue(f"{request.param}_cluster")
    with torch_modes.case_time_limit(request, CASE_LIMIT_S):
        yield cl


@pytest.fixture
def both(request, jax_cluster, torch_cluster):
    with torch_modes.case_time_limit(request, 2 * CASE_LIMIT_S):
        yield {"jax": jax_cluster, "torch": torch_cluster}


def _total(state, name):
    """The cluster-wide sum of one instrument's series."""
    return sum(float(m.get("value") or 0.0) for m in state.internal_metrics()
               if m["name"] == name)


def _settled_delta(state, name, before, want, timeout=30.0):
    """Waits for `name` to move `want` past `before`, then two flush
    intervals more, so that a double count would show too."""
    wait_for(lambda: _total(state, name) - before >= want, timeout=timeout, interval=0.25)
    time.sleep(2.5)
    return _total(state, name) - before


# ------------------------------------------------- test_internal_metrics.py
def test_hot_paths_emit_on_two_nodes(c):
    rt, state = c.rt, c.p.state

    def f(x):
        return x + 1

    f = rt.remote(f)
    assert rt.get([f.remote(i) for i in range(10)], timeout=60) == list(range(1, 11))

    class A:
        def ping(self):
            return "pong"

    a = rt.remote(A).remote()
    assert rt.get(a.ping.remote(), timeout=60) == "pong"

    # Cross-node transfer: a node2-pinned task consumes a head-resident object.
    blob = rt.put(b"x" * 200_000)

    def g(b):
        return len(b)

    g = rt.remote(resources={"special": 1.0})(g)
    assert rt.get(g.remote(blob), timeout=60) == 200_000

    want = {"scheduler", "worker_pool", "zygote", "gcs", "object_transport", "reporter"}
    want_names = {"raytpu_sched_dispatch_latency_ms", "raytpu_gcs_rpc_total",
                  "raytpu_object_bytes_in_total", "raytpu_worker_spawn_total"}

    def families():
        recs = state.internal_metrics()
        comps = {m["tags"].get("component") for m in recs}
        names = {m["name"] for m in recs}
        return recs if (want <= comps and want_names <= names) else None

    recs = wait_for(families, timeout=20, interval=0.25)
    assert recs, sorted({m["tags"].get("component") for m in state.internal_metrics()})
    for m in recs:
        assert "component" in m["tags"] and "node_id" in m["tags"], m

    # The worker-pool gauges ride each raylet's heartbeat: both nodes report.
    def pool_nodes():
        nodes = {m["tags"]["node_id"] for m in state.internal_metrics()
                 if m["name"] == "raytpu_worker_pool_idle"}
        return nodes if {c.cluster.head_node_id, c.node2} <= nodes else None

    assert wait_for(pool_nodes, timeout=20, interval=0.25)

    def heartbeat_method_tag():
        return "heartbeat" in {m["tags"].get("method") for m in state.internal_metrics()
                               if m["name"] == "raytpu_gcs_rpc_total"}

    assert wait_for(heartbeat_method_tag, timeout=20, interval=0.25)


@pytest.mark.parametrize("name", PKGS)
def test_flusher_pending_bounded_and_recovers(name, monkeypatch):
    """A down GCS does not grow the pending buffer without limit, and a
    recovered sink receives every kept delta once."""
    imet = _pkg(name).imet
    counter = imet._registry.get("raytpu_test_flush_counter") or imet.Counter(
        "raytpu_test_flush_counter", "test-only", component="test")
    for attr in ("_node_id", "_reporter", "_sink"):
        monkeypatch.setattr(imet, attr, getattr(imet, attr))
    monkeypatch.setattr(imet, "_PENDING_CAP", 37)
    monkeypatch.setattr(imet, "_pending", [])
    fails = {"n": 0}

    def bad_sink(recs):
        fails["n"] += 1
        raise RuntimeError("gcs down")

    imet.configure(node_id="testnode", sink=bad_sink)
    for _ in range(100):
        counter.inc(1.0)
        imet._flush_once()
    assert fails["n"] > 0
    assert len(imet._pending) <= 37

    received = []
    imet.configure(sink=received.extend)
    counter.inc(1.0)
    imet._flush_once()
    mine = [r for r in received if r["name"] == "raytpu_test_flush_counter"]
    assert mine, received
    assert sum(r["value"] for r in mine) <= 101  # drops allowed, duplicates not
    assert all(r["tags"]["node_id"] == "testnode" for r in mine)


@pytest.mark.parametrize("name", PKGS)
def test_gcs_restart_metrics_keep_flowing(name, request):
    p = _pkg(name)
    with torch_modes.case_time_limit(request, CASE_LIMIT_S), \
            _own_cluster(p, num_cpus=2) as cluster:
        def f():
            return 1

        assert p.rt.get(p.rt.remote(f).remote(), timeout=60) == 1
        assert wait_for(lambda: p.state.internal_metrics() or None, timeout=20, interval=0.25)

        cluster.restart_gcs()

        def g():
            return 2

        assert p.rt.get(p.rt.remote(g).remote(), timeout=60) == 2

        def has_sched():
            return any(m["tags"].get("component") == "scheduler"
                       for m in p.state.internal_metrics()) or None

        assert wait_for(has_sched, timeout=20, interval=0.25), \
            "no scheduler metrics after the GCS restart"


@pytest.mark.parametrize("name", PKGS)
def test_metrics_cli_table(name):
    format_metrics_table = _pkg(name).scripts.format_metrics_table
    records = [
        {"name": "raytpu_sched_queue_depth", "kind": "gauge",
         "tags": {"component": "scheduler", "node_id": "n1"}, "value": 2.0},
        {"name": "raytpu_gcs_rpc_latency_ms", "kind": "histogram",
         "tags": {"component": "gcs", "method": "ping", "node_id": "gcs"},
         "value": 9.0, "counts": [3, 1], "boundaries": [1.0]},
    ]
    table = format_metrics_table([("internal", records)])
    lines = table.splitlines()
    assert lines[0].startswith("SOURCE")
    assert "raytpu_sched_queue_depth" in table
    assert "component=scheduler" in table and "node_id=n1" in table
    assert "sum=9 count=4" in table
    name_col = lines[0].index("NAME")
    assert all(ln[name_col - 2:name_col] == "  " for ln in lines[1:]), table


# ------------------------------------------------ counts both packages share
def _restart_once(rt):
    """A max_restarts=1 actor whose process dies once; returns when the
    restarted instance answers."""
    class Flaky:
        def pid(self):
            import os

            return os.getpid()

        def crash(self):
            import os

            os._exit(1)

    a = rt.remote(max_restarts=1)(Flaky).remote()
    first = rt.get(a.pid.remote(), timeout=60)
    with pytest.raises(Exception):
        rt.get(a.crash.remote(), timeout=30)

    def restarted():
        try:
            return rt.get(a.pid.remote(), timeout=10) != first
        except Exception:  # noqa: BLE001 - still restarting
            return False

    assert wait_for(restarted, timeout=60, interval=0.5)
    rt.kill(a)


def _retry_once(rt, marker):
    """A task whose worker exits on its first attempt; returns the retry's value."""
    def flaky():
        import os

        if not os.path.exists(marker):
            with open(marker, "w") as f:
                f.write("1")
            os._exit(1)
        return 42

    return rt.get(rt.remote(flaky).remote(), timeout=60)


def test_actor_restart_counted_once(both):
    seen = {}
    for name, c in both.items():
        before = _total(c.p.state, "raytpu_actor_restarts_total")
        _restart_once(c.rt)
        seen[name] = _settled_delta(c.p.state, "raytpu_actor_restarts_total", before, 1)
    assert seen == {"jax": 1.0, "torch": 1.0}


def test_task_retry_counted_once(both, tmp_path):
    seen = {}
    for name, c in both.items():
        before = _total(c.p.state, "raytpu_tasks_retried_total")
        assert _retry_once(c.rt, str(tmp_path / f"attempt_{name}")) == 42
        seen[name] = _settled_delta(c.p.state, "raytpu_tasks_retried_total", before, 1)
    assert seen == {"jax": 1.0, "torch": 1.0}


def _process_total(imet, instrument):
    """This process's cumulative count of an untagged counter."""
    lane = instrument.labels()
    if hasattr(lane, "read"):
        return lane.read()
    with imet._lock:  # the JAX lane keeps a cell per thread
        return lane._retired + sum(cell[0] for _, cell in lane._cells)


def test_store_puts_counted_in_driver(both):
    n = 7
    seen = {}
    for name, c in both.items():
        imet = c.p.imet
        before = _process_total(imet, imet.STORE_PUTS)
        refs = [c.rt.put(np.full(256 << 10, i, dtype=np.uint8)) for i in range(n)]
        seen[name] = _process_total(imet, imet.STORE_PUTS) - before
        assert [int(c.rt.get(r, timeout=30)[0]) for r in refs] == list(range(n))
    assert seen == {"jax": n, "torch": n}


def test_status_recovery_line_matches(request, tmp_path):
    """`status`'s recovery line on a fresh one-node cluster of each package
    after one actor restart and one task retry."""
    lines = {}
    with torch_modes.case_time_limit(request, 2 * CASE_LIMIT_S):
        for name in PKGS:
            p = _pkg(name)
            with _own_cluster(p, num_cpus=2):
                _restart_once(p.rt)
                assert _retry_once(p.rt, str(tmp_path / f"attempt_{name}")) == 42
                for metric in ("raytpu_actor_restarts_total", "raytpu_tasks_retried_total"):
                    _settled_delta(p.state, metric, 0.0, 1)
                out = io.StringIO()
                with contextlib.redirect_stdout(out):
                    p.scripts._status_tail(p.state.cluster_stats(), p.state)
                lines[name] = [ln for ln in out.getvalue().splitlines()
                               if ln.startswith("recovery:")]
    want = ["recovery: actor_restarts=1 tasks_retried=1 nodes_drained=0 "
            "checkpoints_restored=0 chaos_injections=0"]
    assert lines == {"jax": want, "torch": want}
