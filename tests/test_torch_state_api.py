"""The state API on the port's cluster runtime (ray_tpu_torch/utils/state.py
over core/gcs.py) against the JAX package's: tests/test_state_api.py's
cases that need no dashboard and no log monitor (a task's print in the
session logs, list_tasks and cluster_stats, actor restarts, nodes and
objects, the timeline, user metrics), then a worker's `raytpu_*` counter in
`internal_metrics()` and an uncaught task exception in `cluster_errors()`
and on the `error_reports` channel, each run on both packages with the same
functions and inputs. Values and orders must be equal; where a record
carries times or ids, its keys and states are compared.

One cluster of each package serves the file (a module fixture per package;
the JAX one booted through tests/torch_modes.py's `boot_jax_cluster`), so
the table assertions count at least what each case added.
"""

import importlib
import json
import os
import sys
import time
import types

import numpy as np
import pytest

import ray_tpu as jrt
import ray_tpu_torch as trt
import torch_modes
from ray_tpu_torch.core import serialization
from torch_waits import wait_for

serialization.register_pickle_by_value(sys.modules[__name__])

PKGS = ("jax", "torch")
_SEEN = {}


@pytest.fixture(scope="module")
def jax_cluster():
    from ray_tpu.core import runtime_base as jbase

    jrt.shutdown()
    jc = torch_modes.boot_jax_cluster(num_cpus=4, num_workers=2)
    try:
        jbase.set_runtime(jc.runtime())
        yield types.SimpleNamespace(name="jax", rt=jrt, cluster=jc, base=jbase)
    finally:
        torch_modes.shutdown_cluster(jc, jrt.shutdown)


@pytest.fixture(scope="module")
def torch_cluster():
    from ray_tpu_torch.core import runtime_base as tbase
    from ray_tpu_torch.core.cluster_runtime import Cluster

    trt.shutdown()
    tc = torch_modes.boot_cluster(Cluster, num_cpus=4, num_gpus=0, num_workers=2)
    try:
        tbase.set_runtime(tc.runtime())
        yield types.SimpleNamespace(name="torch", rt=trt, cluster=tc, base=tbase)
    finally:
        torch_modes.shutdown_cluster(tc, trt.shutdown)


@pytest.fixture(params=PKGS)
def c(request):
    c = request.getfixturevalue(f"{request.param}_cluster")
    c.state = importlib.import_module(f"{c.rt.__name__}.utils.state")
    c.pubsub = importlib.import_module(f"{c.rt.__name__}.utils.pubsub")
    return c


def _agree(case, name, seen):
    _SEEN.setdefault(case, {})[name] = seen
    if name == "torch" and "jax" in _SEEN[case]:
        assert seen == _SEEN[case]["jax"], f"{case}: the port saw {seen}, JAX {_SEEN[case]['jax']}"


def test_task_print_lands_in_session_logs(c):
    rt = c.rt

    @rt.remote
    def chatty():
        print("hello-from-task-xyzzy", flush=True)
        return 1

    assert rt.get(chatty.remote(), timeout=60) == 1
    assert wait_for(lambda: any("hello-from-task-xyzzy" in data
                                for data in c.state.read_worker_logs().values()), timeout=10)
    assert os.path.basename(c.state.log_dir()) == "logs"


def test_list_tasks_and_stats(c):
    rt = c.rt

    @rt.remote
    def work(i):
        return i

    refs = [work.remote(i) for i in range(5)]
    assert rt.get(refs, timeout=60) == [0, 1, 2, 3, 4]
    assert wait_for(lambda: sum(1 for t in c.state.list_tasks()
                                if t["state"] == "FINISHED") >= 5, timeout=10)
    stats = c.state.cluster_stats()
    assert stats["tasks"].get("FINISHED", 0) >= 5
    assert stats["nodes_alive"] >= 1
    assert stats["store"]["num_objects"] >= 0
    # A return's object id starts with its task's id (the first 12 bytes).
    prefixes = {r.hex()[:24] for r in refs}

    def mine():
        return [t for t in c.state.list_tasks() if t["task_id"][:24] in prefixes
                and t["state"] == "FINISHED"]

    assert wait_for(lambda: len(mine()) == 5, timeout=10)
    rec = c.state.get_task(mine()[0]["task_id"])
    seen = {"stats_keys": sorted(stats), "store_keys": sorted(stats["store"]),
            "record_keys": sorted({"task_id", "state", "name", "ts", "node", "history"}
                                  & set(rec)),
            "states": [t["state"] for t in mine()],
            "history_ends": [t["history"][-1][0] for t in mine()],
            "on_head": [t["node"] == c.base.current_runtime().node_id() for t in mine()]}
    _agree("list_tasks", c.name, seen)


def test_list_actors_shows_restarts(c):
    rt = c.rt

    @rt.remote(max_restarts=1)
    class Fragile:
        def pid(self):
            return os.getpid()

        def die(self):
            os._exit(1)

    a = Fragile.remote()
    pid1 = rt.get(a.pid.remote(), timeout=60)
    try:
        rt.get(a.die.remote(), timeout=30)
    except Exception:  # noqa: BLE001 - the actor's death is the point
        pass
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        try:
            if rt.get(a.pid.remote(), timeout=10) != pid1:
                break
        except Exception:  # noqa: BLE001 - still restarting
            time.sleep(0.5)
    actors = c.state.list_actors()
    restarted = [x for x in actors if x["num_restarts"] == 1 and x["state"] == "ALIVE"]
    assert restarted, actors
    crash = wait_for(lambda: [e for e in c.state.cluster_errors()
                              if e["type"] == "worker_crash"], timeout=10)
    seen = {"actor_keys": sorted(restarted[0]), "max_restarts": restarted[0]["max_restarts"],
            "crash_keys": sorted(k for k in crash[-1] if k != "pid"),
            "crash_error": crash[-1]["error"].split(" (exit")[0]}
    _agree("restarts", c.name, seen)
    rt.kill(a)


def test_list_nodes_and_objects(c):
    ref = c.rt.put(np.arange(100))
    nodes = c.state.list_nodes()
    assert all("Available" in n and "Stats" in n for n in nodes)
    assert wait_for(lambda: any(o["object_id"] == ref.hex()
                                for o in c.state.list_objects(limit=10000)), timeout=10)
    obj = next(o for o in c.state.list_objects(limit=10000) if o["object_id"] == ref.hex())
    summary = c.state.node_summary()
    seen = {"nodes": len(nodes), "states": [n["State"] for n in nodes],
            "object": {k: v for k, v in obj.items() if k != "object_id"} | {
                "locations": obj["locations"] == [c.base.current_runtime().node_id()]},
            "summary": {k: summary[k] for k in ("total", "alive", "draining", "by_state")},
            "cpus": summary["resources"]["CPU"]}
    assert seen["summary"] == {"total": 1, "alive": 1, "draining": 0, "by_state": {"ALIVE": 1}}
    _agree("nodes_objects", c.name, seen)
    del ref


def test_timeline_export(c, tmp_path):
    rt = c.rt

    @rt.remote
    def slow_work():
        time.sleep(0.2)
        return 1

    refs = [slow_work.remote() for _ in range(3)]
    assert rt.get(refs, timeout=60) == [1, 1, 1]
    ids = {r.id().task_id().hex()[:8] for r in refs}

    def mine():
        return [e for e in c.state.timeline() if e.get("cat") == "task" and e["tid"] in ids]

    # The JAX test's own check: the export holds finished task spans.
    assert wait_for(lambda: len(c.state.timeline()) >= 3, timeout=10)
    out = str(tmp_path / "trace.json")
    events = c.state.timeline(out)
    assert len(events) >= 3
    ev = next(e for e in events if e["cat"] == "task")
    assert ev["ph"] == "X" and ev["dur"] > 0
    with open(out) as f:
        assert len(json.load(f)) == len(events)
    if c.name == "torch":
        # The port's direct calls report their span too (the JAX copy's
        # report only their end, so a leased task has no span there).
        assert wait_for(lambda: len(mine()) == 3, timeout=10)
        assert all(e["ph"] == "X" and e["dur"] >= 0.15e6 for e in mine()), mine()
    seen = (sorted(ev), ev["cat"], ev["ph"], ev["args"]["state"])
    _agree("timeline", c.name, seen)


def test_user_metrics_counter_gauge_histogram(c):
    """Application metrics flow worker -> GCS -> state API."""
    rt = c.rt

    @rt.remote
    def work(pkg, i):
        metrics = importlib.import_module(f"{pkg}.utils.metrics")
        metrics.Counter("app_requests", tag_keys=("route",)).inc(2.0, tags={"route": "a"})
        metrics.Gauge("app_depth").set(float(i))
        metrics.Histogram("app_latency", boundaries=[0.1, 1.0, 10.0]).observe(0.5)
        metrics._flush_once()  # deterministic: no wait for the 1 s flusher
        return True

    assert all(rt.get([work.remote(rt.__name__, i) for i in range(3)], timeout=60))
    found = {}
    deadline = time.time() + 10
    while time.time() < deadline:
        found = {(m["name"], tuple(sorted(m["tags"].items()))): m
                 for m in c.state.user_metrics()}
        if (("app_requests", (("route", "a"),)) in found and ("app_latency", ()) in found
                and found[("app_requests", (("route", "a"),))]["value"] == 6.0):
            break
        time.sleep(0.2)
    counter = found[("app_requests", (("route", "a"),))]
    assert counter["value"] == 6.0  # 3 tasks x inc(2)
    hist = found[("app_latency", ())]
    assert sum(hist["counts"]) == 3 and hist["counts"][1] == 3  # all in (0.1, 1.0]
    gauge = found[("app_depth", ())]
    assert gauge["kind"] == "gauge" and gauge["value"] >= 0.0
    seen = (counter["value"], counter["kind"], hist["counts"], hist["value"],
            hist["boundaries"], gauge["kind"])
    _agree("user_metrics", c.name, seen)


def test_worker_internal_counter_reaches_the_gcs(c):
    """A `raytpu_*` counter bumped in a worker process reaches the driver's
    `internal_metrics()` through that worker's flusher, with its component
    and node tags."""
    rt = c.rt

    @rt.remote
    def bump(pkg):
        imet = importlib.import_module(f"{pkg}.utils.internal_metrics")
        imet.CHAOS_INJECTIONS.inc(point="state_api_probe", action="count")
        return os.getpid()

    pids = set(rt.get([bump.remote(rt.__name__) for _ in range(3)], timeout=60))
    assert os.getpid() not in pids

    def record():
        return [m for m in c.state.internal_metrics()
                if m["name"] == "raytpu_chaos_injections_total"
                and m["tags"].get("point") == "state_api_probe"]

    recs = wait_for(lambda: [m for m in record() if m["value"] == 3.0], timeout=15)
    assert recs, record()
    node = c.base.current_runtime().node_id()
    seen = (recs[0]["kind"], recs[0]["value"],
            {k: (v == node if k == "node_id" else v) for k, v in recs[0]["tags"].items()})
    assert seen == ("counter", 3.0, {"point": "state_api_probe", "action": "count",
                                     "component": "chaos", "node_id": True})
    _agree("internal_metrics", c.name, seen)


def test_uncaught_task_exception_reaches_cluster_errors(c):
    """An uncaught task exception is reported by its worker: it is in
    `cluster_errors()` and on the `error_reports` channel."""
    rt = c.rt
    sub = c.pubsub.subscribe("error_reports")

    @rt.remote
    def boom_state_api():
        raise ValueError("kapow-state-api")

    with pytest.raises(Exception, match="kapow-state-api"):
        rt.get(boom_state_api.remote(), timeout=60)
    got = []
    deadline = time.time() + 15
    while not any("kapow-state-api" in m.get("error", "") for m in got) \
            and time.time() < deadline:
        got += sub.poll(timeout=1.0)
    published = [m for m in got if "kapow-state-api" in m.get("error", "")]
    table = [e for e in c.state.cluster_errors() if "kapow-state-api" in e.get("error", "")]
    assert len(published) == 1 and len(table) == 1, (got, table)
    assert "Traceback" in table[0]["traceback"] and "boom_state_api" in table[0]["task"]
    seen = (sorted(table[0]), table[0]["type"], table[0]["actor_id"],
            table[0]["node_id"] == c.base.current_runtime().node_id(),
            sorted(published[0]) == sorted(table[0]))
    _agree("errors", c.name, seen)
