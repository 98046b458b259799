"""The anomaly trigger bus, incident bundles and post-mortem reports on the
port (ray_tpu_torch/observability/postmortem.py, the GCS's `_trigger` and
`_harvest`) against the JAX package's (tests/test_postmortem.py), on the
same inputs.

Module cases run each package's function on the same triggers, bundles and
flight dumps, made from a seed with numpy: `publish_trigger`'s per-kind
debounce and its best-effort delivery, `merge_trace` on one synthetic
bundle for several per-node clock offsets (the same events at the same
GCS-clock times, in the same causal order), `infer_suspect` on seeded
manifests and rings, and `render_report` (equal apart from the bundle's
path).

Cluster cases run on both packages, each under its own time limit: a storm
of 50 triggers coalesces into one incident on a bare GCS; the bus turned
off by its env knob; `debug_harvest` stages a bundle on a bare GCS; a node
partitioned from the GCS yields a staged `node.dead` incident with several
processes' rings and a report naming the trigger; and a collective whose
rank 1 stalls past the op timeout yields a `coll.timeout` incident whose
bundle holds both members' rings and whose report names rank 1 as missing.
"""

import importlib
import json
import os
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
SEED = 1016
UNIT_LIMIT_S = 60
CLUSTER_LIMIT_S = 240
_SEEN = {}


def _pm(name):
    return importlib.import_module(f"{ROOT[name]}.observability.postmortem")


def _pkg(name):
    mod = lambda m: importlib.import_module(f"{ROOT[name]}.{m}")  # noqa: E731
    return types.SimpleNamespace(
        name=name, rt=importlib.import_module(ROOT[name]), gcs=mod("core.gcs"),
        pm=_pm(name), frec=mod("observability.flight_recorder"), chaos=mod("chaos"),
        base=mod("core.runtime_base"), state=mod("utils.state"),
        cluster_mod=mod("core.cluster_runtime"))


def _agree(case, name, seen):
    """The port's observation must equal the JAX package's (JAX runs first)."""
    _SEEN.setdefault(case, {})[name] = seen
    if name == "torch" and "jax" in _SEEN[case]:
        assert seen == _SEEN[case]["jax"], f"{case}: the port saw {seen}, JAX {_SEEN[case]['jax']}"


@pytest.fixture(params=PKGS)
def p(request):
    return _pkg(request.param)


@pytest.fixture
def unit_limit(request):
    with torch_modes.case_time_limit(request, UNIT_LIMIT_S):
        yield


@pytest.fixture
def cluster_limit(request):
    with torch_modes.case_time_limit(request, CLUSTER_LIMIT_S):
        yield


# ====================================================== trigger bus (client)
def test_publish_trigger_debounces_per_kind(monkeypatch):
    """A seeded storm of kinds: one forward per kind inside the window, the
    same forwards in both packages."""
    monkeypatch.setenv("RAY_TPU_TRIGGER_DEBOUNCE_S", "30")
    rng = np.random.default_rng(SEED)
    kinds = ["chaos.inject", "coll.timeout", "node.dead"]
    storm = [kinds[k] for k in rng.integers(0, 3, size=200)]
    got = {}
    for name in PKGS:
        pm = _pm(name)
        calls = []
        pm.arm(lambda kind, detail, source, calls=calls: calls.append((kind, detail, source)))
        try:
            for i, kind in enumerate(storm):
                pm.publish_trigger(kind, {"i": i}, source="test")
        finally:
            pm.disarm()
        got[name] = calls
    assert got["torch"] == got["jax"]
    assert [c[0] for c in got["torch"]] == list(dict.fromkeys(storm))


def test_publish_trigger_disarmed_is_noop_and_swallows_errors():
    for name in PKGS:
        pm = _pm(name)
        pm.disarm()
        assert pm.publish_trigger("chaos.inject", None) is None

        def boom(kind, detail, source):
            raise ConnectionError("gcs gone")

        pm.arm(boom)
        try:
            assert pm.publish_trigger("chaos.inject", None) is None
            assert pm.armed()
        finally:
            pm.disarm()
        assert not pm.armed()


# ============================================ clock-skew-corrected merge
def _write_dump(flight_dir, pid, events, dump_us):
    os.makedirs(flight_dir, exist_ok=True)
    with open(os.path.join(flight_dir, f"flight_{pid}_{dump_us}.json"), "w") as f:
        json.dump({"pid": pid, "reason": "test", "dump_us": dump_us, "extra": None,
                   "events": events}, f)


def _synthetic_bundle(name, root, off_a, off_b):
    """tests/test_postmortem.py's causal chain on two nodes whose clocks are
    off by off_a / off_b from the GCS's, staged by `name`'s stage_bundle."""
    pm = _pm(name)
    bundle = os.path.join(root, name, f"inc-{off_a}-{off_b}")
    src_flight = os.path.join(root, name, "src-flight")
    src_spans = os.path.join(root, name, "src-spans")
    t_submit, t_execute = 1_000_000_000, 1_000_500_000
    t_fence, t_marker = 2_000_000_000, 2_000_100_000
    _write_dump(src_flight, 200, [[t_submit - off_b, "sched.submit", "task-1"],
                                  [t_fence - off_b, "node.fence", ["victim", 1, 2]]],
                dump_us=t_marker - off_b)
    _write_dump(src_flight, 100, [[t_execute - off_a, "cgraph.execute", "task-1"]],
                dump_us=t_marker - off_a)
    os.makedirs(src_spans, exist_ok=True)
    with open(os.path.join(src_spans, "spans_100.jsonl"), "w") as f:
        f.write(json.dumps({"span_id": "s1", "name": "task.execute", "pid": 100,
                            "start_us": t_execute - off_a,
                            "end_us": t_execute - off_a + 1000}) + "\n")
        f.write('{"span_id": "torn')  # a torn last line is skipped
    manifest = {
        "incident_id": os.path.basename(bundle), "opened_ts": t_marker / 1e6,
        "triggers": [{"ts": t_marker / 1e6, "ts_us": t_marker, "kind": "node.dead",
                      "detail": "victim", "source": "gcs"}],
        "nodes": {"nodeA": {"offset_us": off_a}, "nodeB": {"offset_us": off_b}},
        "pids": {"100": {"node": "nodeA", "offset_us": off_a},
                 "200": {"node": "nodeB", "offset_us": off_b}},
    }
    pm.stage_bundle(bundle, manifest, flight_src=src_flight, trace_src=src_spans)
    return bundle, (t_submit, t_execute, t_fence)


@pytest.mark.parametrize("off_a,off_b", [(0, 0), (5_000_000, -3_000_000),
                                         (-7_000_000, 2_000_000), (123_456, -654_321)])
def test_merge_trace_restores_causal_order(tmp_path, off_a, off_b):
    """Whatever the per-node offsets, both packages' merges put every event
    at the same GCS-clock time, in the same order: submit before execute,
    fence before the trigger marker."""
    seen = {}
    for name in PKGS:
        bundle, (t_submit, t_execute, t_fence) = _synthetic_bundle(name, str(tmp_path),
                                                                   off_a, off_b)
        trace = _pm(name).merge_trace(bundle)
        with open(os.path.join(bundle, _pm(name).TRACE_NAME)) as f:
            assert json.load(f) == json.loads(json.dumps(trace, default=repr))
        events = [e for e in trace["traceEvents"] if e.get("ph") != "M"]
        ts = {e["name"]: e["ts"] for e in events}
        assert ts["sched.submit"] == t_submit and ts["cgraph.execute"] == t_execute
        assert ts["task.execute"] == t_execute and ts["node.fence"] == t_fence
        names = [e["name"] for e in events]
        assert names.index("sched.submit") < names.index("cgraph.execute")
        assert names.index("node.fence") < names.index("trigger:node.dead")
        seen[name] = [(e["name"], e["ts"], e["ph"], e["pid"], e.get("tid")) for e in events]
    assert seen["torch"] == seen["jax"]


# ==================================================== suspect and report
def _seeded_case(seed):
    """A manifest and flight dumps from a seed: triggers of every suspect
    kind (or none), rings with blocked-looking and plain events."""
    rng = np.random.default_rng(seed)
    kinds = ["coll.timeout", "node.dead", "node.fenced", "chaos.inject", "cgraph.timeout",
             "debug.manual"]
    n_trig = int(rng.integers(0, 3))
    triggers = []
    for i in range(n_trig):
        kind = kinds[rng.integers(len(kinds))]
        detail = ({"group": f"g{i}", "rank": int(rng.integers(4)),
                   "missing": [int(rng.integers(4))]} if kind == "coll.timeout"
                  else {"node_id": f"n{rng.integers(100)}"})
        ts = 1_700_000_000 + float(rng.integers(0, 1000))
        triggers.append({"ts": ts, "ts_us": int(ts * 1e6), "kind": kind, "detail": detail,
                         "source": "gcs"})
    ev_kinds = ["coll.op_wait", "chan.read_wait", "net.drop", "coll.op", "sched.dispatch",
                "chan.write", "node.added"]
    dumps = []
    for pid in rng.choice(np.arange(100, 120), size=int(rng.integers(1, 4)), replace=False):
        events = [[int(1_700_000_000_000_000 + rng.integers(0, 10**9)),
                   ev_kinds[rng.integers(len(ev_kinds))], [f"x{rng.integers(10)}", 1]]
                  for _ in range(int(rng.integers(1, 30)))]
        dumps.append({"pid": int(pid), "reason": "harvest", "dump_us": 1_700_000_001_000_000,
                      "extra": {}, "events": events})
    manifest = {"incident_id": f"inc-{seed}", "opened_ts": triggers[0]["ts"] if triggers
                else 1_700_000_000.0, "triggers": triggers,
                "nodes": {"nodeA": {"offset_us": int(rng.integers(-1000, 1000))}},
                "pids": {str(d["pid"]): {"node": "nodeA",
                                         "offset_us": int(rng.integers(-1000, 1000))}
                         for d in dumps}}
    return manifest, dumps


@pytest.mark.parametrize("seed", range(8))
def test_infer_suspect(seed):
    manifest, dumps = _seeded_case(seed)
    got = {name: _pm(name).infer_suspect(manifest, dumps) for name in PKGS}
    assert got["torch"] == got["jax"]
    assert got["torch"]["kind"] in ("stalled rank", "blocked channel", "node",
                                    "blocked channel/peer", "unknown")


def test_report_names_stalled_rank(tmp_path):
    """test_postmortem.py's suspect case, and seeded bundles: each package's
    render_report of the same bundle is the same text apart from the
    bundle's path."""
    cases = [({"incident_id": "inc-coll", "opened_ts": 1_700_000_000.5,
               "triggers": [{"ts": 1_700_000_000.5, "ts_us": 1_700_000_000_500_000,
                             "kind": "coll.timeout", "source": "collective",
                             "detail": {"group": "ring0", "rank": 2, "missing": [3]}}],
               "nodes": {}, "pids": {}}, [])]
    cases += [_seeded_case(seed) for seed in range(4)]
    for i, (manifest, dumps) in enumerate(cases):
        reports = {}
        for name in PKGS:
            pm = _pm(name)
            src = str(tmp_path / name / f"src{i}")
            for d in dumps:
                _write_dump(src, d["pid"], d["events"], d["dump_us"])
            bundle = str(tmp_path / name / f"b{i}")
            pm.stage_bundle(bundle, manifest, flight_src=src,
                            trace_src=str(tmp_path / "empty"))
            reports[name] = pm.render_report(bundle).replace(bundle, "<bundle>")
        assert reports["torch"] == reports["jax"]
        if i == 0:
            assert "stalled rank" in reports["torch"] and "ring0" in reports["torch"]
            assert "coll.timeout" in reports["torch"]


# ============================================================ bare GCS
def _manifest_keys(manifest):
    """A manifest's keys, the metrics window's `impact_window_s` included
    (the GCS keeps a metrics history in both packages)."""
    return sorted(manifest)


def test_gcs_coalesces_trigger_storm_into_one_incident(p, monkeypatch, tmp_path, unit_limit):
    monkeypatch.setenv("RAY_TPU_FLIGHT_DIR", str(tmp_path / "flight"))
    svc = p.gcs.GcsService(session_dir=str(tmp_path / "session"))
    try:
        harvests = []
        monkeypatch.setattr(svc, "_harvest", lambda iid: harvests.append(iid))
        for i in range(50):
            assert svc.report_trigger("chaos.inject", {"i": i}, "soak")["ok"]
        incidents = svc.list_incidents()
        assert len(incidents) == 1 and incidents[0]["triggers"] == 50
        full = svc.get_incident(incidents[0]["incident_id"])
        assert full["coalesced"] == 49
        assert wait_for(lambda: len(harvests) == 1, timeout=5)
        time.sleep(0.2)
        _agree("storm", p.name, (len(harvests), incidents[0]["trigger"], incidents[0]["state"],
                                 [t["detail"] for t in full["triggers"]][:3]))
    finally:
        svc.stop()
        p.pm.disarm()


def test_gcs_trigger_bus_disabled_env(p, monkeypatch, tmp_path, unit_limit):
    monkeypatch.setenv("RAY_TPU_POSTMORTEM", "0")
    svc = p.gcs.GcsService(session_dir=str(tmp_path / "session"))
    try:
        assert svc.report_trigger("chaos.inject", None, "test") == {"ok": False,
                                                                     "disabled": True}
        assert svc.list_incidents() == []
    finally:
        svc.stop()
        p.pm.disarm()


def test_debug_harvest_stages_bundle_on_bare_gcs(p, monkeypatch, tmp_path, unit_limit):
    monkeypatch.setenv("RAY_TPU_FLIGHT_DIR", str(tmp_path / "flight"))
    monkeypatch.setenv("RAY_TPU_HARVEST_DELAY_S", "0")
    svc = p.gcs.GcsService(session_dir=str(tmp_path / "session"))
    try:
        p.frec.record("node.added", ("test", 1))
        res = svc.debug_harvest(timeout_s=30.0)
        assert res["ok"], res
        bundle = res["bundle"]
        manifest = p.pm.load_manifest(bundle)
        assert manifest["incident_id"] == res["incident"]
        assert manifest["triggers"][0]["kind"] == "debug.manual"
        assert str(os.getpid()) in manifest["pids"]
        assert os.path.isfile(os.path.join(bundle, p.pm.TRACE_NAME))
        dumps = p.frec.collect(os.path.join(bundle, "flight"))
        assert any(d.get("pid") == os.getpid() for d in dumps)
        report = p.pm.render_report(bundle)
        assert "debug.manual" in report and res["incident"] in report
        root = p.pm.incidents_dir(str(tmp_path / "session"))
        assert p.pm.find_bundle(res["incident"][:16], [root]) == bundle
        assert p.pm.list_bundles(root)[0]["incident_id"] == res["incident"]
        _agree("debug_harvest", p.name, (_manifest_keys(manifest), sorted(os.listdir(bundle))))
    finally:
        svc.stop()
        p.pm.disarm()


# ============================================================== clusters
def _boot(p, **kwargs):
    p.rt.shutdown()
    if p.name == "jax":
        cluster = torch_modes.boot_jax_cluster(**kwargs)
    else:
        cluster = p.cluster_mod.Cluster(num_gpus=0, **kwargs)
    runtime = cluster.runtime()
    p.base.set_runtime(runtime)
    return cluster, runtime


def _teardown(p, cluster, runtime):
    try:
        runtime.shutdown()
    finally:
        cluster.shutdown()
        p.base.set_runtime(None)
        p.pm.disarm()


def _staged(gcs, kind):
    for inc in gcs.call("list_incidents"):
        if inc["state"] == "staged" and inc["trigger"] == kind and inc["bundle"]:
            return inc
    return None


def test_partition_produces_incident_bundle(p, monkeypatch, tmp_path, cluster_limit):
    """A node cut off from the GCS until it is declared dead: the node.dead
    trigger yields a staged bundle on its own, with the rings of at least
    two processes, a merged trace holding the trigger's marker and a report
    naming it; the state API reads the incident."""
    monkeypatch.setenv("RAY_TPU_FLIGHT_DIR", str(tmp_path / "flight"))
    monkeypatch.setenv("RAY_TPU_HEARTBEAT_INTERVAL_S", "0.25")
    monkeypatch.setenv("RAY_TPU_HEARTBEAT_TIMEOUT_S", "1.5")
    monkeypatch.setenv("RAY_TPU_HARVEST_DELAY_S", "0.2")
    cluster, runtime = _boot(p, num_cpus=2)
    try:
        workers = [cluster.add_node(num_cpus=2, resources={"ctr": 1.0}) for _ in range(2)]
        gcs = runtime._gcs
        victim = workers[0]

        def alive(nid):
            return {n["NodeID"]: n for n in gcs.call("list_nodes")}[nid]["Alive"]

        part = p.chaos.partition([[victim], ["gcs"]], heal_after=60.0, runtime=runtime)
        try:
            assert wait_for(lambda: not alive(victim), timeout=20)
            inc = wait_for(lambda: _staged(gcs, "node.dead"), timeout=30, interval=0.1)
            assert inc, gcs.call("list_incidents")
        finally:
            part.heal()
        bundle = inc["bundle"]
        manifest = p.pm.load_manifest(bundle)
        kinds = [t["kind"] for t in manifest["triggers"]]
        assert "node.dead" in kinds
        pids = {d.get("pid") for d in p.frec.collect(os.path.join(bundle, "flight"))}
        assert len(pids) >= 2, pids
        assert len(manifest["nodes"]) >= 2, manifest["nodes"]
        with open(os.path.join(bundle, p.pm.TRACE_NAME)) as f:
            trace = json.load(f)
        assert any(str(e.get("name", "")).startswith("trigger:node.dead")
                   for e in trace["traceEvents"])
        report = p.pm.render_report(bundle)
        assert "node.dead" in report and inc["incident_id"] in report
        assert any(i["incident_id"] == inc["incident_id"] for i in p.state.list_incidents())
        assert p.state.get_incident(inc["incident_id"])["state"] == "staged"
        _agree("partition", p.name, (kinds[0], _manifest_keys(manifest),
                                     sorted(os.listdir(bundle))))
    finally:
        p.chaos.disable()
        _teardown(p, cluster, runtime)


def _member_class(root):
    class Member:
        def pid(self):
            return os.getpid()

        def reduce(self, v, stall_s=0.0):
            import numpy as _np

            if stall_s:
                time.sleep(stall_s)  # rank 1 never joins this op
                return ("stalled",)
            coll = importlib.import_module(f"{root}.collective")
            exc = importlib.import_module(f"{root}.exceptions")
            try:
                return ("ok", float(coll.allreduce(_np.array([v], dtype=_np.float32),
                                                   "pmgrp")[0]))
            except exc.CollectiveTimeoutError as e:
                return ("timeout", e.group, e.rank, list(e.missing))

    return Member


def test_stalled_collective_incident_names_rank(p, monkeypatch, tmp_path, cluster_limit):
    """Two actors in a collective group; rank 1 sleeps past the op timeout:
    rank 0 gets CollectiveTimeoutError, its coll.timeout trigger opens one
    incident, the harvest SIGUSR2s both actors (older than 5 s) and their
    rings are in the bundle, the merged trace holds the marker, and the
    report names rank 1 as the one missing."""
    monkeypatch.setenv("RAY_TPU_FLIGHT_DIR", str(tmp_path / "flight"))
    monkeypatch.setenv("RAY_TPU_COLLECTIVE_TIMEOUT_S", "10")
    monkeypatch.setenv("RAY_TPU_COLLECTIVE_OP_TIMEOUT_S", "2")
    cluster, runtime = _boot(p, num_cpus=4)
    rt = p.rt
    try:
        coll = importlib.import_module(f"{ROOT[p.name]}.collective")
        Member = rt.remote(_member_class(ROOT[p.name]))
        members = [Member.remote() for _ in range(2)]
        pids = rt.get([m.pid.remote() for m in members], timeout=60)
        coll.create_collective_group(members, "pmgrp")
        assert [r[0] for r in rt.get([m.reduce.remote(1.0) for m in members],
                                     timeout=60)] == ["ok", "ok"]
        time.sleep(5.2)  # the raylet signals no worker younger than 5 s
        stalled = members[1].reduce.remote(1.0, stall_s=6.0)
        r0 = rt.get(members[0].reduce.remote(1.0), timeout=60)
        assert r0[0] == "timeout" and r0[2] == 0 and r0[3] == [1], r0
        gcs = runtime._gcs
        inc = wait_for(lambda: _staged(gcs, "coll.timeout"), timeout=30, interval=0.1)
        assert inc, gcs.call("list_incidents")
        manifest = p.pm.load_manifest(inc["bundle"])
        assert {str(x) for x in pids} <= set(manifest["pids"]), (pids, manifest["pids"])
        rings = {d["pid"] for d in p.frec.collect(os.path.join(inc["bundle"], "flight"))}
        assert set(pids) <= rings, (pids, rings)
        with open(os.path.join(inc["bundle"], p.pm.TRACE_NAME)) as f:
            trace = json.load(f)
        assert any(e.get("name") == "trigger:coll.timeout" for e in trace["traceEvents"])
        report = p.pm.render_report(inc["bundle"])
        assert "stalled rank" in report and "'missing': [1]" in report, report[:600]
        rt.get(stalled, timeout=60)
        _agree("stalled", p.name, (r0, inc["triggers"], manifest["triggers"][0]["detail"]))
    finally:
        _teardown(p, cluster, runtime)
