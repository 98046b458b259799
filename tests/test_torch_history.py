"""Metrics history, SLO watchdogs and the sampling profiler on the port
(ray_tpu_torch/observability/{history,watchdog}.py,
ray_tpu_torch/utils/sampling_profiler.py, the GCS's history feed, heartbeat
lag, alerts and incident metrics window) against the JAX package's
(tests/test_metrics_history.py's history, watchdog and profiler cases), on
the same samples and clocks.

Each module case runs both packages' functions on the same inputs (the
seeded ones made with numpy) and holds the port's query outputs, alert
sequences, percentiles and rule sets equal to JAX's. The GCS cases run an
in-process `GcsService` of each package: a counter's rate query across two
flushes; a registered node that never beats, whose heartbeat-lag alert lands
on `node_events` with a flight dump and opens a `watchdog.alert` incident;
and a harvest whose bundle's `metrics.json` and manifest goodput are not
empty. The cases that need the dashboard, the autoscaler or the CLI are in
tests/test_torch_jobs.py and tests/test_torch_autoscaler.py.
"""

import importlib
import json
import os
import threading
import time
import types

import numpy as np
import pytest

import torch_modes
from torch_waits import wait_for

PKGS = ("jax", "torch")
ROOT = {"jax": "ray_tpu", "torch": "ray_tpu_torch"}
SEED = 1017
GCS_LIMIT_S = 90


def _pkg(name):
    mod = lambda m: importlib.import_module(f"{ROOT[name]}.{m}")  # noqa: E731
    return types.SimpleNamespace(
        name=name, history=mod("observability.history"), watchdog=mod("observability.watchdog"),
        perfetto=mod("observability.perfetto"), profiler=mod("utils.sampling_profiler"),
        imet=mod("utils.internal_metrics"), gcs=mod("core.gcs"), pm=mod("observability.postmortem"))


def _both(fn):
    """fn(package namespace) for each package: {name: result}."""
    return {name: fn(_pkg(name)) for name in PKGS}


def _equal(got):
    assert got["torch"] == got["jax"], f"the port gave {got['torch']}, JAX {got['jax']}"
    return got["torch"]


@pytest.fixture
def gcs_limit(request):
    with torch_modes.case_time_limit(request, GCS_LIMIT_S):
        yield


# ================================================================ history
def test_ring_eviction_and_counter_rollup():
    def run(p):
        h = p.history.MetricsHistory(resolution_s=0.0, fine_samples=5, rollup_s=10.0,
                                     coarse_samples=4)
        for i in range(25):
            h.observe("c", "counter", {"node_id": "n1"}, float(i), ts=1000.0 + i)
        return h.query("c")

    [series] = _equal(_both(run))
    samples = series["samples"]
    assert [s[0] for s in samples[-5:]] == [1000.0 + i for i in range(20, 25)]
    coarse = samples[:-5]
    assert coarse and len(coarse) <= 4 and coarse[-1][1] == 19.0
    assert [s[1] for s in samples] == sorted(s[1] for s in samples)


def test_rollup_gauge_mean():
    def run(p):
        h = p.history.MetricsHistory(resolution_s=0.0, fine_samples=2, rollup_s=100.0,
                                     coarse_samples=4)
        for i, v in enumerate([0.0, 10.0, 20.0, 30.0]):
            h.observe("g", "gauge", {}, v, ts=float(i))
        return h.query("g")

    [series] = _equal(_both(run))
    coarse = series["samples"][:-2]
    assert len(coarse) == 1 and coarse[0][1] == pytest.approx(5.0)


def test_resolution_dedup_newest_wins():
    def run(p):
        h = p.history.MetricsHistory(resolution_s=1.0, fine_samples=100)
        for v, ts in ((1.0, 100.0), (2.0, 100.4), (3.0, 101.5)):
            h.observe("c", "counter", {}, v, ts=ts)
        return h.query("c")

    [series] = _equal(_both(run))
    assert [(s[0], s[1]) for s in series["samples"]] == [(100.4, 2.0), (101.5, 3.0)]


def test_histogram_samples_carry_count_and_sum():
    def run(p):
        h = p.history.MetricsHistory(resolution_s=0.0)
        h.observe("lat", "histogram", {}, 10.0, hist_sum=100.0, ts=1.0)
        h.observe("lat", "histogram", {}, 30.0, hist_sum=500.0, ts=2.0)
        return h.query("lat"), h.query("lat", as_rate=True)

    [series], [rates] = _equal(_both(run))
    assert series["samples"] == [[1.0, 10.0, 100.0], [2.0, 30.0, 500.0]]
    assert rates["samples"] == [[2.0, 20.0, 400.0]]


def test_window_and_tag_filters_and_rate():
    def run(p):
        h = p.history.MetricsHistory(resolution_s=0.0)
        for i in range(10):
            h.observe("c", "counter", {"node_id": "a"}, float(i * 2), ts=100.0 + i)
            h.observe("c", "counter", {"node_id": "b"}, float(i * 3), ts=100.0 + i)
        return (h.query("c", tags={"node_id": "a"}),
                h.query("c", tags={"node_id": "a"}, window_s=3.0, now=109.0),
                h.query("c", tags={"node_id": "b"}, as_rate=True))

    only_a, windowed, rate = _equal(_both(run))
    assert len(only_a) == 1 and only_a[0]["tags"] == {"node_id": "a"}
    assert [s[0] for s in windowed[0]["samples"]] == [106.0, 107.0, 108.0, 109.0]
    assert all(v == pytest.approx(3.0) for _, v in rate[0]["samples"])


def test_max_series_bound():
    def run(p):
        h = p.history.MetricsHistory(resolution_s=0.0, max_series=3)
        for i in range(10):
            h.observe(f"m{i}", "counter", {}, 1.0, ts=1.0)
        return h.series_count(), h.dropped_series

    assert _equal(_both(run)) == (3, 7)


def test_merge_series_aggregation():
    series = [{"samples": [[0.0, 1.0], [1.0, 3.0], [4.0, 10.0]]},
              {"samples": [[0.5, 2.0], [4.5, 20.0]]}]
    got = _equal(_both(lambda p: [p.history.merge_series(series, bucket_s=2.0, agg=a)
                                  for a in ("sum", "mean", "max")]))
    merged, merged_mean, merged_max = got
    assert merged[0] == (0.0, pytest.approx(4.0)) and merged[-1] == (4.0, pytest.approx(30.0))
    assert merged_mean[0] == (0.0, pytest.approx(2.0))
    assert merged_max[0] == (0.0, pytest.approx(3.0))
    assert merged_max[-1] == (4.0, pytest.approx(20.0))


@pytest.mark.parametrize("seed", range(4))
def test_seeded_streams_query_alike(seed):
    """Seeded streams of counters, gauges and histograms, several tag sets,
    irregular clocks and small rings: every query, windowed or as rates, and
    the merged lines are equal."""
    rng = np.random.default_rng(SEED + seed)
    n = 300
    kinds = rng.choice(["counter", "gauge", "histogram"], size=n)
    names = rng.choice(["a", "b", "c"], size=n)
    nodes = rng.choice(["n1", "n2"], size=n)
    dts = rng.exponential(0.3, size=n)
    vals = rng.uniform(0.0, 50.0, size=n)
    res = float(rng.choice([0.0, 0.2, 1.0]))
    fine, rollup, coarse = int(rng.integers(3, 20)), float(rng.choice([2.0, 5.0])), int(
        rng.integers(2, 6))

    def run(p):
        h = p.history.MetricsHistory(resolution_s=res, fine_samples=fine, rollup_s=rollup,
                                     coarse_samples=coarse, max_series=5)
        totals, ts = {}, 1000.0
        for i in range(n):
            ts += float(dts[i])
            key = (names[i], kinds[i], nodes[i])
            if kinds[i] == "gauge":
                h.observe(f"m_{names[i]}_{kinds[i]}", "gauge", {"node_id": str(nodes[i])},
                          float(vals[i]), ts=ts)
                continue
            cnt, tot = totals.get(key, (0.0, 0.0))
            totals[key] = (cnt + 1.0, tot + float(vals[i]))
            h.observe(f"m_{names[i]}_{kinds[i]}", str(kinds[i]), {"node_id": str(nodes[i])},
                      totals[key][0],
                      hist_sum=totals[key][1] if kinds[i] == "histogram" else None, ts=ts)
        out = [h.query(), h.query(as_rate=True), h.query(window_s=10.0, now=ts),
               h.query(tags={"node_id": "n1"}, as_rate=True), h.dropped_series]
        out.append([h.latest(f"m_{x}_gauge", window_s=30.0, now=ts) for x in "abc"])
        out.append(p.history.merge_series(h.query(), bucket_s=3.0, agg="max"))
        return out

    got = _equal(_both(run))
    assert got[0]


# ================================================================ watchdog
def _history_with(p, name, kind, values, t0=1000.0, tags=None):
    h = p.history.MetricsHistory(resolution_s=0.0)
    for i, v in enumerate(values):
        h.observe(name, kind, tags or {}, v, ts=t0 + i)
    return h


def test_default_rules_equal():
    got = _equal(_both(lambda p: p.watchdog.DEFAULT_RULES))
    assert [r["name"] for r in got] == ["heartbeat_lag", "cgraph_execute_p99", "goodput_floor",
                                        "serve_ttft_p99", "data_backpressure",
                                        "kv_pool_exhausted"]


def test_watchdog_threshold_fires_and_clears():
    def run(p):
        h = _history_with(p, "g", "gauge", [1.0, 2.0, 9.0])
        events, dumps = [], []
        w = p.watchdog.Watchdog(
            h, publish=events.append,
            rules=[p.watchdog.Rule(name="hi", metric="g", stat="value", op=">", threshold=5.0,
                                   window_s=10.0)],
            dump_fn=lambda **kw: dumps.append(kw) or "/tmp/d.json")
        seq = [w.poll_once(now=1003.0), w.active_alerts(), w.poll_once(now=1004.0)]
        h.observe("g", "gauge", {}, 1.0, ts=1020.0)
        seq += [w.poll_once(now=1025.0), w.active_alerts(), dumps, events]
        return seq

    fired, active, again, cleared, after, dumps, events = _equal(_both(run))
    assert fired[0]["state"] == "firing" and fired[0]["value"] == 9.0
    assert fired[0]["flight_dump"] == "/tmp/d.json" and "hi" in dumps[0]["reason"]
    assert active[0]["rule"] == "hi" and again == []
    assert cleared[0]["state"] == "cleared" and after == [] and len(dumps) == 1
    assert [e["state"] for e in events] == ["firing", "cleared"]


def test_watchdog_for_s_debounce():
    def run(p):
        w = p.watchdog.Watchdog(
            _history_with(p, "g", "gauge", [9.0]), publish=lambda e: None,
            rules=[p.watchdog.Rule(name="hi", metric="g", stat="value", op=">", threshold=5.0,
                                   window_s=60.0, for_s=5.0)],
            dump_fn=lambda **kw: None)
        return [w.poll_once(now=t) for t in (1001.0, 1003.0, 1007.0)]

    first, second, third = _equal(_both(run))
    assert first == [] and second == [] and third[0]["state"] == "firing"


def test_watchdog_absence_rule():
    def run(p):
        h = _history_with(p, "hb", "gauge", [1.0])
        w = p.watchdog.Watchdog(h, publish=lambda e: None,
                                rules=[p.watchdog.Rule(name="gone", metric="hb", kind="absence",
                                                       window_s=10.0)],
                                dump_fn=lambda **kw: None)
        w2 = p.watchdog.Watchdog(h, publish=lambda e: None,
                                 rules=[p.watchdog.Rule(name="ghost", metric="never_seen",
                                                        kind="absence", window_s=1.0)],
                                 dump_fn=lambda **kw: None)
        return [w.poll_once(now=1005.0), w.poll_once(now=1020.0), w2.poll_once(now=5000.0)]

    fresh, fired, ghost = _equal(_both(run))
    assert fresh == [] and ghost == []
    assert fired[0]["rule"] == "gone" and fired[0]["value"] == 20.0


def test_watchdog_percentile_rule():
    def run(p):
        box = {"counts": [100, 0, 0, 0]}

        def metrics_fn():
            return [{"name": "lat_ms", "kind": "histogram", "tags": {"graph": "g1"},
                     "boundaries": [10.0, 100.0, 1000.0], "counts": list(box["counts"])}]

        w = p.watchdog.Watchdog(
            p.history.MetricsHistory(resolution_s=0.0), publish=lambda e: None,
            rules=[p.watchdog.Rule(name="p99", metric="lat_ms", stat="p99", op=">",
                                   threshold=500.0, window_s=30.0)],
            metrics_fn=metrics_fn, dump_fn=lambda **kw: None)
        seq = [w.poll_once(now=1000.0), w.poll_once(now=1001.0)]
        box["counts"] = [100, 0, 0, 90]
        seq.append(w.poll_once(now=1002.0))
        return seq

    base, fine, fired = _equal(_both(run))
    assert base == [] and fine == []
    assert fired[0]["state"] == "firing" and fired[0]["value"] == pytest.approx(1000.0)


@pytest.mark.parametrize("seed", range(3))
def test_seeded_alert_sequences_equal(seed):
    """Seeded gauge, counter and histogram streams under rules of every stat
    and kind, polled on a seeded clock: the same alert events, in order."""
    rng = np.random.default_rng(SEED + 100 + seed)
    steps = 60
    gauge = rng.uniform(0.0, 10.0, size=steps)
    incs = rng.integers(0, 6, size=steps)
    lat = rng.choice([5.0, 50.0, 500.0, 5000.0], p=[0.5, 0.3, 0.15, 0.05], size=(steps, 4))
    boundaries = [10.0, 100.0, 1000.0]

    def run(p):
        wd, hist = p.watchdog, p.history.MetricsHistory(resolution_s=0.0)
        counts = [0, 0, 0, 0]
        rules = [wd.Rule(name="g", metric="g", stat="value", op=">", threshold=7.0,
                         window_s=5.0, for_s=float(seed)),
                 wd.Rule(name="lo", metric="g", stat="value", op="<", threshold=1.0,
                         window_s=5.0),
                 wd.Rule(name="r", metric="c", stat="rate", op=">", threshold=3.0, window_s=4.0),
                 wd.Rule(name="m", metric="lat", stat="mean", op=">", threshold=300.0,
                         window_s=6.0),
                 wd.Rule(name="p", metric="lat", stat="p90", op=">", threshold=500.0,
                         window_s=6.0),
                 wd.Rule(name="gone", metric="g", kind="absence", window_s=3.0)]
        w = wd.Watchdog(hist, publish=lambda e: None, rules=rules,
                        metrics_fn=lambda: [{"name": "lat", "kind": "histogram", "tags": {},
                                             "boundaries": boundaries, "counts": list(counts)}],
                        dump_fn=lambda **kw: "/tmp/d.json")
        total_c = total_n = total_s = 0.0
        events = []
        for i in range(steps):
            now = 1000.0 + i
            if i < 45 or i > 52:  # a gap: the absence rule's window
                hist.observe("g", "gauge", {}, float(gauge[i]), ts=now)
            total_c += float(incs[i])
            hist.observe("c", "counter", {}, total_c, ts=now)
            for v in lat[i]:
                counts[int(np.searchsorted(boundaries, v))] += 1
                total_n, total_s = total_n + 1.0, total_s + float(v)
            hist.observe("lat", "histogram", {}, total_n, hist_sum=total_s, ts=now)
            events += [(e["rule"], e["state"], e["value"], e["ts"]) for e in w.poll_once(now=now)]
        return events, w.active_alerts()

    events, active = _equal(_both(run))
    assert events


def test_percentile_from_buckets():
    def run(p):
        f = p.watchdog.percentile_from_buckets
        rng = np.random.default_rng(SEED)
        fixed = [f([1, 5, 10], [10, 0, 0, 0], 0.99), f([1, 5, 10], [0, 0, 0, 10], 0.5),
                 f([1, 5, 10], [5, 5, 0, 0], 0.5), f([1, 5, 10], [0, 0, 0, 0], 0.99)]
        seeded = [f(sorted(rng.uniform(0, 100, size=5).tolist()),
                    rng.integers(0, 20, size=6).tolist(), float(q))
                  for q in rng.uniform(0.01, 1.0, size=40)]
        return fixed, seeded

    fixed, _ = _equal(_both(run))
    assert fixed == [1, 10, 1, None]


def test_rules_from_env(monkeypatch):
    def rules(p):
        return [tuple(sorted(vars(r).items())) for r in p.watchdog.rules_from_env()]

    monkeypatch.delenv("RAY_TPU_WATCHDOG_RULES", raising=False)
    defaults = _equal(_both(rules))
    assert {dict(r)["name"] for r in defaults} >= {"heartbeat_lag", "cgraph_execute_p99",
                                                  "goodput_floor", "serve_ttft_p99"}
    monkeypatch.setenv("RAY_TPU_WATCHDOG_RULES", json.dumps(
        [{"name": "mine", "metric": "m", "threshold": 1.0}, {"defaults": True}]))
    extended = _equal(_both(rules))
    assert dict(extended[0])["name"] == "mine" and len(extended) == 1 + len(defaults)
    for bad, err in (([{"name": "bad"}], TypeError),
                     ([{"name": "bad", "metric": "m", "stat": "p42"}], ValueError),
                     ({"name": "x"}, ValueError)):
        monkeypatch.setenv("RAY_TPU_WATCHDOG_RULES", json.dumps(bad))
        for name in PKGS:
            with pytest.raises(err):
                _pkg(name).watchdog.rules_from_env()


# ============================================================ the gauge flag
def test_gauge_set_once_ships_on_one_flush():
    """`Gauge.set(..., once=True)` ships the value on one flush and then stops;
    a plain set is re-sent every flush."""
    def run(p):
        g = p.imet.Gauge(f"raytpu_test_once_{p.name}_gauge", "test gauge", component="test",
                         tag_keys=("trial",))
        lane = g.labels(trial="t")
        seq = []
        lane.set(0.25, once=True)
        seq += [lane._delta(), lane._delta()]
        lane.set(0.5)
        seq += [lane._delta(), lane._delta()]
        g.set(0.75, once=True, trial="t")
        seq += [lane._delta(), lane._delta()]
        return seq

    seq = _equal(_both(run))
    assert seq == [{"value": 0.25}, None, {"value": 0.5}, {"value": 0.5}, {"value": 0.75}, None]


# ====================================================== the sampling profiler
def test_sampling_profiler_json_and_perfetto_merge(tmp_path, monkeypatch):
    """Each package's `run_for` samples a busy thread and its JSON dump merges
    into its own Perfetto trace; the port's dump reads in JAX's merge too."""
    stop = threading.Event()

    def busy():
        while not stop.is_set():
            sum(range(200))

    t = threading.Thread(target=busy, daemon=True, name="busy")
    t.start()
    try:
        results = {}
        for name in PKGS:
            d = tmp_path / name
            monkeypatch.setenv("RAY_TPU_SAMPLING_PROFILE", str(d))
            p = _pkg(name)
            res = p.profiler.run_for(0.3, name="testproc")
            assert res["samples"] > 0 and res["path"].endswith(".json")
            assert os.path.dirname(res["path"]) == str(d) and os.path.exists(res["text"])
            profiles = p.perfetto.collect_profiles(str(d))
            assert len(profiles) == 1 and profiles[0]["name"] == "testproc"
            events = p.perfetto.profile_events(profiles)
            assert events and all(e["ph"] == "i" and e["tid"] == "profiler" for e in events)
            trace = p.perfetto.build_trace(profiles=profiles)
            assert any(e.get("cat") == "profile" for e in trace["traceEvents"])
            results[name] = profiles
    finally:
        stop.set()
    assert sorted(results["torch"][0]) == sorted(results["jax"][0])
    jax_view = _pkg("jax").perfetto.profile_events(results["torch"])
    assert [e["args"]["stack"] for e in jax_view] == [
        e["args"]["stack"] for e in _pkg("torch").perfetto.profile_events(results["torch"])]


# ==================================================== the GCS, in process
def test_rate_query_across_flush_boundaries_in_gcs(gcs_limit):
    """Two flusher-shaped reports into an in-process GcsService land two
    history samples whose rate query spans the flush boundary."""
    rec = {"name": "raytpu_history_test_total", "kind": "counter", "value": 5.0,
           "tags": {"component": "test", "node_id": "n1"}}
    seen = {}
    for name in PKGS:
        service = _pkg(name).gcs.GcsService()
        try:
            service.report_internal_metrics("w1", [rec])
            time.sleep(0.35)  # past the default 0.2 s resolution bucket
            service.report_internal_metrics("w1", [dict(rec, value=3.0)])
            [series] = service.metrics_history("raytpu_history_test_total")
            rates = service.metrics_history("raytpu_history_test_total", None, None, True)
            assert len(series["samples"]) >= 2 and rates[0]["samples"][-1][1] > 0
            seen[name] = ([s[1] for s in series["samples"]], series["kind"], series["tags"],
                          service.active_alerts())
        finally:
            service.stop()
            _pkg(name).pm.disarm()  # an in-process GCS arms this process's trigger bus
    assert seen["torch"] == seen["jax"]
    assert seen["torch"][0][-1] == pytest.approx(8.0)  # cumulative across flushes


def _lag_rule_env(monkeypatch, tmp_path, name):
    monkeypatch.setenv("RAY_TPU_FLIGHT_DIR", str(tmp_path / name / "flight"))
    monkeypatch.setenv("RAY_TPU_TRACE_DIR", str(tmp_path / name / "traces"))
    monkeypatch.setenv("RAY_TPU_HARVEST_DELAY_S", "0.05")
    monkeypatch.setenv("RAY_TPU_WATCHDOG_RULES", json.dumps([{
        "name": "heartbeat_lag", "metric": "raytpu_node_heartbeat_lag_s", "stat": "value",
        "op": ">", "threshold": 0.5, "window_s": 10.0}]))


def test_heartbeat_lag_alert_lands_on_node_events(tmp_path, monkeypatch, gcs_limit):
    """A registered node that never beats: the GCS samples its growing lag,
    the heartbeat_lag rule fires, the alert lands on `node_events` with a
    flight dump on disk, `active_alerts` names it, and the alert opens a
    `watchdog.alert` incident."""
    seen = {}
    for name in PKGS:
        _lag_rule_env(monkeypatch, tmp_path, name)
        service = _pkg(name).gcs.GcsService()
        try:
            assert service._watchdog is not None
            service.register_node("deadbeef" * 4, "/tmp/nope.sock", "/tmp/nope", {"CPU": 1.0})

            def firing():
                for _seq, msg in service.pubsub_poll("node_events", 0, timeout=0.2):
                    if (isinstance(msg, dict) and msg.get("event") == "slo_alert"
                            and msg.get("rule") == "heartbeat_lag"
                            and msg.get("state") == "firing"):
                        return msg
                return None

            alert = wait_for(firing, timeout=15.0)
            assert alert, f"{name}: heartbeat_lag alert never published on node_events"
            assert alert["value"] > 0.5 and os.path.exists(alert["flight_dump"])
            [active] = service.active_alerts()
            incidents = wait_for(lambda: [i for i in service.list_incidents()
                                          if i["trigger"] == "watchdog.alert"], timeout=10.0)
            assert incidents, service.list_incidents()
            lag = service.metrics_history("raytpu_node_heartbeat_lag_s")
            seen[name] = (sorted(k for k in alert if k not in ("value", "ts")),
                          active["rule"], active["metric"], incidents[0]["trigger"],
                          [(s["kind"], s["tags"]) for s in lag])
        finally:
            service.stop()
            _pkg(name).pm.disarm()  # an in-process GCS arms this process's trigger bus
    assert seen["torch"] == seen["jax"]


def test_harvest_bundle_holds_metrics_window_and_goodput(tmp_path, monkeypatch, gcs_limit):
    """A harvest stages the incident's metrics window as `metrics.json` and
    the last goodput and MFU in the manifest (the port's bundle held [] and
    no goodput before the history)."""
    seen = {}
    for name in PKGS:
        monkeypatch.setenv("RAY_TPU_FLIGHT_DIR", str(tmp_path / name / "flight"))
        monkeypatch.setenv("RAY_TPU_HARVEST_DELAY_S", "0.05")
        monkeypatch.setenv("RAY_TPU_WATCHDOG", "0")
        session = tmp_path / name / "session"
        session.mkdir(parents=True)
        service = _pkg(name).gcs.GcsService(session_dir=str(session))
        try:
            service.report_internal_metrics("w1", [
                {"name": "raytpu_train_goodput", "kind": "gauge", "value": 0.625,
                 "tags": {"component": "train", "node_id": "n1", "trial": "t"}},
                {"name": "raytpu_train_mfu", "kind": "gauge", "value": 0.375,
                 "tags": {"component": "train", "node_id": "n1", "trial": "t"}},
                {"name": "raytpu_cgraph_execute_latency_ms", "kind": "histogram",
                 "value": 12.5, "counts": [0, 1, 0], "boundaries": [1.0, 25.0],
                 "tags": {"component": "cgraph", "node_id": "n1", "graph": "g"}}])
            res = service.debug_harvest(timeout_s=30.0)
            assert res["ok"], res
            with open(os.path.join(res["bundle"], "metrics.json")) as f:
                metrics = json.load(f)
            with open(os.path.join(res["bundle"], "manifest.json")) as f:
                manifest = json.load(f)
            seen[name] = (sorted(m["name"] for m in metrics), manifest["goodput"],
                          manifest["impact_window_s"] >= 60.0)
        finally:
            service.stop()
            _pkg(name).pm.disarm()  # an in-process GCS arms this process's trigger bus
    assert seen["torch"] == seen["jax"]
    assert seen["torch"] == (["raytpu_cgraph_execute_latency_ms", "raytpu_train_goodput",
                              "raytpu_train_mfu"], {"goodput": 0.625, "mfu": 0.375}, True)
