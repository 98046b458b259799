"""The port's operator surface (ray_tpu_torch/{jobs,dashboard,scripts}.py)
against the JAX package's (tests/test_ops_layer.py's job and CLI cases,
test_state_api.py's dashboard cases, test_metrics_history.py's formatter
cases).

Exact: `prometheus_text` on one metric snapshot, `format_metrics_table`,
`format_watch_table`, `sparkline` and `render_top` on the same series, and
`list_job_records`' order. The same outcome, on one cluster of each package
(module fixtures; the JAX one booted through tests/torch_modes.py): a job's
output reaches its logs, a failing job reads FAILED with its return code
and fires `job.failed`, every dashboard route answers (the REST job API
drives a job end to end), a counter's history reaches
`/api/metrics_history` and `top` (test_metrics_history.py's cluster case),
and the CLI (`start`, `status`, `submit --wait`,
`jobs`, `logs`, `stop`, subprocesses with HOME at tmp_path) reports the same
lines. Job stop: the port reads STOPPED in each of 20 stops and fires no
`job.failed`; the JAX package's case asserts only what its stop guarantees
(ROADMAP: its stop races its supervisor's FAILED). Every cluster and CLI case
runs under `case_time_limit`; the dashboards bind port 0.
"""

import importlib
import json
import os
import subprocess
import sys
import time
import types
import urllib.request
from pathlib import Path

import pytest

import ray_tpu as jrt
import ray_tpu_torch as trt
import torch_modes
from ray_tpu_torch.core import serialization
from torch_waits import wait_for

serialization.register_pickle_by_value(sys.modules[__name__])

ROOT = Path(__file__).resolve().parent.parent
PKGS = ("jax", "torch")
NAMES = {"jax": "ray_tpu", "torch": "ray_tpu_torch"}
_SEEN = {}


def _agree(case, name, seen):
    _SEEN.setdefault(case, {})[name] = seen
    if name == "torch" and "jax" in _SEEN[case]:
        assert seen == _SEEN[case]["jax"], f"{case}: the port saw {seen}, JAX {_SEEN[case]['jax']}"


def _mod(name, sub):
    return importlib.import_module(f"{NAMES[name]}.{sub}")


# ------------------------------------------------------------ exact units
_STATS = {"nodes_alive": 2, "tasks": {"FINISHED": 5, "RUNNING": 1}, "actors": {"ALIVE": 3},
          "store": {"bytes_in_use": 1024, "num_objects": 7, "num_spilled": 1},
          "placement_groups": 1}
_USER = [
    {"name": "my_counter", "kind": "counter", "tags": {"app": 'x"y\\z\nw'}, "value": 9.0},
    {"name": "my_gauge", "kind": "gauge", "tags": {}, "value": 2.5},
    {"name": "lat_ms", "kind": "histogram", "tags": {}, "value": 30.0, "counts": [2, 1],
     "boundaries": [10, 100]},
    {"name": "raytpu_gcs_rpc_total", "kind": "gauge", "tags": {}, "value": 1.0},
]
_INTERNAL = [
    {"name": "raytpu_gcs_rpc_total", "kind": "counter",
     "tags": {"method": "ping", "component": "gcs"}, "value": 4.0},
    {"name": "raytpu_gcs_rpc_total", "kind": "counter",
     "tags": {"method": "kv_get", "component": "gcs"}, "value": 2.0},
    {"name": "raytpu_gcs_rpc_latency_ms", "kind": "histogram", "tags": {"method": "ping"},
     "value": 1.5, "counts": [3, 1, 0], "boundaries": [0.5, 1.0, 2.5]},
    {"name": "raytpu_node_cpu_percent", "kind": "gauge", "tags": {"node_id": "n1"},
     "value": 12.5},
]
_HELP = {"raytpu_gcs_rpc_total": "GCS RPCs served, by method",
         "my_gauge": "a help text with a \\ and\na newline"}


@pytest.mark.parametrize("name", PKGS)
def test_prometheus_text_matches(name):
    text = _mod(name, "dashboard").prometheus_text(_STATS, _USER, _INTERNAL, _HELP)
    assert "# TYPE ray_tpu_nodes_alive gauge" in text
    assert text.count("# TYPE raytpu_gcs_rpc_total counter") == 1
    assert 'lat_ms_bucket{le="+Inf"} 3' in text
    _agree("prometheus", name, text)


_SERIES = [
    {"name": "c", "kind": "counter", "tags": {"node_id": "n"}, "value": 10.0},
    {"name": "g", "kind": "gauge", "tags": {}, "value": 7.0},
    {"name": "h", "kind": "histogram", "tags": {"k": "v"}, "value": 55.0, "counts": [4, 6]},
    {"name": "raytpu_long_name_total", "kind": "counter", "tags": {"a": 1, "b": 2},
     "value": 0.5},
]


def _history(metric, as_rate):
    """A fixed history: two series for one signal, none for the rest."""
    if metric == "raytpu_gcs_rpc_total":
        return [{"name": metric, "tags": {"method": "ping"},
                 "samples": [[100.0 + i, float(i % 5)] for i in range(40)]},
                {"name": metric, "tags": {"method": "kv"},
                 "samples": [[100.5 + i, 2.0] for i in range(40)]}]
    if metric == "raytpu_node_cpu_percent":
        return [{"name": metric, "tags": {}, "samples": [[100.0, 50.0], [101.0, 50.0]]}]
    return []


@pytest.mark.parametrize("name", PKGS)
def test_cli_formatters_match(name):
    s = _mod(name, "scripts")
    prev = {s._metric_key(_SERIES[0]): 4.0, s._metric_key(_SERIES[2]): 5.0}
    alerts = [{"rule": "r", "metric": "m", "value": 3.0, "op": ">", "threshold": 1.0}]
    out = [s.format_metrics_table([("internal", _SERIES[:2]), ("user", _SERIES[2:])]),
           s.format_watch_table(_SERIES, prev, dt=2.0),
           [s.sparkline(v) for v in ([], [5.0, 5.0, 5.0], [0.0, 0.0], [0.0, 1.0, 2.0, 4.0],
                                     [-1.0, 3.0, 0.5], list(range(50)))],
           s.render_top(_history, alerts, window_s=60.0, width=16),
           s.render_top(_history, [], window_s=60.0, width=16),
           s._filter_records(_SERIES, "raytpu")]
    assert "+3" in next(line for line in out[1].splitlines() if line.startswith("c "))
    _agree("formatters", name, out)


class _KvGcs:
    def __init__(self, records):
        self.kv = {f"job:{r['job_id']}": json.dumps(r).encode() for r in records}
        self.kv["other:x"] = b"{}"

    def call(self, method, *a):
        if method == "kv_keys":
            return [k for k in self.kv if k.startswith(a[0])]
        assert method == "kv_get"
        return self.kv.get(a[0])


@pytest.mark.parametrize("name", PKGS)
def test_list_job_records_ordering(name):
    recs = [{"job_id": f"j{i}", "status": "SUCCEEDED", "entrypoint": "e", "ts": ts}
            for i, ts in enumerate([5.0, 1.0, 3.0, 2.0, 4.0])]
    recs.append({"job_id": "no-ts", "status": "PENDING", "entrypoint": "e"})
    out = _mod(name, "jobs").list_job_records(_KvGcs(recs))
    assert [r["job_id"] for r in out] == ["no-ts", "j1", "j3", "j2", "j4", "j0"]
    _agree("job_order", name, out)


# --------------------------------------------------------- cluster drills
@pytest.fixture(scope="module")
def jax_cluster():
    from ray_tpu.core import runtime_base as jbase

    jrt.shutdown()
    jc = torch_modes.boot_jax_cluster(num_cpus=4, num_workers=0)
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
    tc = torch_modes.boot_cluster(Cluster, num_cpus=4, num_gpus=0, num_workers=0)
    try:
        tbase.set_runtime(tc.runtime())
        yield types.SimpleNamespace(name="torch", rt=trt, cluster=tc, base=tbase)
    finally:
        torch_modes.shutdown_cluster(tc, trt.shutdown)


@pytest.fixture(params=PKGS)
def c(request):
    c = request.getfixturevalue(f"{request.param}_cluster")
    c.jobs = _mod(c.name, "jobs")
    c.dashboard = _mod(c.name, "dashboard")
    c.gcs = c.base.current_runtime()._gcs
    with torch_modes.case_time_limit(request, 150):
        yield c


def _job_failed_triggers(gcs):
    n = 0
    for inc in gcs.call("list_incidents"):
        full = gcs.call("get_incident", inc["incident_id"]) or {}
        n += sum(1 for t in full.get("triggers", []) if t.get("kind") == "job.failed")
    return n


def test_job_submit_logs_and_failure(c, tmp_path):
    script = tmp_path / "job.py"
    script.write_text(
        "import os\n"
        f"import {NAMES[c.name]} as rt\n"
        "rt.init(address=os.environ['RAY_TPU_ADDRESS'])\n"
        "@rt.remote\n"
        "def f(x):\n"
        "    return x * 3\n"
        "print('job result:', rt.get(f.remote(14)))\n"
        "rt.shutdown()\n")
    client = c.jobs.JobSubmissionClient()
    ok = client.submit_job(entrypoint=f"{sys.executable} {script}")
    bad = client.submit_job(entrypoint=f"{sys.executable} -c 'raise SystemExit(3)'")
    statuses = [client.wait_until_finished(ok, timeout=120),
                client.wait_until_finished(bad, timeout=120)]
    logs = client.get_job_logs(ok)
    assert statuses == ["SUCCEEDED", "FAILED"], logs
    assert wait_for(lambda: _job_failed_triggers(c.gcs) >= 1, timeout=20.0)
    listed = {j["job_id"]: j["status"] for j in client.list_jobs()}
    seen = ["job result: 42" in logs, statuses, client.get_job_info(bad)["returncode"],
            {listed[ok], listed[bad]}]
    assert seen == [True, ["SUCCEEDED", "FAILED"], 3, {"SUCCEEDED", "FAILED"}]
    _agree("submit", c.name, seen)


def _started_sleeper(client):
    job_id = client.submit_job(entrypoint=f"{sys.executable} -c 'import time; time.sleep(120)'")
    assert wait_for(lambda: client.get_job_info(job_id).get("pid"), timeout=60.0)
    return job_id


def test_job_stop(c):
    client = c.jobs.JobSubmissionClient()
    if c.name == "jax":
        # What the JAX package's stop guarantees: it returns True for a
        # running job, which then ends; STOPPED or FAILED is its race.
        job_id = _started_sleeper(client)
        assert client.stop_job(job_id)
        assert client.wait_until_finished(job_id, timeout=30) in ("STOPPED", "FAILED")
        return
    before = _job_failed_triggers(c.gcs)
    finals = []
    for i in range(20):
        # Half the stops land on a running process, half right after the
        # submit (before or during the supervisor's start).
        job_id = _started_sleeper(client) if i % 2 == 0 else client.submit_job(
            entrypoint=f"{sys.executable} -c 'import time; time.sleep(120)'")
        assert client.stop_job(job_id)
        finals.append((client.get_job_status(job_id),
                       client.wait_until_finished(job_id, timeout=30)))
    assert finals == [("STOPPED", "STOPPED")] * 20, finals
    time.sleep(1.5)  # a trigger would have reached the GCS by now
    assert _job_failed_triggers(c.gcs) == before


def _get(url, raw=False):
    with urllib.request.urlopen(url, timeout=30) as r:
        body = r.read()
        return (r.status, body.decode() if raw else json.loads(body))


def test_dashboard_routes_and_rest_jobs(c):
    @c.rt.remote
    def f():
        return 1

    assert c.rt.get(f.remote(), timeout=60) == 1
    port = c.dashboard.start_dashboard(port=0)
    base = f"http://127.0.0.1:{port}"
    try:
        seen = {}
        for route in ("nodes", "actors", "tasks", "objects", "placement_groups", "stats",
                      "metrics", "internal_metrics", "alerts", "errors", "jobs"):
            status, body = _get(f"{base}/api/{route}")
            seen[route] = (status, type(body).__name__)
        assert _get(f"{base}/api/stats")[1]["nodes_alive"] == 1
        status, text = _get(f"{base}/metrics", raw=True)
        seen["metrics_text"] = (status, "# TYPE ray_tpu_nodes_alive gauge" in text,
                                "ray_tpu_nodes_alive 1" in text)
        status, hist = _get(f"{base}/api/metrics_history?name=raytpu_nodes_drained_total")
        seen["history"] = (status, type(hist).__name__)
        status, logs = _get(f"{base}/api/logs?tail=5")
        seen["logs"] = (status, type(logs).__name__, len(logs) <= 5)
        status, page = _get(f"{base}/", raw=True)
        seen["page"] = (status, "cluster</h1>" in page)
        try:
            urllib.request.urlopen(f"{base}/api/nope", timeout=30)
            seen["unknown"] = 200
        except urllib.error.HTTPError as e:
            seen["unknown"] = e.code
        client = c.jobs.JobSubmissionClient(base)
        assert isinstance(client, c.jobs.HttpJobSubmissionClient)
        job_id = client.submit_job(entrypoint=f"{sys.executable} -c \"print('rest-job-ok')\"")
        seen["rest_job"] = (client.wait_until_finished(job_id, timeout=120),
                            "rest-job-ok" in client.get_job_logs(job_id),
                            any(j["job_id"] == job_id for j in client.list_jobs()),
                            _get(f"{base}/api/jobs/{job_id}")[1]["status"])
        sleeper = client.submit_job(entrypoint=f"{sys.executable} -c 'import time; time.sleep(60)'")
        assert wait_for(lambda: client.get_job_info(sleeper).get("pid"), timeout=60.0)
        seen["rest_stop"] = (client.stop_job(sleeper),
                             client.wait_until_finished(sleeper, timeout=30)
                             in ("STOPPED", "FAILED"))
        try:
            client.get_job_info("no-such-job")
            seen["rest_missing"] = "found"
        except KeyError:
            seen["rest_missing"] = "KeyError"
    finally:
        c.dashboard.stop_dashboard()
    assert seen["rest_job"] == ("SUCCEEDED", True, True, "SUCCEEDED")
    _agree("dashboard", c.name, seen)


def test_port_dashboard_serves_gcs_rpc_and_reporter_series(request):
    """The port's /metrics carries the GCS's per-method RPC counts and the
    raylets' reporter gauges (node CPU and memory, RSS, fds)."""
    c = request.getfixturevalue("torch_cluster")
    from ray_tpu_torch.dashboard import start_dashboard, stop_dashboard

    port = start_dashboard(port=0)
    try:
        def scrape():
            return _get(f"http://127.0.0.1:{port}/metrics", raw=True)[1]

        names = ("raytpu_gcs_rpc_total{", "raytpu_gcs_rpc_latency_ms_bucket{",
                 "raytpu_node_cpu_percent{", "raytpu_node_mem_used_bytes{",
                 "raytpu_proc_rss_bytes{", "raytpu_proc_fd_count{")
        with torch_modes.case_time_limit(request, 60):
            assert wait_for(lambda: all(n in scrape() for n in names), timeout=20.0), scrape()
        text = scrape()
        assert 'method="register_node"' in text
        assert f'node_id="{c.cluster.head_node_id}"' in text
        assert "raytpu_device_mem_used_bytes{" not in text  # no process here holds CUDA
    finally:
        stop_dashboard()


# -------------------------------------------------------------------- CLI
@pytest.mark.parametrize("name", PKGS)
def test_cli_start_status_submit_jobs_logs_stop(name, tmp_path, request):
    env = dict(os.environ, HOME=str(tmp_path))
    env.pop("RAY_TPU_ADDRESS", None)

    def cli(*args, timeout=180):
        return subprocess.run([sys.executable, "-m", f"{NAMES[name]}.scripts", *args],
                              capture_output=True, text=True, timeout=timeout, env=env, cwd=ROOT)

    start = ["start", "--num-cpus", "2"] + (["--num-gpus", "0"] if name == "torch" else [])
    with torch_modes.case_time_limit(request, 240):
        if name == "jax":
            out = torch_modes.jax_boot(cli, *start)
        else:
            out = cli(*start)
        assert out.returncode == 0, out.stderr
        assert "session dir" in out.stdout
        session = out.stdout.split("session dir: ", 1)[1].split()[0]
        try:
            st = cli("status")
            assert st.returncode == 0, st.stderr
            sub = cli("submit", "--wait", "--", sys.executable, "-c", "print('cli-job-ok')")
            assert sub.returncode == 0, sub.stderr + sub.stdout
            job_id = sub.stdout.split()[1].rstrip(":")
            jobs = cli("jobs")
            logs = cli("logs", job_id)
            seen = ["nodes alive: 1" in st.stdout, "cli-job-ok" in sub.stdout,
                    f"{job_id}: SUCCEEDED" in sub.stdout,
                    any(line.split()[:2] == [job_id, "SUCCEEDED"]
                        for line in jobs.stdout.splitlines()),
                    logs.stdout.strip()]
        finally:
            stop = cli("stop")
        assert stop.returncode == 0, stop.stderr
    assert seen == [True, True, True, True, "cli-job-ok"]
    if name == "torch":
        # Nothing of the session is left: no process names it, no pool.
        def leftover():
            pids = []
            for pid in filter(str.isdigit, os.listdir("/proc")):
                try:
                    with open(f"/proc/{pid}/cmdline", "rb") as f:
                        if session.encode() in f.read():
                            pids.append(pid)
                except OSError:
                    pass
            base = os.path.basename(session)
            return pids + [p for p in os.listdir("/dev/shm") if base in p]

        assert wait_for(lambda: not leftover(), timeout=10.0), leftover()
        assert not os.path.exists(session)
        assert not (tmp_path / ".ray_tpu_torch" / "latest_session").exists()
    _agree("cli", name, seen)


def test_operator_modules_import_no_torch():
    """The node provider, both autoscalers, jobs, the dashboard, the CLI and
    the lock-order detector start without torch, as the daemons do."""
    code = ("import sys\n"
            "import ray_tpu_torch.accelerators.node_provider, ray_tpu_torch.accelerators.cpu\n"
            "import ray_tpu_torch.autoscaler, ray_tpu_torch.autoscaler_v2, ray_tpu_torch.jobs\n"
            "import ray_tpu_torch.dashboard, ray_tpu_torch.scripts\n"
            "import ray_tpu_torch.utils.lock_order, ray_tpu_torch.utils.profiling\n"
            "bad = sorted({m.split('.')[0] for m in sys.modules} & {'torch', 'jax', 'ray_tpu'})\n"
            "assert not bad, bad\n"
            "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "clean" in out.stdout


def test_metrics_history_over_http_and_top(c):
    """test_metrics_history.py's cluster acceptance on both packages, over a
    counter both catalogs have (the GCS's per-method RPC count): a
    multi-sample series after two flushes, its rate, the same series at
    /api/metrics_history, /api/alerts, and `top`'s frame with data for it."""
    state = _mod(c.name, "utils.state")
    scripts = _mod(c.name, "scripts")
    name = "raytpu_gcs_rpc_total"

    @c.rt.remote
    def f(x):
        return x + 1

    def multi_sample():
        c.rt.get([f.remote(i) for i in range(10)], timeout=60)
        series = state.metrics_history(name, window_s=120.0)
        return series if any(len(s["samples"]) >= 2 for s in series) else None

    assert wait_for(multi_sample, timeout=60.0, interval=0.5)
    rates = state.metrics_history(name, window_s=120.0, as_rate=True)
    port = c.dashboard.start_dashboard(port=0)
    try:
        status, payload = _get(f"http://127.0.0.1:{port}/api/metrics_history"
                               f"?name={name}&window_s=120&rate=1")
        _, alerts = _get(f"http://127.0.0.1:{port}/api/alerts")
    finally:
        c.dashboard.stop_dashboard()
    frame = scripts.render_top(lambda m, r: state.metrics_history(m, None, 120.0, r),
                               state.active_alerts())
    line = next(ln for ln in frame.splitlines() if ln.startswith("gcs rpc/s"))
    seen = [any(s["samples"] for s in rates), status, {s["name"] for s in payload},
            type(alerts).__name__, "(no data)" not in line]
    assert seen == [True, 200, {name}, "list", True], frame
    _agree("history_http_top", c.name, seen)
