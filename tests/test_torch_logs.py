"""Structured logs, the driver's re-print of worker output and crash
post-mortems on the port (ray_tpu_torch/observability/logs.py, the raylet's
log monitor, `tail_logs` and post-mortem files) against the JAX package's
(tests/test_logs.py), on the same inputs.

Module cases run each package's function on the same records, lines and
files, made from a seed with numpy, and hold the port to the JAX result
exactly: a record's fields (ts aside), rotation and the retention GC's
evictions, `read_records` under each filter, `DedupPrinter` on one burst and
one rate limit (the same printed lines), `format_record` and
`capture_prefix`.

Cluster cases run on one cluster of each package (module fixtures; the JAX
one booted through tests/torch_modes.py), each under its own time limit:
the driver sees a worker's print (test_state_api.py's
test_log_to_driver_streams_worker_prints) and re-prints it with the
worker's prefix; `tail_logs` filters by component and level and by actor;
and a worker that SIGKILLs itself leaves a post-mortem file with its
output's tail next to the flight dumps and a `worker_crash` record in the
GCS error table. The port's forked worker reports exit code -9 there (the
zygote keeps the status; the JAX zygote drops it, so its status is not
compared).
"""

import glob
import importlib
import json
import logging
import os
import signal
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
CLUSTER_LIMIT_S = 180
_SEEN = {}


def _logs(name):
    return importlib.import_module(f"{ROOT[name]}.observability.logs")


def _agree(case, name, seen):
    """The port's observation must equal the JAX package's (JAX runs first)."""
    _SEEN.setdefault(case, {})[name] = seen
    if name == "torch" and "jax" in _SEEN[case]:
        assert seen == _SEEN[case]["jax"], f"{case}: the port saw {seen}, JAX {_SEEN[case]['jax']}"


def _fixed_record(name, logger, msg, created, level=logging.INFO):
    """A LogRecord with a fixed creation time: both packages then write the
    same bytes."""
    rec = logging.LogRecord(logger, level, __file__, 1, msg, (), None)
    rec.created = created
    return rec


# ------------------------------------------------------------------ units
@pytest.fixture
def log_dirs(tmp_path):
    """Each package's log module configured as a driver of node "testnode",
    writing to its own directory; restored after."""
    dirs = {}
    for name in PKGS:
        dirs[name] = str(tmp_path / name)
        _logs(name).configure("driver", node_id="testnode", directory=dirs[name])
    yield dirs
    for name in PKGS:
        _logs(name).configure("driver", node_id=None, directory=None)


def test_build_record_fields(log_dirs):
    """One message in a task's context, inside a traced span: the same
    fields in both packages (the span's trace id is each package's own)."""
    rng = np.random.default_rng(SEED)
    msg = "unit " + "".join(rng.choice(list("abcdefgh"), 12))
    out = {}
    for name in PKGS:
        ctxmod = importlib.import_module(f"{ROOT[name]}.core.runtime_context")
        tracing = importlib.import_module(f"{ROOT[name]}.tracing")
        exp = tracing.InMemoryExporter()
        tracing.enable(exp)
        tok = ctxmod.set_task_context("task-abc", "actor-def")
        try:
            with tracing.span("request"):
                _logs(name).get_logger("unit").info("%s", msg)
        finally:
            ctxmod.reset_task_context(tok)
            tracing.disable()
        rec = _logs(name).read_records(log_dirs[name])[-1]
        assert rec["trace_id"] == exp.spans[0]["trace_id"]
        out[name] = {k: v for k, v in rec.items() if k not in ("ts", "trace_id")}
    assert out["torch"] == out["jax"]
    assert out["torch"] == {"level": "INFO", "node_id": "testnode", "component": "unit",
                            "pid": os.getpid(), "worker_id": None, "task_id": "task-abc",
                            "actor_id": "actor-def", "msg": msg}


def test_rotation_bounds_file_size(tmp_path, monkeypatch):
    """300 records of seeded lengths through each package's writer with a
    2000-byte rotation: the same files, the same bytes in each."""
    monkeypatch.setenv("RAY_TPU_LOG_ROTATE_BYTES", "2000")
    rng = np.random.default_rng(SEED)
    lengths = rng.integers(5, 60, size=300)
    files = {}
    for name in PKGS:
        logs = _logs(name)
        d = str(tmp_path / name)
        logs.configure("driver", node_id="n", directory=d)
        try:
            for i, n in enumerate(lengths):
                rec = logs.build_record(_fixed_record(name, f"{ROOT[name]}.rot",
                                                      f"filler {i:04d} " + "x" * int(n),
                                                      1_700_000_000.0 + i))
                logs._write_line(json.dumps(rec))
        finally:
            logs.configure("driver", directory=None)
        names = sorted(os.listdir(d))
        assert any(n.endswith(".jsonl.1") for n in names), names
        for n in names:
            assert os.path.getsize(os.path.join(d, n)) < 4000
        kept = logs.read_records(d, grep="filler")
        assert len(kept) > 10
        files[name] = {n: open(os.path.join(d, n), "rb").read() for n in names}
    assert files["torch"] == files["jax"]


def test_retention_gc_evicts_oldest(tmp_path):
    """The same directory of seeded file sizes and ages, a cap, a protected
    prefix: the same evictions, twice."""
    rng = np.random.default_rng(SEED)
    sizes = rng.integers(200, 1200, size=8)
    ages = rng.permutation(8) * 10 + 100
    now = time.time()
    left = {}
    for name in PKGS:
        d = str(tmp_path / name)
        os.makedirs(d)
        for i, (size, age) in enumerate(zip(sizes, ages)):
            fname = f"{'raylet_' if i == 0 else 'worker_'}{i}.out"
            path = os.path.join(d, fname)
            with open(path, "wb") as f:
                f.write(b"x" * int(size))
            os.utime(path, (now - age, now - age))
        fresh = os.path.join(d, "worker_9.out")  # inside the min-age guard
        with open(fresh, "wb") as f:
            f.write(b"y" * 3000)
        gc = _logs(name).gc_log_dir
        first = gc(d, max_bytes=3000, min_age_s=30.0, protect_prefixes=["raylet_"])
        second = gc(d, max_bytes=3000, min_age_s=30.0, protect_prefixes=["raylet_"])
        left[name] = (first, second, sorted(os.listdir(d)))
    assert left["torch"] == left["jax"]
    assert left["torch"][0] > 0 and left["torch"][1] == 0
    assert "raylet_0.out" in left["torch"][2] and "worker_9.out" in left["torch"][2]


def test_read_records_filters(tmp_path):
    """Seeded records, a corrupt line and a rotated generation: every
    filter gives the same records in both packages."""
    rng = np.random.default_rng(SEED)
    comps, levels = ["serve", "worker", "raylet", "stdout"], ["DEBUG", "INFO", "WARNING", "ERROR"]
    recs = [{"ts": float(i) + float(rng.random()), "level": levels[rng.integers(4)],
             "component": comps[rng.integers(4)], "msg": f"m{i} {rng.integers(100)}",
             "task_id": f"t{rng.integers(3)}{i:03d}", "actor_id": f"a{rng.integers(2)}",
             "worker_id": f"w{rng.integers(3)}", "node_id": f"n{rng.integers(2)}",
             "trace_id": None, "pid": int(rng.integers(1, 9))} for i in range(60)]
    d = str(tmp_path / "q")
    os.makedirs(d)
    with open(os.path.join(d, "a.jsonl"), "w") as f:
        for r in recs[:40]:
            f.write(json.dumps(r) + "\n")
        f.write("{corrupt\n")
    with open(os.path.join(d, "a.jsonl.1"), "w") as f:
        for r in recs[40:]:
            f.write(json.dumps(r) + "\n")
    filters = [{}, {"component": "serve"}, {"level": "WARNING"}, {"task_id": "t1"},
               {"actor_id": "a1", "level": "INFO"}, {"worker_id": "w2"}, {"node_id": "n0"},
               {"grep": " 4"}, {"since_ts": 30.0}, {"tail": 7}, {"tail": 5, "component": "raylet"}]
    for flt in filters:
        got = {name: _logs(name).read_records(d, **flt) for name in PKGS}
        assert got["torch"] == got["jax"], flt
        assert got["torch"], flt
    assert len(_logs("torch").read_records(d)) == 60


def test_dedup_printer_burst_and_rate():
    """One seeded burst with repeats inside the window, then a flood past
    the rate limit: the same printed lines in both packages."""
    rng = np.random.default_rng(SEED)
    burst = [f"line-{k}" for k in rng.integers(0, 12, size=2000)]
    printed = {}
    for name in PKGS:
        out = []
        p = _logs(name).DedupPrinter(print_fn=out.append, window_s=60.0)
        for line in burst:
            p.emit("(A pid=1 node=x)", line)
        flood = []
        q = _logs(name).DedupPrinter(print_fn=flood.append, window_s=0.0, max_lines_per_s=50)
        for i in range(500):
            q.emit("(B)", f"unique-{i}")
        printed[name] = (out, dict(p.stats), flood, dict(q.stats))
    assert printed["torch"] == printed["jax"]
    out, stats, flood, qstats = printed["torch"]
    assert sorted(out) == sorted({f"(A pid=1 node=x) {b}" for b in burst})
    assert stats["suppressed"] == len(burst) - len(out)
    assert qstats["printed"] <= 50 and any("rate limit" in line for line in flood)


def test_format_record_and_prefix():
    rng = np.random.default_rng(SEED)
    recs = [{"ts": 1_700_000_000.0 + float(rng.random()) * 1e5, "level": "INFO",
             "component": "serve", "node_id": "abcdef123", "pid": int(rng.integers(1, 1000)),
             "msg": f"hi {i}", "task_id": "t123" if i % 2 else None,
             "actor_id": "a9" if i % 3 else None, "trace_id": "tr456"} for i in range(6)]
    recs.append({"msg": "no ts"})
    msgs = [{"actor": "Talker", "pid": 9, "node_id": "abcdef123", "worker_id": "w1"},
            {"actor": None, "pid": 3, "node_id": None, "worker_id": "abcdefgh"}, {}]
    out = {name: ([_logs(name).format_record(r) for r in recs],
                  [_logs(name).capture_prefix(m) for m in msgs]) for name in PKGS}
    assert out["torch"] == out["jax"]
    assert out["torch"][1][0] == "(Talker pid=9 node=abcdef12)"


# --------------------------------------------------------------- clusters
@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    return {name: str(tmp_path_factory.mktemp(f"flight_{name}")) for name in PKGS}


def _boot(name, flight_dir):
    """A cluster of `name`'s package whose daemons and workers dump their
    flight rings and post-mortems into `flight_dir`. The port's starts no
    worker at boot and waits for its zygote's parked child, so each of its
    workers is forked."""
    saved = os.environ.get("RAY_TPU_FLIGHT_DIR")
    os.environ["RAY_TPU_FLIGHT_DIR"] = flight_dir
    try:
        if name == "jax":
            cluster = torch_modes.boot_jax_cluster(num_cpus=4, num_workers=2)
            return cluster, cluster.runtime()
        from ray_tpu_torch.core.cluster_runtime import Cluster

        cluster = torch_modes.boot_cluster(Cluster, num_cpus=4, num_gpus=0, num_workers=0)
        runtime = cluster.runtime()
        pool = wait_for(lambda: (p := runtime._raylet.call("debug_state")["pool"]).get(
            "zygote_alive") and p.get("preforked", 0) >= 1, timeout=120, interval=0.25)
        assert pool, "the zygote never parked a child"
        return cluster, runtime
    finally:
        if saved is None:
            os.environ.pop("RAY_TPU_FLIGHT_DIR", None)
        else:
            os.environ["RAY_TPU_FLIGHT_DIR"] = saved


def _package_fixture(name, dirs):
    rt = importlib.import_module(ROOT[name])
    base = importlib.import_module(f"{ROOT[name]}.core.runtime_base")
    rt.shutdown()
    cluster, runtime = _boot(name, dirs[name])
    try:
        base.set_runtime(runtime)
        yield types.SimpleNamespace(
            name=name, rt=rt, cluster=cluster, base=base, flight_dir=dirs[name],
            state=importlib.import_module(f"{ROOT[name]}.utils.state"))
    finally:
        torch_modes.shutdown_cluster(cluster, rt.shutdown)


@pytest.fixture(scope="module")
def jax_cluster(dirs):
    yield from _package_fixture("jax", dirs)


@pytest.fixture(scope="module")
def torch_cluster(dirs):
    yield from _package_fixture("torch", dirs)


@pytest.fixture(params=PKGS)
def c(request):
    c = request.getfixturevalue(f"{request.param}_cluster")
    with torch_modes.case_time_limit(request, CLUSTER_LIMIT_S):
        yield c


def test_log_to_driver_streams_worker_prints(c, capfd):
    """test_state_api.py's gate on both packages: a task's print reaches the
    driver's console, with the worker's prefix in `_log_recent`."""
    rt = c.rt

    @rt.remote
    def noisy():
        print("stream-me-to-driver", flush=True)
        return os.getpid()

    pid = rt.get(noisy.remote(), timeout=60)
    deadline = time.monotonic() + 15
    seen = ""
    while time.monotonic() < deadline and "stream-me-to-driver" not in seen:
        seen += capfd.readouterr().out
        time.sleep(0.3)
    assert "stream-me-to-driver" in seen
    runtime = c.base.current_runtime()
    lines = wait_for(lambda: [ln for ln in runtime._log_recent
                              if ln.endswith("stream-me-to-driver")], timeout=15)
    assert lines and lines[-1].startswith(f"(worker_") and f" pid={pid} node=" in lines[-1]
    _agree("to_driver", c.name, (lines[-1].split(" ", 1)[1].split(" node=")[0] == f"pid={pid}",
                                 lines[-1].rsplit(") ", 1)[1]))


def test_tail_logs_filters(c):
    """test_logs.py's tail_logs case, and the actor filter over an actor's
    print and structured record (test_driver_capture_and_query_e2e)."""
    rt = c.rt
    rpc = importlib.import_module(f"{ROOT[c.name]}.core.rpc")

    @rt.remote
    def noisy():
        log = logging.getLogger("filterapp")
        log.info("keep-this-info")
        log.error("keep-this-error")
        return 1

    assert rt.get(noisy.remote(), timeout=60) == 1
    nodes = [n for n in c.state.list_nodes() if n.get("Alive")]

    def tails(filters):
        out = []
        for n in nodes:
            cli = rpc.RpcClient(n["sock"])
            try:
                out += cli.call("tail_logs", filters)
            finally:
                cli.close()
        return out

    assert wait_for(lambda: tails({"grep": "keep-this-error"}), timeout=15)
    recs = tails({"component": "filterapp", "level": "ERROR"})
    assert recs and all(r["level"] == "ERROR" for r in recs)
    assert isinstance(tails({"bogus": "x", "grep": "keep-this-info"}), list)

    @rt.remote
    class Chatty:
        def speak(self):
            print("actor-print-line", flush=True)
            logging.getLogger("userapp").info("actor-logging-line")
            return 1

    a = Chatty.remote()
    assert rt.get(a.speak.remote(), timeout=60) == 1
    actor_id = a._actor_id.hex()

    def by_actor():
        recs = c.state.cluster_logs(actor_id=actor_id)
        return {(r["component"], r["msg"]) for r in recs
                if r["msg"] in ("actor-print-line", "actor-logging-line")}

    want = {("stdout", "actor-print-line"), ("userapp", "actor-logging-line")}
    assert wait_for(lambda: by_actor() >= want, timeout=15), by_actor()
    structured = [r for r in c.state.cluster_logs(actor_id=actor_id, component="userapp")]
    assert structured and structured[-1]["task_id"]
    _agree("tail_logs", c.name, (sorted({r["level"] for r in recs}), sorted(by_actor())))


def _postmortem_with(flight_dir, marker):
    for path in glob.glob(os.path.join(flight_dir, "postmortem_*.json")):
        with open(path) as f:
            payload = json.load(f)
        if any(marker in ln for ln in payload.get("tail", [])):
            return payload
    return None


def test_crashed_worker_postmortem(c):
    """An actor's worker SIGKILLed in a method (test_logs.py's chaos-killed
    actor): its output's tail lands in a post-mortem file next to the
    flight dumps and in a worker_crash record of the GCS error table. Then a
    task's worker SIGKILLed (max_retries=0): WorkerCrashedError carrying
    the marker, and a post-mortem naming the task. On the port that task ran
    on a worker forked from the zygote (the status file the zygote wrote is
    there), and its post-mortem reads exit code -9."""
    rt = c.rt
    exc = importlib.import_module(f"{ROOT[c.name]}.exceptions")

    @rt.remote
    class Doomed:
        def speak(self, marker):
            print(marker, flush=True)
            return 1

        def die(self):
            os.kill(os.getpid(), signal.SIGKILL)

    marker = f"actor-last-words-{c.name}-{np.random.default_rng(SEED).integers(1 << 30)}"
    a = Doomed.remote()
    assert rt.get(a.speak.remote(marker), timeout=60) == 1
    with pytest.raises(Exception):  # the JAX direct channel raises RuntimeError
        rt.get(a.die.remote(), timeout=60)
    payload = wait_for(lambda: _postmortem_with(c.flight_dir, marker), timeout=15)
    assert payload, os.listdir(c.flight_dir)
    assert payload["actor_id"] == a._actor_id.hex()
    errors = wait_for(lambda: [e for e in c.state.cluster_errors()
                               if e.get("type") == "worker_crash"
                               and marker in str(e.get("log_tail", ""))], timeout=15)
    assert errors, c.state.cluster_errors()

    def _die(marker):
        sys.stderr.write(marker + "\n")
        sys.stderr.flush()
        os.kill(os.getpid(), signal.SIGKILL)

    # Two CPUs: no lease lane takes it, the raylet runs it and knows its entry.
    task_marker = f"task-last-words-{c.name}"
    with pytest.raises(exc.WorkerCrashedError, match=task_marker):
        rt.get(rt.remote(max_retries=0, num_cpus=2)(_die).remote(task_marker), timeout=60)
    task_pm = wait_for(lambda: _postmortem_with(c.flight_dir, task_marker), timeout=15)
    assert task_pm, os.listdir(c.flight_dir)
    assert "_die" in task_pm["task"], task_pm
    if c.name == "torch":
        wid = task_pm["worker_id"]
        assert os.path.exists(os.path.join(c.cluster.log_dir, f"worker_{wid}.exit"))
        assert task_pm["exit_code"] == -9, task_pm
    _agree("crash", c.name, (sorted(payload), payload["tail"][-1] == marker,
                             errors[-1]["type"], sorted(task_pm)))
