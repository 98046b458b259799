"""Structured logging: session log dir, JSONL records, query + dedup (the
port of ray_tpu/observability/logs.py).

Re-design of the reference's log subsystem (reference: the per-process
files under /tmp/ray/session_*/logs, python/ray/_private/log_monitor.py
tailing worker stdout/stderr to the driver with `(Actor pid=...)`
prefixes, python/ray/util/state/api.py list_logs, and the error pubsub
surfacing uncaught worker exceptions):

- `get_logger(component)` returns a stdlib logger whose records land as
  JSONL lines `{ts, level, node_id, component, pid, worker_id, task_id,
  actor_id, trace_id, msg}` in a rotating per-process file under
  `<session_dir>/logs/`. Task/actor ids are auto-injected from the
  runtime context and trace ids from the ambient tracing span, so a log
  line emitted inside a traced request joins that request's timeline.
- Worker stdout/stderr are already redirected to per-worker files at
  spawn (raylet); the raylet's log monitor tails those files, publishes
  new lines on the `logs` pubsub channel (the driver re-prints them with
  `(ActorName pid=... node=...)` prefixes, deduped and rate-limited), and
  mirrors them into structured capture records so the queries can filter
  raw prints by actor and worker too.
- `read_records` / `query_cluster` are the query half: a local-directory
  scan and the cluster-wide `tail_logs` fan-out (`utils/state.py`
  `cluster_logs`, postmortem.merge_trace's log instants).

Env knobs:
- RAY_TPU_LOG_DIR           where this process writes its JSONL file
  (default: <tmp>/ray_tpu_logs)
- RAY_TPU_LOG_LEVEL         minimum record level (default INFO)
- RAY_TPU_LOG_ROTATE_BYTES  per-file rotation threshold (default 16 MiB)
- RAY_TPU_LOG_MAX_BYTES     session log dir retention cap (default 512 MiB)
- RAY_TPU_LOG_TO_DRIVER=0   driver stops re-printing captured output
- RAY_TPU_LOG_MONITOR=0     raylets stop tailing/publishing worker output

The port's loggers live under `ray_tpu_torch`; the retention GC counts its
evictions in `raytpu_logs_evicted_total`. This module imports only the
standard library and the port's `utils/internal_metrics.py`, which imports
only the standard library.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from ..utils import internal_metrics as imet

_ROOT = "ray_tpu_torch"  # the logger every port module's logger descends from
_DEFAULT_ROTATE_BYTES = 16 << 20
_DEFAULT_MAX_BYTES = 512 << 20

# Formatted-line mirror levels: worker-side records at or above this also
# write a human line to the real stderr, which is captured into the
# worker's .err file and therefore re-printed at the driver.
_MIRROR_LEVEL = logging.INFO

_lock = threading.Lock()
_state: Dict[str, Any] = {
    "role": "proc",
    "node_id": None,
    "worker_id": None,
    "dir": None,
    "path": None,
    "file": None,
    "rotate_bytes": None,
    "mirror_stderr": False,
}


def _env_level() -> int:
    raw = os.environ.get("RAY_TPU_LOG_LEVEL", "INFO").upper()
    try:
        return int(raw)
    except ValueError:
        return getattr(logging, raw, logging.INFO)


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


def log_dir() -> str:
    """This process's log directory (configured > env > tmp fallback)."""
    d = _state["dir"] or os.environ.get("RAY_TPU_LOG_DIR")
    if d:
        return d
    import tempfile

    return os.path.join(tempfile.gettempdir(), "ray_tpu_logs")


def configure(
    role: str,
    node_id: Optional[str] = None,
    worker_id: Optional[str] = None,
    directory: Optional[str] = None,
    mirror_stderr: Optional[bool] = None,
    capture_root: bool = False,
) -> None:
    """Stamps this process's identity and (re)opens its JSONL sink.
    Called once at process boot by the driver/raylet/GCS/worker entry
    points; safe to call again (tests boot many clusters per process).

    `capture_root=True` (workers) additionally attaches the JSONL
    handler to the ROOT logger so user `logging` calls inside tasks land
    in the structured stream with task/actor/trace ids attached — and,
    with `mirror_stderr`, reach the driver console via output capture
    exactly like prints do."""
    with _lock:
        f = _state.get("file")
        if f is not None:
            try:
                f.close()
            except OSError:
                pass
        _state.update(
            {
                "role": role,
                "node_id": node_id or _state.get("node_id"),
                "worker_id": worker_id,
                "dir": directory,
                "path": None,
                "file": None,
                "rotate_bytes": _env_int(
                    "RAY_TPU_LOG_ROTATE_BYTES", _DEFAULT_ROTATE_BYTES
                ),
            }
        )
        if mirror_stderr is not None:
            _state["mirror_stderr"] = mirror_stderr
    root = logging.getLogger(_ROOT)
    root.setLevel(_env_level())
    if not any(isinstance(h, _JsonlHandler) for h in root.handlers):
        root.addHandler(_JsonlHandler())
    root.propagate = False
    if capture_root:
        top = logging.getLogger()
        if not any(isinstance(h, _JsonlHandler) for h in top.handlers):
            h = _JsonlHandler()
            h.setLevel(_env_level())
            top.addHandler(h)
        if top.level in (logging.NOTSET, logging.WARNING):
            # Default root level would drop user logging.info(); an
            # explicit application-set level is respected.
            top.setLevel(_env_level())


def _file_name() -> str:
    role = _state["role"]
    if _state.get("worker_id"):
        return f"worker_{_state['worker_id']}.jsonl"
    if role == "gcs":
        return "gcs.jsonl"
    if role == "raylet" and _state.get("node_id"):
        return f"raylet_{str(_state['node_id'])[:12]}.jsonl"
    return f"{role}_{os.getpid()}.jsonl"


def _open_locked():
    d = log_dir()
    try:
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, _file_name())
        _state["path"] = path
        _state["file"] = open(path, "a", encoding="utf-8")
    except OSError:
        _state["file"] = None
    return _state["file"]


def _write_line(line: str) -> None:
    with _lock:
        f = _state.get("file")
        if f is None or f.closed:
            f = _open_locked()
            if f is None:
                return
        rotate = _state.get("rotate_bytes") or _env_int(
            "RAY_TPU_LOG_ROTATE_BYTES", _DEFAULT_ROTATE_BYTES
        )
        try:
            f.write(line + "\n")
            f.flush()
            if f.tell() > rotate:
                # One rotation generation: <file>.1 holds the previous
                # window; the retention GC bounds the directory total.
                f.close()
                os.replace(_state["path"], _state["path"] + ".1")
                _open_locked()
        except (OSError, ValueError):
            _state["file"] = None


def _ambient_context() -> Dict[str, Optional[str]]:
    """Task/actor ids from the runtime context, trace id from the ambient
    tracing span — the auto-injected linkage fields."""
    out: Dict[str, Optional[str]] = {
        "task_id": None,
        "actor_id": None,
        "trace_id": None,
    }
    try:
        from ..core.runtime_context import _current_task

        ctx = _current_task.get()
        if ctx:
            out["task_id"] = ctx.get("task_id")
            out["actor_id"] = ctx.get("actor_id")
    except Exception:  # lint: swallow-ok(ambient context is optional enrichment)
        pass
    try:
        from .. import tracing

        tctx = tracing.current_context()
        if tctx:
            out["trace_id"] = tctx.get("trace_id")
    except Exception:  # lint: swallow-ok(trace context is optional enrichment)
        pass
    return out


class _JsonlHandler(logging.Handler):
    """Formats each record as one JSON line in the process's session log
    file; worker-side records at INFO+ additionally mirror a human line
    to the real stderr so they reach the driver via output capture."""

    def emit(self, record: logging.LogRecord) -> None:
        try:
            rec = build_record(record)
            _write_line(json.dumps(rec, default=repr))
            if _state.get("mirror_stderr") and record.levelno >= _MIRROR_LEVEL:
                import sys

                sys.stderr.write(
                    f"[{rec['level']} {rec['component']}] {rec['msg']}\n"
                )
                sys.stderr.flush()
        except Exception:  # lint: swallow-ok(logging must never take the process down)
            pass


def build_record(record: logging.LogRecord) -> Dict[str, Any]:
    """The structured record for one logging.LogRecord. `extra=` fields
    (worker_id, actor_id, task_id, pid, trace_id) override the ambient
    values — the raylet's capture path stamps the ORIGIN worker's ids
    onto lines it re-logs on the worker's behalf."""
    ctx = _ambient_context()
    component = record.name
    if component.startswith(_ROOT + "."):
        component = component[len(_ROOT) + 1:]
    elif component == _ROOT:
        component = _state["role"]
    rec = {
        "ts": record.created,
        "level": record.levelname,
        "node_id": getattr(record, "node_id", None) or _state["node_id"],
        "component": component,
        "pid": getattr(record, "origin_pid", None) or os.getpid(),
        "worker_id": getattr(record, "worker_id", None) or _state["worker_id"],
        "task_id": getattr(record, "task_id", None) or ctx["task_id"],
        "actor_id": getattr(record, "actor_id", None) or ctx["actor_id"],
        "trace_id": getattr(record, "trace_id", None) or ctx["trace_id"],
        "msg": record.getMessage(),
    }
    if record.exc_info and record.exc_info[0] is not None:
        import traceback

        rec["exc"] = "".join(traceback.format_exception(*record.exc_info))[
            -4000:
        ]
    return rec


def write_capture_records(records: List[Dict[str, Any]]) -> None:
    """Bulk append of pre-built capture records (the raylet log monitor's
    stdout/stderr mirror). One buffered write + flush per BATCH instead
    of a full logging-machinery pass per line — on a single-core box the
    monitor thread's cycles come straight out of task throughput, and
    this path sees every line every worker ever prints."""
    if not records:
        return
    _write_line("\n".join(json.dumps(r, default=repr) for r in records))


def capture_record(
    line: str,
    stream: str,
    node_id: Optional[str],
    worker_id: Optional[str],
    actor_id: Optional[str],
    pid: Optional[int],
    ts: Optional[float] = None,
) -> Dict[str, Any]:
    """One structured record for a captured raw output line, attributed
    to its ORIGIN worker (component `stdout`/`stderr`)."""
    return {
        "ts": time.time() if ts is None else ts,
        "level": "INFO",
        "node_id": node_id,
        "component": "stdout" if stream == "out" else "stderr",
        "pid": pid or 0,
        "worker_id": worker_id,
        "task_id": None,
        "actor_id": actor_id,
        "trace_id": None,
        "msg": line,
    }


def get_logger(component: str) -> logging.Logger:
    """The structured logger for one runtime component. Records flow to
    this process's JSONL session log (and nowhere else — worker stdout
    capture handles the console side)."""
    root = logging.getLogger(_ROOT)
    if not any(isinstance(h, _JsonlHandler) for h in root.handlers):
        root.addHandler(_JsonlHandler())
        root.setLevel(_env_level())
        root.propagate = False
    return logging.getLogger(f"{_ROOT}.{component}")


# -------------------------------------------------------------- retention
def gc_log_dir(
    directory: Optional[str] = None,
    max_bytes: Optional[int] = None,
    min_age_s: float = 30.0,
    protect_prefixes: Optional[Any] = None,
) -> int:
    """Size-capped retention for a session log dir: evicts oldest-mtime
    files until the directory total fits `max_bytes`
    (RAY_TPU_LOG_MAX_BYTES). Never evicted: files touched within
    `min_age_s`, this process's own live file, and files whose basename
    starts with any of `protect_prefixes` — the raylet passes its LIVE
    workers' prefixes, since unlinking a file another process holds open
    for writing silently discards all of that process's future output.
    Returns the eviction count."""
    directory = directory or log_dir()
    if max_bytes is None:
        max_bytes = _env_int("RAY_TPU_LOG_MAX_BYTES", _DEFAULT_MAX_BYTES)
    protect = tuple(protect_prefixes or ())
    try:
        names = os.listdir(directory)
    except OSError:
        return 0
    entries = []
    total = 0
    own = _state.get("path")
    for name in names:
        path = os.path.join(directory, name)
        try:
            st = os.stat(path)
        except OSError:
            continue
        total += st.st_size
        entries.append((st.st_mtime, st.st_size, path, name))
    if total <= max_bytes:
        return 0
    entries.sort()
    now = time.time()
    evicted = 0
    for mtime, size, path, name in entries:
        if total <= max_bytes:
            break
        if path == own or now - mtime < min_age_s:
            continue
        if protect and name.startswith(protect):
            continue
        try:
            os.unlink(path)
        except OSError:
            continue
        total -= size
        evicted += 1
    if evicted:
        imet.LOGS_EVICTED.inc(evicted)
    return evicted


# ---------------------------------------------------------------- queries
_LEVEL_ORDER = {
    "DEBUG": 10,
    "INFO": 20,
    "STDOUT": 20,
    "STDERR": 20,
    "WARNING": 30,
    "ERROR": 40,
    "CRITICAL": 50,
}


def _level_no(name: Optional[str]) -> int:
    return _LEVEL_ORDER.get(str(name or "").upper(), 20)


def record_matches(
    rec: Dict[str, Any],
    component: Optional[str] = None,
    level: Optional[str] = None,
    task_id: Optional[str] = None,
    actor_id: Optional[str] = None,
    trace_id: Optional[str] = None,
    worker_id: Optional[str] = None,
    node_id: Optional[str] = None,
    grep: Optional[str] = None,
    since_ts: Optional[float] = None,
) -> bool:
    if component and rec.get("component") != component:
        return False
    if level and _level_no(rec.get("level")) < _level_no(level):
        return False
    # Id filters accept prefixes: CLI users paste truncated ids.
    for key, want in (
        ("task_id", task_id),
        ("actor_id", actor_id),
        ("trace_id", trace_id),
        ("worker_id", worker_id),
        ("node_id", node_id),
    ):
        if want and not str(rec.get(key) or "").startswith(want):
            return False
    if grep and grep not in str(rec.get("msg") or ""):
        return False
    if since_ts is not None and float(rec.get("ts") or 0.0) <= since_ts:
        return False
    return True


def read_records(
    directory: Optional[str] = None,
    tail: Optional[int] = None,
    **filters: Any,
) -> List[Dict[str, Any]]:
    """Scans a log directory's JSONL files (rotated generations included)
    for records matching the filters, sorted by ts; `tail` keeps only the
    newest N. Tolerates truncated/corrupt lines like tracing.collect.
    Files whose mtime predates a `since_ts` filter are skipped without
    parsing — the `--follow` poll loop must not re-parse the whole
    session history every second."""
    directory = directory or log_dir()
    since_ts = filters.get("since_ts")
    out: List[Dict[str, Any]] = []
    try:
        names = sorted(os.listdir(directory))
    except OSError:
        return out
    for fname in names:
        if not (fname.endswith(".jsonl") or fname.endswith(".jsonl.1")):
            continue
        if since_ts is not None:
            try:
                # 1 s slack: ts is stamped before the buffered write lands.
                if os.path.getmtime(os.path.join(directory, fname)) < since_ts - 1.0:
                    continue
            except OSError:
                continue
        try:
            with open(os.path.join(directory, fname), errors="replace") as f:
                for line in f:
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        continue
                    if not isinstance(rec, dict) or "msg" not in rec:
                        continue
                    if record_matches(rec, **filters):
                        out.append(rec)
        except OSError:
            continue
    out.sort(key=lambda r: r.get("ts") or 0.0)
    if tail is not None and tail >= 0:
        out = out[-tail:]
    return out


def query_cluster(
    gcs,
    node: Optional[str] = None,
    tail: Optional[int] = 1000,
    **filters: Any,
) -> List[Dict[str, Any]]:
    """Cluster-wide log query: fans `tail_logs` out to every alive raylet
    (prefix-filtered by `node`), merges by ts. The GCS client is the only
    handle needed — raylet sockets come from the node table."""
    from ..core.rpc import RpcClient

    try:
        nodes = gcs.call("list_nodes")
    except Exception:
        return []
    merged: List[Dict[str, Any]] = []
    for n in nodes:
        if not n.get("Alive"):
            continue
        if node and not str(n.get("NodeID", "")).startswith(node):
            continue
        cli = None
        try:
            cli = RpcClient(n["sock"], connect_timeout=5.0)
            recs = cli.call("tail_logs", dict(filters, tail=tail), timeout=30.0)
        except Exception:  # lint: swallow-ok(dead node; cluster query merges the live ones)
            continue
        finally:
            if cli is not None:
                cli.close()
        merged.extend(recs or [])
    merged.sort(key=lambda r: r.get("ts") or 0.0)
    if tail is not None and tail >= 0:
        merged = merged[-tail:]
    return merged


def format_record(rec: Dict[str, Any]) -> str:
    """One human line for a structured record."""
    ts = rec.get("ts")
    stamp = (
        time.strftime("%H:%M:%S", time.localtime(ts)) + f".{int(ts % 1 * 1e3):03d}"
        if isinstance(ts, (int, float))
        else "--:--:--"
    )
    ids = []
    if rec.get("actor_id"):
        ids.append(f"actor={str(rec['actor_id'])[:8]}")
    if rec.get("task_id"):
        ids.append(f"task={str(rec['task_id'])[:8]}")
    if rec.get("trace_id"):
        ids.append(f"trace={str(rec['trace_id'])[:8]}")
    suffix = f"  [{' '.join(ids)}]" if ids else ""
    return (
        f"{stamp} {rec.get('level', '?'):<8} "
        f"({rec.get('component', '?')} node={str(rec.get('node_id') or '?')[:8]} "
        f"pid={rec.get('pid', '?')}) {rec.get('msg', '')}{suffix}"
    )


# ------------------------------------------------- driver-side re-printing
class DedupPrinter:
    """Ray-style dedup of the driver's captured-output stream: the first
    occurrence of a line prints immediately; identical repeats within the
    window are suppressed and summarized (`[repeated Nx]`) when the
    window rolls. A global lines/s budget backstops pathological floods
    (10k distinct lines from a hot loop must not freeze the console)."""

    def __init__(
        self,
        print_fn: Optional[Callable[[str], None]] = None,
        window_s: float = 5.0,
        max_lines_per_s: int = 1000,
    ):
        # console-output: the driver re-print of captured worker output
        self._print = print_fn or (lambda s: print(s, flush=True))
        self.window_s = window_s
        self.max_lines_per_s = max_lines_per_s
        self.stats = {"printed": 0, "suppressed": 0}
        self._seen: Dict[str, List[Any]] = {}  # line -> [count, first_ts, prefix]
        self._budget_ts = 0.0
        self._budget = max_lines_per_s
        self._warned_budget = False

    def _spend(self) -> bool:
        now = time.monotonic()
        if now - self._budget_ts >= 1.0:
            self._budget_ts = now
            self._budget = self.max_lines_per_s
            self._warned_budget = False
        if self._budget <= 0:
            if not self._warned_budget:
                self._warned_budget = True
                self._print(
                    f"(ray_tpu) output rate limit hit ({self.max_lines_per_s}"
                    " lines/s); suppressing further lines this second"
                )
            return False
        self._budget -= 1
        return True

    def emit(self, prefix: str, line: str) -> None:
        ent = self._seen.get(line)
        now = time.monotonic()
        if ent is not None and now - ent[1] < self.window_s:
            ent[0] += 1
            self.stats["suppressed"] += 1
            return
        if ent is not None:
            self._flush_entry(line, ent)
        self._seen[line] = [0, now, prefix]
        if len(self._seen) > 4096:
            self._roll(now)
        if self._spend():
            self.stats["printed"] += 1
            self._print(f"{prefix} {line}")
        else:
            self.stats["suppressed"] += 1

    def _flush_entry(self, line: str, ent: List[Any]) -> None:
        count, _, prefix = ent
        if count > 0 and self._spend():
            self.stats["printed"] += 1
            self._print(f"{prefix} {line} [repeated {count}x]")

    def _roll(self, now: float) -> None:
        for line, ent in list(self._seen.items()):
            if now - ent[1] >= self.window_s:
                self._flush_entry(line, ent)
                del self._seen[line]

    def flush(self) -> None:
        """Rolls expired dedup windows (called from the poll loop)."""
        self._roll(time.monotonic())


def capture_prefix(msg: Dict[str, Any]) -> str:
    """`(ActorName pid=... node=...)` — the attribution prefix for one
    `logs`-channel message (reference: the `(pid=...)` prefixes of
    log_monitor.py)."""
    who = msg.get("actor") or f"worker_{str(msg.get('worker_id') or '?')[:6]}"
    return f"({who} pid={msg.get('pid', '?')} node={str(msg.get('node_id') or '?')[:8]})"
