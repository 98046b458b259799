"""Tracing: spans with context propagation across processes (the port of
ray_tpu/tracing.py).

Spans are plain dicts `{trace_id, span_id, parent_id, name, pid, tid,
start_us, end_us, attrs}`; the ambient context rides a contextvar, so spans
opened inside a span parent to it. A submitter stamps `inject_context()`
into each task entry as `trace_ctx` (core/cluster_runtime.py); the worker
re-roots its execution span under it with `continue_context`, so a span
opened in a worker process parents to the driver's. `inject_context()` also
mints a flow id: the submit-side span carries it as `flow_out`, the
raylet's schedule span as `flow_step`, the executing span as `flow_in`
(observability/perfetto.py draws them as arrows).

Exporters are pluggable: `tracing.enable(InMemoryExporter())` in-process,
or `RAY_TPU_TRACING=1` (inherited by the cluster's daemons and workers),
which writes one JSONL file per process under $RAY_TPU_TRACE_DIR;
`collect()` merges those files, tolerating torn lines. The exporter the
environment starts follows `trace_dir()` as it stands: a process whose
RAY_TPU_TRACE_DIR changes writes its next span to the new directory (the
JAX copy keeps the first one). Span open and close also feed the flight
recorder.
"""

from __future__ import annotations

import atexit
import contextlib
import contextvars
import json
import os
import threading
import time
import uuid
from typing import Any, Dict, List, Optional

from .observability.flight_recorder import record as _frec

_ctx: "contextvars.ContextVar[Optional[dict]]" = contextvars.ContextVar(
    "ray_tpu_torch_trace_ctx", default=None
)

_lock = threading.Lock()
_exporter: Optional["SpanExporter"] = None  # set by enable()
_env_exporter: Optional["JsonlExporter"] = None  # started by RAY_TPU_TRACING=1


class SpanExporter:
    def export(self, span: dict) -> None:  # pragma: no cover - interface
        raise NotImplementedError

    def shutdown(self) -> None:
        pass


class InMemoryExporter(SpanExporter):
    def __init__(self):
        self.spans: List[dict] = []

    def export(self, span: dict) -> None:
        self.spans.append(span)


class JsonlExporter(SpanExporter):
    """One JSONL file per process under <dir>/, flushed and fsynced at
    exit (registered with atexit) if disable() was not called."""

    def __init__(self, directory: str):
        os.makedirs(directory, exist_ok=True)
        self.directory = directory
        self.path = os.path.join(directory, f"spans_{os.getpid()}.jsonl")
        self._f = open(self.path, "a", buffering=1)
        self._flock = threading.Lock()
        atexit.register(self.shutdown)

    def export(self, span: dict) -> None:
        with self._flock:
            if not self._f.closed:  # a span that outlived its exporter's switch
                self._f.write(json.dumps(span, default=repr) + "\n")

    def shutdown(self) -> None:
        with contextlib.suppress(Exception):
            with self._flock:
                if not self._f.closed:
                    self._f.flush()
                    os.fsync(self._f.fileno())
                    self._f.close()
        atexit.unregister(self.shutdown)


def enable(exporter: Optional[SpanExporter] = None) -> None:
    """Turns tracing on in THIS process. Without an exporter, spans go to
    JSONL under $RAY_TPU_TRACE_DIR (or the tmp default)."""
    global _exporter
    with _lock:
        if exporter is None:
            exporter = JsonlExporter(trace_dir())
        _exporter = exporter


def disable() -> None:
    global _exporter, _env_exporter
    with _lock:
        for exp in (_exporter, _env_exporter):
            if exp is not None:
                exp.shutdown()
        _exporter = _env_exporter = None


def trace_dir() -> str:
    import tempfile

    return os.environ.get("RAY_TPU_TRACE_DIR") or os.path.join(
        tempfile.gettempdir(), "ray_tpu_traces"
    )


def _active() -> Optional[SpanExporter]:
    global _env_exporter
    exp = _exporter
    if exp is not None:
        return exp
    if os.environ.get("RAY_TPU_TRACING") != "1":
        return None
    # The env toggle lazily starts the JSONL sink, in the directory the
    # environment names now: a changed RAY_TPU_TRACE_DIR switches the sink.
    directory = trace_dir()
    env = _env_exporter
    if env is None or env.directory != directory:
        with _lock:
            old = _env_exporter
            if old is None or old.directory != directory:
                _env_exporter = JsonlExporter(directory)
                if old is not None:
                    old.shutdown()
            env = _env_exporter
    return env


def is_enabled() -> bool:
    return _active() is not None


def new_flow_id() -> str:
    """A fresh id for one cross-process edge (submit->execute,
    request->replica), drawn as a Perfetto flow arrow."""
    return uuid.uuid4().hex[:16]


def null_span(name=None, attrs=None):
    """A no-op stand-in for span(); hot loops that check is_enabled()
    once pick between the two instead of re-checking per span."""
    return contextlib.nullcontext()


def maybe_span(name: str, attrs: Optional[Dict[str, Any]] = None):
    """span() when tracing is on, else a no-op context: the one-liner for
    instrumenting a call site without an enabled-check of its own."""
    return span(name, attrs) if is_enabled() else contextlib.nullcontext()


# ----------------------------------------------------------------- spans
@contextlib.contextmanager
def span(name: str, attrs: Optional[Dict[str, Any]] = None):
    """Opens a span under the ambient context; sets itself as ambient for
    the duration, so spans opened inside it parent to it."""
    exp = _active()
    if exp is None:
        yield None
        return
    parent = _ctx.get()
    sp = {
        "trace_id": parent["trace_id"] if parent else uuid.uuid4().hex,
        "span_id": uuid.uuid4().hex[:16],
        "parent_id": parent["span_id"] if parent else None,
        "name": name,
        "pid": os.getpid(),
        "tid": threading.get_ident() & 0xFFFFFFFF,
        "start_us": int(time.time() * 1e6),
        "attrs": attrs or {},
    }
    token = _ctx.set({"trace_id": sp["trace_id"], "span_id": sp["span_id"]})
    # The thread id tells two concurrent same-named spans apart.
    _frec("span_open", (name, sp["tid"]))
    try:
        yield sp
    except BaseException as e:
        sp["attrs"]["error"] = repr(e)
        raise
    finally:
        _ctx.reset(token)
        sp["end_us"] = int(time.time() * 1e6)
        _frec("span_close", (name, sp["tid"]))
        exp.export(sp)


def current_context() -> Optional[dict]:
    """The ambient {trace_id, span_id}, or None with tracing off."""
    if not is_enabled():
        return None
    return _ctx.get()


def inject_context() -> Optional[dict]:
    """The context a submitter stamps into an outgoing task entry: the
    ambient {trace_id, span_id} plus a fresh flow id for the submit->execute
    arrow. With no ambient span the entry still gets a trace_id (the
    execution roots a new trace) and a flow id, so the arrow exists even
    for fire-and-forget submissions. None with tracing off."""
    if not is_enabled():
        return None
    ctx = _ctx.get()
    return {
        "trace_id": ctx["trace_id"] if ctx else uuid.uuid4().hex,
        "span_id": ctx["span_id"] if ctx else None,
        "flow": new_flow_id(),
    }


@contextlib.contextmanager
def continue_context(trace_ctx: Optional[dict], name: str, attrs=None):
    """Re-roots the ambient context from a propagated trace_ctx, then opens
    a span under it; a flow id riding the context lands on the span as
    `flow_in`."""
    if trace_ctx and is_enabled():
        if trace_ctx.get("flow"):
            attrs = dict(attrs or {})
            attrs["flow_in"] = trace_ctx["flow"]
        # Copy: the ambient context must carry ONLY the span identity —
        # a flow id leaking into child spans would pair arrows twice.
        token = _ctx.set(
            {
                "trace_id": trace_ctx.get("trace_id"),
                "span_id": trace_ctx.get("span_id"),
            }
        )
        try:
            with span(name, attrs) as sp:
                yield sp
        finally:
            _ctx.reset(token)
    else:
        with span(name, attrs) as sp:
            yield sp


# ------------------------------------------------------------- collection
def collect(directory: Optional[str] = None) -> List[dict]:
    """Merges every process's JSONL spans (stable-sorted by start time).

    Tolerant of truncated/corrupt lines: a worker killed mid-write leaves
    a partial last line, and one poisoned file must not discard every
    other process's spans: the line is skipped, the rest kept."""
    directory = directory or trace_dir()
    spans: List[dict] = []
    try:
        names = sorted(os.listdir(directory))
    except OSError:
        return spans
    for fname in names:
        if not fname.endswith(".jsonl"):
            continue
        try:
            with open(os.path.join(directory, fname), errors="replace") as f:
                for line in f:
                    try:
                        sp = json.loads(line)
                    except ValueError:
                        continue  # truncated/corrupt line
                    # A partial write can still parse (a bare number from a
                    # split record): only span-shaped dicts merge.
                    if isinstance(sp, dict) and "span_id" in sp:
                        spans.append(sp)
        except OSError:
            continue
    spans.sort(key=lambda s: s.get("start_us", 0))
    return spans


def span_tree(spans: List[dict]) -> Dict[Optional[str], List[dict]]:
    """Groups spans by parent_id for tree walks in tests and tools."""
    by_parent: Dict[Optional[str], List[dict]] = {}
    for s in spans:
        by_parent.setdefault(s.get("parent_id"), []).append(s)
    return by_parent
