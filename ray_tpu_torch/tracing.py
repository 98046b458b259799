"""Tracing: spans with context propagation (copy of ray_tpu/tracing.py for
the PyTorch port, trimmed to the spans Serve and the trainer open: the
handle's `serve.request`, the replica's `serve.replica`, the response's
`serve.response` and the training loop's `train.phase.<name>`).

Spans are plain dicts `{trace_id, span_id, parent_id, name, start_us,
end_us, attrs}`; the ambient context rides a contextvar, so spans opened
inside a span parent to it. Exporters are pluggable: `tracing.enable(InMemoryExporter())` in-process,
or `RAY_TPU_TRACING=1`, which writes JSONL under $RAY_TPU_TRACE_DIR. Span
open and close also feed the flight recorder.
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
_exporter: Optional["SpanExporter"] = None
_enabled_env = os.environ.get("RAY_TPU_TRACING") == "1"


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
        self.path = os.path.join(directory, f"spans_{os.getpid()}.jsonl")
        self._f = open(self.path, "a", buffering=1)
        self._flock = threading.Lock()
        atexit.register(self.shutdown)

    def export(self, span: dict) -> None:
        with self._flock:
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
    global _exporter
    with _lock:
        if _exporter is not None:
            _exporter.shutdown()
        _exporter = None


def trace_dir() -> str:
    import tempfile

    return os.environ.get("RAY_TPU_TRACE_DIR") or os.path.join(
        tempfile.gettempdir(), "ray_tpu_traces"
    )


def _active() -> Optional[SpanExporter]:
    global _exporter
    if _exporter is not None:
        return _exporter
    if _enabled_env or os.environ.get("RAY_TPU_TRACING") == "1":
        # The env toggle lazily starts the JSONL sink.
        with _lock:
            if _exporter is None:
                _exporter = JsonlExporter(trace_dir())
        return _exporter
    return None


def is_enabled() -> bool:
    return _active() is not None


def new_flow_id() -> str:
    """A fresh id for one request->response edge."""
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
