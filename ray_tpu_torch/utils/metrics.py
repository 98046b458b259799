"""User-defined application metrics: Counter, Gauge, Histogram (the port of
ray_tpu/utils/metrics.py).

Re-design of the reference's ray.util.metrics (reference:
python/ray/util/metrics.py Counter/Gauge/Histogram over the C++ OpenCensus
registry, src/ray/stats/metric.h:103). Each process keeps a registry, and a
daemon thread flushes it every second to the GCS metrics table
(`report_metrics`): counters and histograms send their deltas since the
last flush, gauges their last value. The GCS aggregates per metric and tag
set, and `ray_tpu_torch.utils.state.user_metrics()` reads the result.

A flush that fails keeps its records for the next one (at most
`_PENDING_CAP`), so a delta is sent once; a process killed between flushes
loses at most one interval. A forked child flushes only what it records.
"""

from __future__ import annotations

import bisect
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

_FLUSH_INTERVAL_S = 1.0
_registry_lock = threading.Lock()
_registry: List["Metric"] = []
_instances: Dict[Tuple[str, str], "Metric"] = {}
_flusher_pid: Optional[int] = None
# Records that failed to reach the GCS, retried next flush (bounded so a
# long GCS outage cannot grow memory without limit).
_pending_records: List[dict] = []
_PENDING_CAP = 10_000


def _tags_key(tags: Optional[Dict[str, str]]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((tags or {}).items()))


class Metric:
    """Common base: name, description, default tags; values tracked per tag
    set. Constructing the same (class, name) twice returns the same
    instance, so declaring a metric inside a task body does not grow the
    process registry per call."""

    kind = "metric"

    def __new__(cls, name: str, *args, **kwargs):
        key = (cls.__name__, name)
        with _registry_lock:
            inst = _instances.get(key)
            if inst is None:
                inst = super().__new__(cls)
                _instances[key] = inst
            return inst

    def __init__(self, name: str, description: str = "", tag_keys: Tuple[str, ...] = ()):
        if getattr(self, "_initialized", False):
            return
        if not name or not name.replace("_", "").replace(".", "").isalnum():
            raise ValueError(f"invalid metric name {name!r}")
        self._initialized = True
        self.name = name
        self.description = description
        self.tag_keys = tuple(tag_keys)
        self._default_tags: Dict[str, str] = {}
        self._lock = threading.Lock()
        _register(self)

    def set_default_tags(self, tags: Dict[str, str]) -> "Metric":
        self._default_tags = dict(tags)
        return self

    def _merged(self, tags: Optional[Dict[str, str]]) -> Dict[str, str]:
        out = dict(self._default_tags)
        out.update(tags or {})
        extra = set(out) - set(self.tag_keys)
        if extra:
            raise ValueError(f"undeclared tag key(s) {sorted(extra)} for {self.name}")
        return out

    def _collect(self) -> List[dict]:  # pragma: no cover - overridden
        return []

    def _forget(self) -> None:
        """Drops what was recorded before a fork (the parent reports it)."""


class Counter(Metric):
    """Monotonic counter (reference: util/metrics.py Counter.inc)."""

    kind = "counter"

    def __init__(self, name, description: str = "", tag_keys: Tuple[str, ...] = ()):
        first = not getattr(self, "_initialized", False)
        super().__init__(name, description, tag_keys)
        if first:  # re-declaring the singleton must not wipe pending deltas
            self._values: Dict[Tuple, float] = {}

    def inc(self, value: float = 1.0, tags: Optional[Dict[str, str]] = None) -> None:
        if value < 0:
            raise ValueError("Counter.inc value must be >= 0")
        k = _tags_key(self._merged(tags))
        with self._lock:
            self._values[k] = self._values.get(k, 0.0) + value

    def _collect(self) -> List[dict]:
        with self._lock:
            vals, self._values = self._values, {}
        return [{"name": self.name, "kind": "counter", "tags": dict(k), "value": v}
                for k, v in vals.items()]

    def _forget(self) -> None:
        self._values = {}


class Gauge(Metric):
    """Last-value-wins gauge (reference: util/metrics.py Gauge.set)."""

    kind = "gauge"

    def __init__(self, name, description: str = "", tag_keys: Tuple[str, ...] = ()):
        first = not getattr(self, "_initialized", False)
        super().__init__(name, description, tag_keys)
        if first:
            self._values: Dict[Tuple, float] = {}

    def set(self, value: float, tags: Optional[Dict[str, str]] = None) -> None:
        k = _tags_key(self._merged(tags))
        with self._lock:
            self._values[k] = float(value)

    def _collect(self) -> List[dict]:
        with self._lock:
            vals = dict(self._values)
        return [{"name": self.name, "kind": "gauge", "tags": dict(k), "value": v}
                for k, v in vals.items()]

    def _forget(self) -> None:
        self._values = {}


class Histogram(Metric):
    """Bucketed distribution (reference: util/metrics.py Histogram.observe
    with explicit boundaries). Bucket i counts values at or below
    boundaries[i] (and above the one before); the last bucket the rest."""

    kind = "histogram"

    def __init__(self, name, description: str = "", boundaries: Optional[List[float]] = None,
                 tag_keys: Tuple[str, ...] = ()):
        first = not getattr(self, "_initialized", False)
        if first and not boundaries:
            # Checked before registration: a half-made singleton would break
            # every later declaration and the flusher.
            raise ValueError("Histogram requires explicit bucket boundaries")
        super().__init__(name, description, tag_keys)
        if first:
            self.boundaries = sorted(float(b) for b in boundaries)
            self._counts: Dict[Tuple, List[int]] = {}
            self._sums: Dict[Tuple, float] = {}

    def observe(self, value: float, tags: Optional[Dict[str, str]] = None) -> None:
        k = _tags_key(self._merged(tags))
        idx = bisect.bisect_left(self.boundaries, value)
        with self._lock:
            counts = self._counts.setdefault(k, [0] * (len(self.boundaries) + 1))
            counts[idx] += 1
            self._sums[k] = self._sums.get(k, 0.0) + value

    def _collect(self) -> List[dict]:
        with self._lock:
            counts, self._counts = self._counts, {}
            sums, self._sums = self._sums, {}
        return [{"name": self.name, "kind": "histogram", "tags": dict(k),
                 "value": sums.get(k, 0.0), "counts": c, "boundaries": self.boundaries}
                for k, c in counts.items()]

    def _forget(self) -> None:
        self._counts, self._sums = {}, {}


def _register(metric: Metric) -> None:
    with _registry_lock:
        _registry.append(metric)
    _ensure_flusher()


def _ensure_flusher() -> None:
    global _flusher_pid
    with _registry_lock:
        if _flusher_pid == os.getpid():
            return
        _flusher_pid = os.getpid()
    threading.Thread(target=_flush_loop, daemon=True, name="metrics").start()


def _flush_once() -> None:
    """Sends every metric's records, with those a failed flush kept."""
    global _pending_records
    from ..core import runtime_base

    rt = runtime_base.maybe_runtime()
    gcs = getattr(rt, "_gcs", None)
    if gcs is None or getattr(rt, "_shutdown_done", False):
        return
    with _registry_lock:
        metrics = list(_registry)
        records, _pending_records = _pending_records, []
    for m in metrics:
        records.extend(m._collect())
    if not records:
        return
    try:
        gcs.call("report_metrics", getattr(rt, "_worker_id", "?"), records, timeout=10.0)
    except Exception:  # noqa: BLE001 - the deltas were drained: keep them
        with _registry_lock:
            _pending_records = (records + _pending_records)[:_PENDING_CAP]


def _flush_loop() -> None:
    while _flusher_pid == os.getpid():
        time.sleep(_FLUSH_INTERVAL_S)
        _flush_once()


def _after_fork_in_child() -> None:
    global _flusher_pid, _pending_records, _registry_lock
    _registry_lock = threading.Lock()
    _pending_records = []
    _flusher_pid = None
    for m in _registry:
        m._lock = threading.Lock()
        m._forget()
    if _registry:
        _ensure_flusher()


os.register_at_fork(after_in_child=_after_fork_in_child)
