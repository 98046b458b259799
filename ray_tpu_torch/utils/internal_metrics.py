"""Runtime-internal metrics (ray_tpu/utils/internal_metrics.py for the
PyTorch port), trimmed to the catalog entries that the LLM engine, Serve,
the feed's channel, the chaos controller, the cluster runtime and the
trainer record into.

The instruments keep the JAX package's surface: `Counter.inc`,
`Gauge.set`, `Histogram.observe`, and `.labels(**tags)` returning a bound
lane that hot paths cache. The JAX package flushes deltas to its GCS
every second; the port's flush is not ported yet (ROADMAP Queue 1 item
3.8), so values stay in the process that recorded them (a counter the GCS
daemon bumps is read in that daemon) and `snapshot()` reads them.
`RAY_TPU_INTERNAL_METRICS=0` turns every instrument into a no-op.
"""

from __future__ import annotations

import bisect
import os
import threading
from typing import Any, Dict, List, Optional, Tuple

_enabled = os.environ.get("RAY_TPU_INTERNAL_METRICS", "1") != "0"
_lock = threading.Lock()
_registry: Dict[str, "InternalMetric"] = {}

# Latency histograms default to these millisecond buckets.
DEFAULT_LATENCY_BOUNDARIES_MS = [
    0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
    1000.0, 2500.0, 5000.0,
]


def set_enabled(flag: bool) -> None:
    global _enabled
    _enabled = bool(flag)


def is_enabled() -> bool:
    return _enabled


# ------------------------------------------------------------- instruments
class _BoundCounter:
    __slots__ = ("_value", "_mu")

    def __init__(self):
        self._value = 0.0
        self._mu = threading.Lock()

    def inc(self, value: float = 1.0) -> None:
        if not _enabled:
            return
        with self._mu:
            self._value += value

    def read(self) -> float:
        return self._value


class _BoundGauge:
    __slots__ = ("_value",)

    def __init__(self):
        self._value = 0.0

    def set(self, value: float) -> None:
        if not _enabled:
            return
        self._value = float(value)

    def read(self) -> float:
        return self._value


class _BoundHistogram:
    """Sum, count and per-bucket counts (bucket i holds values at or below
    boundaries[i]; the last bucket the rest)."""

    __slots__ = ("_boundaries", "_sum", "_counts", "_mu")

    def __init__(self, boundaries: List[float]):
        self._boundaries = boundaries
        self._sum = 0.0
        self._counts = [0] * (len(boundaries) + 1)
        self._mu = threading.Lock()

    def observe(self, value: float) -> None:
        if not _enabled:
            return
        with self._mu:
            self._sum += value
            self._counts[bisect.bisect_left(self._boundaries, value)] += 1

    def read(self) -> Dict[str, Any]:
        with self._mu:
            return {"sum": self._sum, "count": sum(self._counts),
                    "counts": list(self._counts), "boundaries": self._boundaries}


class InternalMetric:
    """Named, described, component-labeled; tag-bound lanes are cached so
    `.labels(**tags)` is a dict hit after first use."""

    kind = "metric"

    def __init__(self, name: str, description: str = "", component: str = "core",
                 tag_keys: Tuple[str, ...] = ()):
        if not name or not name.replace("_", "").isalnum():
            raise ValueError(f"invalid internal metric name {name!r}")
        self.name = name
        self.description = description
        self.component = component
        self.tag_keys = tuple(tag_keys)
        self._bound: Dict[Tuple, Any] = {}
        with _lock:
            prior = _registry.get(name)
            if prior is not None:  # re-declaration (module reload) keeps state
                self.__dict__ = prior.__dict__
                return
            _registry[name] = self

    def _make_bound(self):  # pragma: no cover - overridden
        raise NotImplementedError

    def labels(self, **tags: str):
        key = tuple(sorted((k, str(v)) for k, v in tags.items()))
        b = self._bound.get(key)
        if b is None:
            extra = set(tags) - set(self.tag_keys)
            if extra:
                raise ValueError(f"undeclared tag key(s) {sorted(extra)} for {self.name}")
            with _lock:
                b = self._bound.setdefault(key, self._make_bound())
        return b

    def values(self) -> Dict[Tuple, Any]:
        """{sorted (tag, value) pairs: the lane's reading}."""
        return {key: b.read() for key, b in list(self._bound.items())}


class Counter(InternalMetric):
    kind = "counter"

    def _make_bound(self):
        return _BoundCounter()

    def inc(self, value: float = 1.0, **tags: str) -> None:
        self.labels(**tags).inc(value)


class Gauge(InternalMetric):
    kind = "gauge"

    def _make_bound(self):
        return _BoundGauge()

    def set(self, value: float, **tags: str) -> None:
        self.labels(**tags).set(value)


class Histogram(InternalMetric):
    kind = "histogram"

    def __init__(self, name: str, description: str = "", component: str = "core",
                 boundaries: Optional[List[float]] = None, tag_keys: Tuple[str, ...] = ()):
        self.boundaries = sorted(float(b) for b in (boundaries or DEFAULT_LATENCY_BOUNDARIES_MS))
        super().__init__(name, description, component, tag_keys)

    def _make_bound(self):
        return _BoundHistogram(self.boundaries)

    def observe(self, value: float, **tags: str) -> None:
        self.labels(**tags).observe(value)


def snapshot() -> Dict[str, Dict[Tuple, Any]]:
    """Every metric's lanes: {name: {tags: value}}."""
    with _lock:
        metrics = list(_registry.values())
    return {m.name: m.values() for m in metrics}


# ============================================================ metric_defs
# The JAX package's catalog entries for the paths the port has, with the
# same names, components and tag keys.

# --- compiled-graph data plane: the LLM feed's channels -------------------
CGRAPH_CHANNEL_MSGS = Counter(
    "raytpu_cgraph_channel_msgs_total",
    "Messages written per compiled-graph channel edge",
    component="cgraph",
    tag_keys=("channel",),
)
CGRAPH_CHANNEL_BYTES = Counter(
    "raytpu_cgraph_channel_bytes_total",
    "Payload bytes written per compiled-graph channel edge",
    component="cgraph",
    tag_keys=("channel",),
)
CGRAPH_RING_HWM = Gauge(
    "raytpu_cgraph_ring_occupancy_hwm_bytes",
    "High-water mark of ring-buffer occupancy per compiled-graph channel",
    component="cgraph",
    tag_keys=("channel",),
)
# --- serve ------------------------------------------------------------------
SERVE_REQUESTS = Counter(
    "raytpu_serve_requests_total",
    "Serve requests handled, by deployment",
    component="serve",
    tag_keys=("deployment",),
)
SERVE_REQUEST_LATENCY = Histogram(
    "raytpu_serve_request_latency_ms",
    "Serve replica request latency, by deployment",
    component="serve",
    tag_keys=("deployment",),
)
SERVE_TTFT = Histogram(
    "raytpu_serve_ttft_ms",
    "Serve time to first result/chunk (replica-side), by deployment",
    component="serve",
    tag_keys=("deployment",),
)
SERVE_QUEUE_DEPTH = Gauge(
    "raytpu_serve_queue_depth",
    "In-flight requests on this replica (streams count until drained)",
    component="serve",
    tag_keys=("deployment",),
)
SERVE_TOKENS_PER_S = Gauge(
    "raytpu_serve_tokens_per_s",
    "LLM engine decode throughput (emitted tokens/s, per deployment)",
    component="serve",
    tag_keys=("deployment",),
)
SERVE_TPOT = Histogram(
    "raytpu_serve_tpot_ms",
    "LLM engine time-per-output-token (decode step latency), by deployment",
    component="serve",
    tag_keys=("deployment",),
)
KV_PAGES_USED = Gauge(
    "raytpu_kv_pages_used",
    "KV-cache pages currently referenced by live sequences",
    component="serve",
    tag_keys=("deployment",),
)
KV_PAGES_TOTAL = Gauge(
    "raytpu_kv_pages_total",
    "KV-cache pages in the pool (capacity, constant per engine)",
    component="serve",
    tag_keys=("deployment",),
)
PREFIX_CACHE_HITS = Counter(
    "raytpu_prefix_cache_hits_total",
    "Prompt pages served from the hashed-prefix radix index",
    component="serve",
    tag_keys=("deployment",),
)
PREFIX_CACHE_MISSES = Counter(
    "raytpu_prefix_cache_misses_total",
    "Prompt pages that required a fresh physical page",
    component="serve",
    tag_keys=("deployment",),
)
SERVE_REQUESTS_SHED = Counter(
    "raytpu_serve_requests_shed_total",
    "LLM requests rejected with backpressure (pool exhausted / queue full)",
    component="serve",
    tag_keys=("deployment",),
)
# --- train ------------------------------------------------------------------
TRAIN_REPORTS = Counter(
    "raytpu_train_reports_total",
    "train.report() calls (one per training step loop iteration)",
    component="train",
)
TRAIN_STEP_TIME = Histogram(
    "raytpu_train_step_time_ms",
    "Wall time between consecutive train.report() calls",
    component="train",
    boundaries=[1, 5, 10, 50, 100, 500, 1000, 5000, 10000, 60000],
)
TRAIN_TOKENS_PER_S = Gauge(
    "raytpu_train_tokens_per_s",
    "Reported training throughput (mirrored from report() metrics)",
    component="train",
    tag_keys=("trial", "rank"),
)
TRAIN_MFU = Gauge(
    "raytpu_train_mfu",
    "Reported model FLOPs utilization (mirrored from report() metrics)",
    component="train",
    tag_keys=("trial", "rank"),
)
TRAIN_PHASE_TIME = Histogram(
    "raytpu_train_phase_time_ms",
    "Per-step training phase durations (train.phase: data_wait / compute / allreduce / ...)",
    component="train",
    boundaries=[0.5, 1, 5, 10, 50, 100, 500, 1000, 5000, 10000, 60000],
    tag_keys=("phase",),
)
TRAIN_GOODPUT = Gauge(
    "raytpu_train_goodput",
    "Goodput fraction: productive step time / total wall time of the run",
    component="train",
    tag_keys=("trial",),
)
TRAIN_WORLD_SIZE = Gauge(
    "raytpu_train_world_size",
    "Current training gang world size (elastic runs move below target)",
    component="train",
    tag_keys=("trial",),
)
TRAIN_RESHARD_TIME = Histogram(
    "raytpu_train_reshard_ms",
    "Elastic checkpoint save/load/reshard durations, by operation",
    component="train",
    boundaries=[1, 5, 10, 50, 100, 500, 1000, 5000, 10000, 60000],
    tag_keys=("op",),
)
TRAIN_ELASTIC_RESIZES = Counter(
    "raytpu_train_elastic_resizes_total",
    "Elastic gang renegotiations, by direction (downsize / growback)",
    component="train",
    tag_keys=("direction",),
)
CHECKPOINTS_RESTORED = Counter(
    "raytpu_checkpoints_restored_total",
    "Training attempts resumed from a checkpoint after a gang failure",
    component="train",
)
NODES_DRAINED = Counter(
    "raytpu_nodes_drained_total",
    "Nodes that entered the draining state on a preemption notice",
    component="gcs",
)
# --- worker pool and zygote (core/worker_pool.py, core/zygote.py) ----------
WORKER_POOL_HITS = Counter(
    "raytpu_worker_pool_hits_total",
    "Worker demand served warm, by tier: idle (a live pooled worker adopted) "
    "or prefork (a zygote's parked child assigned)",
    component="worker_pool",
    tag_keys=("tier",),
)
WORKER_POOL_MISSES = Counter(
    "raytpu_worker_pool_misses_total",
    "Worker demand that paid a cold spawn, by mechanism (zygote fork or popen)",
    component="worker_pool",
    tag_keys=("mode",),
)
WORKER_POOL_SIZE = Gauge(
    "raytpu_worker_pool_size",
    "Warm-pool inventory by tier: idle live workers, zygote parked pre-forks",
    component="worker_pool",
    tag_keys=("tier",),
)
WORKER_POOL_TARGET = Gauge(
    "raytpu_worker_pool_target",
    "Demand-sized idle-pool target the refill loop maintains",
    component="worker_pool",
)
WORKER_POOL_REFILL_LAG = Gauge(
    "raytpu_worker_pool_refill_lag",
    "Workers the idle pool is short of its target",
    component="worker_pool",
)
WORKER_SPAWN_TOTAL = Counter(
    "raytpu_worker_spawn_total",
    "Worker processes spawned, by mechanism",
    component="zygote",
    tag_keys=("mode",),
)
ZYGOTE_RESPAWNS = Counter(
    "raytpu_zygote_respawns_total",
    "Zygote daemons respawned after death (the parked pool is rebuilt)",
    component="zygote",
)
ZYGOTE_FORK_LATENCY = Histogram(
    "raytpu_zygote_fork_latency_ms",
    "Worker spawn latency, by mechanism (prefork, zygote fork, popen)",
    component="zygote",
    tag_keys=("mode",),
)
# --- chaos ------------------------------------------------------------------
CHAOS_INJECTIONS = Counter(
    "raytpu_chaos_injections_total",
    "Faults injected by the chaos controller, by point and action",
    component="chaos",
    tag_keys=("point", "action"),
)
