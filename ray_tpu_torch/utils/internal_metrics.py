"""Runtime-internal metrics (ray_tpu/utils/internal_metrics.py for the
PyTorch port): the catalog entries that the port's paths record into. Those
are the LLM engine, Serve, compiled graphs and the feed's channels, Data's
executors and operator pools, the chaos controller, the cluster runtime
(the raylet's scheduler, worker pool, GCS sync and task retries, the object
plane and the store's puts, the fast path, the GCS with its actor restarts,
error table, trigger bus, RPCs and heartbeat lag), the trainer, the log
monitor and the log retention GC, the lock-order detector
(utils/lock_order.py) and the per-node ReporterAgent. Every entry is
recorded somewhere and every `raytpu_*` name the port reads is declared
here: `python -m ray_tpu_torch.devtools.lint`'s metric-catalog rule holds
both directions.

The instruments keep the JAX package's surface: `Counter.inc`,
`Gauge.set`, `Histogram.observe`, and `.labels(**tags)` returning a bound
lane that hot paths cache. Each lane keeps its process's cumulative value
(`snapshot()` reads them). A daemon thread, started on a lane's first use,
flushes the deltas since the last flush every second to the GCS's
internal-metrics table (`report_internal_metrics`), where they add up per
metric and tags across processes and `utils/state.py`'s
`internal_metrics()` reads them. Every record carries `component` and
`node_id` tags. The raylet and the GCS daemon set their own sink
(`configure`); workers and drivers flush through their runtime's GCS
client. A failed flush keeps its records for the next one, up to
`_PENDING_CAP`, so a delta is sent once; a process killed between flushes
loses at most one interval. A forked child starts its own flusher and does
not report what its parent recorded before the fork.
`RAY_TPU_INTERNAL_METRICS=0` turns every instrument into a no-op and starts
no flusher.

`ReporterAgent` runs in each raylet (and in any process that starts one): it
reads the node's CPU and memory, the process's RSS and open fds from /proc,
and each visible CUDA device's `torch.cuda.memory_allocated` -- only where
torch is already imported and CUDA already initialised in that process, so
the reporter never creates a CUDA context (the raylet, which never imports
torch, reports no device gauge).
"""

from __future__ import annotations

import bisect
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

_FLUSH_INTERVAL_S = 1.0
_PENDING_CAP = 10_000

_enabled = os.environ.get("RAY_TPU_INTERNAL_METRICS", "1") != "0"
_lock = threading.Lock()
_registry: Dict[str, "InternalMetric"] = {}
_flusher_pid: Optional[int] = None  # the process whose flusher runs
_pending: List[dict] = []
_node_id: Optional[str] = None
_reporter: Optional[str] = None
_sink: Optional[Callable[[List[dict]], None]] = None

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


def configure(node_id: Optional[str] = None, reporter: Optional[str] = None,
              sink: Optional[Callable[[List[dict]], None]] = None) -> None:
    """Stamps this process's node onto its flushed records and names it as
    their reporter; `sink` overrides where they go (the raylet's GCS
    client, the GCS's own table). Without one, records go to the current
    runtime's GCS."""
    global _node_id, _reporter, _sink
    with _lock:
        if node_id is not None:
            _node_id = node_id
        if reporter is not None:
            _reporter = reporter
        _sink = sink


# ------------------------------------------------------------- instruments
class _BoundCounter:
    __slots__ = ("_value", "_mu", "_flushed")

    def __init__(self):
        self._value = 0.0
        self._mu = threading.Lock()
        self._flushed = 0.0  # the total the last flush reported

    def inc(self, value: float = 1.0) -> None:
        if not _enabled:
            return
        with self._mu:
            self._value += value

    def read(self) -> float:
        return self._value

    def _delta(self) -> Optional[dict]:
        with self._mu:
            d, self._flushed = self._value - self._flushed, self._value
        return {"value": d} if d else None

    def _rebase(self) -> None:
        self._flushed = self._value


class _BoundGauge:
    __slots__ = ("_value", "_set", "_once")

    def __init__(self):
        self._value = 0.0
        self._set = False
        self._once = False

    def set(self, value: float, once: bool = False) -> None:
        """`once=True` ships the value on exactly one flush and then stops
        re-reporting it: the terminal value of a finished run (a final
        goodput) must not be asserted by the flusher forever, so the GCS
        drops the stale gauge ~30 s later and history windows age the
        sample out, and an alert on it can clear."""
        if not _enabled:
            return
        self._value = float(value)
        self._set = True
        self._once = bool(once)

    def read(self) -> float:
        return self._value

    def _delta(self) -> Optional[dict]:
        # Re-sent every flush (but once): the GCS keeps a gauge's value per
        # reporter and drops a reporter silent for 30 s.
        if not self._set:
            return None
        if self._once:
            self._set = False
        return {"value": self._value}

    def _rebase(self) -> None:
        self._set = False


class _BoundHistogram:
    """Sum, count and per-bucket counts (bucket i holds values at or below
    boundaries[i]; the last bucket the rest)."""

    __slots__ = ("_boundaries", "_sum", "_counts", "_mu", "_flushed_sum", "_flushed_counts")

    def __init__(self, boundaries: List[float]):
        self._boundaries = boundaries
        self._sum = 0.0
        self._counts = [0] * (len(boundaries) + 1)
        self._mu = threading.Lock()
        self._flushed_sum = 0.0
        self._flushed_counts = [0] * (len(boundaries) + 1)

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

    def _delta(self) -> Optional[dict]:
        with self._mu:
            counts = [a - b for a, b in zip(self._counts, self._flushed_counts)]
            d_sum = self._sum - self._flushed_sum
            self._flushed_counts, self._flushed_sum = list(self._counts), self._sum
        if not any(counts):
            return None
        return {"value": d_sum, "counts": counts, "boundaries": self._boundaries}

    def _rebase(self) -> None:
        self._flushed_counts, self._flushed_sum = list(self._counts), self._sum


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
            _ensure_flusher()
        return b

    def values(self) -> Dict[Tuple, Any]:
        """{sorted (tag, value) pairs: the lane's reading}."""
        return {key: b.read() for key, b in list(self._bound.items())}

    def _collect(self, node_id: str) -> List[dict]:
        out = []
        for key, b in list(self._bound.items()):
            rec = b._delta()
            if rec is None:
                continue
            tags = dict(key)
            tags["component"] = self.component
            tags.setdefault("node_id", node_id)
            rec.update({"name": self.name, "kind": self.kind, "tags": tags})
            out.append(rec)
        return out


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

    def set(self, value: float, once: bool = False, **tags: str) -> None:
        self.labels(**tags).set(value, once=once)


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


def help_texts() -> Dict[str, str]:
    """name -> description, for Prometheus # HELP lines."""
    with _lock:
        return {m.name: m.description for m in _registry.values()}


def snapshot() -> Dict[str, Dict[Tuple, Any]]:
    """Every metric's lanes in this process: {name: {tags: value}}."""
    with _lock:
        metrics = list(_registry.values())
    return {m.name: m.values() for m in metrics}


# ------------------------------------------------------------------ flusher
def _default_sink() -> Optional[Callable[[List[dict]], None]]:
    from ..core import runtime_base

    rt = runtime_base.maybe_runtime()
    gcs = getattr(rt, "_gcs", None)
    if gcs is None or getattr(rt, "_shutdown_done", False):
        return None
    rid = _reporter or getattr(rt, "_worker_id", None) or f"pid{os.getpid()}"
    return lambda recs: gcs.call("report_internal_metrics", rid, recs, timeout=10.0)


def _flush_once() -> None:
    """Sends every lane's delta since the last flush, with the records a
    failed flush kept; keeps them (at most `_PENDING_CAP`) if this one fails
    or no GCS is there yet."""
    global _pending
    sink = _sink or _default_sink()
    with _lock:
        metrics = list(_registry.values())
        records, _pending = _pending, []
        node = _node_id or f"pid{os.getpid()}"
    for m in metrics:
        records.extend(m._collect(node))
    if not records:
        return
    try:
        if sink is None:
            raise ConnectionError("no GCS to flush to")
        sink(records)
    except Exception:  # noqa: BLE001 - kept for the next flush
        with _lock:
            _pending = (records + _pending)[:_PENDING_CAP]


def _flush_loop() -> None:
    while _flusher_pid == os.getpid():
        time.sleep(_FLUSH_INTERVAL_S)
        _flush_once()


def _ensure_flusher() -> None:
    """Starts this process's flusher on a lane's first use (never at import:
    the zygote imports this module and must not run a thread when it
    forks)."""
    global _flusher_pid
    if not _enabled or _flusher_pid == os.getpid():
        return
    with _lock:
        if _flusher_pid == os.getpid():
            return
        _flusher_pid = os.getpid()
    threading.Thread(target=_flush_loop, daemon=True, name="internal-metrics").start()


def _after_fork_in_child() -> None:
    """A forked child reports only what it records itself: the parent's
    unflushed deltas stay the parent's, and the parent's flusher thread did
    not survive the fork."""
    global _flusher_pid, _pending, _lock
    _lock = threading.Lock()
    _pending = []
    _flusher_pid = None
    lanes = [b for m in _registry.values() for b in m._bound.values()]
    for b in lanes:
        if hasattr(b, "_mu"):
            b._mu = threading.Lock()
        b._rebase()
    if lanes:
        _ensure_flusher()


os.register_at_fork(after_in_child=_after_fork_in_child)


# ============================================================ metric_defs
# The JAX package's catalog entries for the paths the port has, with the
# same names, components and tag keys.

# --- compiled-graph data plane (cgraph) and the LLM feed's channels -------
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
CGRAPH_EXECUTE_LATENCY = Histogram(
    "raytpu_cgraph_execute_latency_ms",
    "End-to-end latency of one compiled-graph iteration (execute to fetch)",
    component="cgraph",
    tag_keys=("graph",),
)
CGRAPH_EXECUTIONS = Counter(
    "raytpu_cgraph_executions_total",
    "Compiled-graph iterations driven, per graph",
    component="cgraph",
    tag_keys=("graph",),
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
DATA_OP_TASKS = Counter(
    "raytpu_data_op_tasks_total",
    "Data streaming-executor tasks submitted, by operator",
    component="data",
    tag_keys=("operator",),
)
DATA_OP_BLOCKS = Counter(
    "raytpu_data_op_blocks_total",
    "Data blocks completed, by operator",
    component="data",
    tag_keys=("operator",),
)
DATA_ROWS = Counter(
    "raytpu_data_rows_total",
    "Rows processed inside data transform tasks, by operator",
    component="data",
    tag_keys=("operator",),
)
DATA_OP_POOL_SIZE = Gauge(
    "raytpu_data_op_pool_size",
    "Live actors in an operator's autoscaling pool (executor v2)",
    component="data",
    tag_keys=("operator",),
)
DATA_OP_QUEUED_BYTES = Gauge(
    "raytpu_data_op_queued_bytes",
    "Object-store bytes queued at an operator's input (executor v2)",
    component="data",
    tag_keys=("operator",),
)
DATA_BACKPRESSURE = Counter(
    "raytpu_data_backpressure_total",
    "Times an operator was gated because its downstream exceeded its "
    "byte budget (one count per blocked->unblocked transition edge)",
    component="data",
    tag_keys=("operator",),
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
RL_ENV_STEPS = Counter(
    "raytpu_rl_env_steps_total",
    "Environment steps sampled by env runners",
    component="rl",
)
RL_SAMPLE_TIME = Histogram(
    "raytpu_rl_sample_time_ms",
    "EnvRunner.sample() wall time",
    component="rl",
    boundaries=[1, 5, 10, 50, 100, 500, 1000, 5000, 10000, 60000],
)
# --- recovery: `status`'s recovery line reads these --------------------------
ACTOR_RESTARTS = Counter(
    "raytpu_actor_restarts_total",
    "Actor restarts driven by the GCS restart state machine (max_restarts)",
    component="gcs",
)
TASKS_RETRIED = Counter(
    "raytpu_tasks_retried_total",
    "Task attempts re-queued after a worker died mid-execution",
    component="raylet",
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
NODES_FENCED = Counter(
    "raytpu_nodes_fenced_total",
    "Dead-marked nodes whose later RPCs were rejected with StaleNodeEpochError "
    "(zombies made to register again)",
    component="gcs",
)
# --- the raylet's scheduler and its control-plane batching (core/raylet.py) --
SCHED_QUEUE_DEPTH = Gauge(
    "raytpu_sched_queue_depth",
    "Task entries waiting in the raylet local scheduler",
    component="scheduler",
)
SCHED_DISPATCH_LATENCY = Histogram(
    "raytpu_sched_dispatch_latency_ms",
    "Queue-to-dispatch latency of raylet-scheduled entries",
    component="scheduler",
)
GCS_SYNC_TOTAL = Counter(
    "raytpu_raylet_gcs_sync_total",
    "Batched raylet->GCS location/task-event flushes",
    component="scheduler",
)
GCS_SYNC_BATCH = Histogram(
    "raytpu_raylet_gcs_sync_batch",
    "Records per raylet->GCS sync batch",
    component="scheduler",
    boundaries=[1, 2, 5, 10, 25, 50, 100, 250, 1000],
)
# --- object transport / shm store (core/{raylet,shm_store}.py) ---------------
STORE_PUTS = Counter(
    "raytpu_store_puts_total",
    "Objects written into the shm object store by this process",
    component="object_transport",
)
OBJECT_BYTES_IN = Counter(
    "raytpu_object_bytes_in_total",
    "Bytes pulled into this node's store from remote nodes",
    component="object_transport",
)
OBJECT_BYTES_OUT = Counter(
    "raytpu_object_bytes_out_total",
    "Bytes served from this node's store to remote nodes",
    component="object_transport",
)
OBJECT_SPILL_TOTAL = Counter(
    "raytpu_object_spill_total",
    "Objects spilled from the shm pool to disk",
    component="object_transport",
)
OBJECT_SPILL_BYTES = Counter(
    "raytpu_object_spill_bytes_total",
    "Bytes spilled from the shm pool to disk",
    component="object_transport",
)
OBJECT_RESTORE_TOTAL = Counter(
    "raytpu_object_restore_total",
    "Spilled objects restored into the shm pool",
    component="object_transport",
)
# --- worker pool and zygote (core/{raylet,worker_pool,zygote}.py) ----------
WORKER_POOL_IDLE = Gauge(
    "raytpu_worker_pool_idle",
    "Idle pooled workers on this node",
    component="worker_pool",
)
WORKER_POOL_BUSY = Gauge(
    "raytpu_worker_pool_busy",
    "Workers executing an entry on this node",
    component="worker_pool",
)
WORKER_POOL_LEASED = Gauge(
    "raytpu_worker_pool_leased",
    "Workers leased to owners for direct pushes",
    component="worker_pool",
)
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
# --- GCS: RPCs, pubsub and the error table (core/gcs.py) -------------------
GCS_RPC_TOTAL = Counter(
    "raytpu_gcs_rpc_total",
    "GCS RPCs served, by method",
    component="gcs",
    tag_keys=("method",),
)
GCS_RPC_LATENCY = Histogram(
    "raytpu_gcs_rpc_latency_ms",
    "GCS RPC handler latency, by method",
    component="gcs",
    tag_keys=("method",),
)
GCS_PUBSUB_BACKLOG = Gauge(
    "raytpu_gcs_pubsub_backlog",
    "Entries retained across GCS pubsub channel logs",
    component="gcs",
)
GCS_SHARD_LOCK_WAIT = Histogram(
    "raytpu_gcs_shard_lock_wait_ms",
    "Wait to acquire a GCS hot-table shard lock, by shard index: the "
    "contention left after key-hash partitioning (core/gcs_shards.py)",
    component="gcs",
    tag_keys=("shard",),
)
GCS_PUBSUB_DELTAS = Counter(
    "raytpu_pubsub_deltas_total",
    "Delta entries delivered to pubsub_poll2 subscribers, by channel",
    component="gcs",
    tag_keys=("channel",),
)
GCS_PUBSUB_RESYNCS = Counter(
    "raytpu_pubsub_resyncs_total",
    "Subscriber resyncs: gap responses (cursor fell behind the retention "
    "ring) plus snapshot serves, by channel",
    component="gcs",
    tag_keys=("channel",),
)
ERROR_REPORTS = Counter(
    "raytpu_error_reports_total",
    "Uncaught worker exceptions / crashes reported to the GCS error table",
    component="gcs",
)
# --- post-mortems and logs (observability/{postmortem,logs}.py) --------------
POSTMORTEM_TRIGGERS = Counter(
    "raytpu_postmortem_triggers_total",
    "Anomaly triggers received by the GCS trigger bus, by kind "
    "(coalesced and fresh alike)",
    component="gcs",
    tag_keys=("kind",),
)
POSTMORTEM_INCIDENTS = Counter(
    "raytpu_postmortem_incidents_total",
    "Incidents opened by the trigger bus (each runs one cluster-wide "
    "flight-ring harvest into a bundle)",
    component="gcs",
)
LOGS_EVICTED = Counter(
    "raytpu_logs_evicted_total",
    "Session log files evicted by the size-capped retention GC",
    component="raylet",
)
LOG_LINES_PUBLISHED = Counter(
    "raytpu_log_lines_published_total",
    "Captured worker output lines published on the logs pubsub channel",
    component="raylet",
)
# --- fast path (core/fastpath.py) --------------------------------------------
FASTPATH_RTT = Histogram(
    "raytpu_fastpath_rtt_ms",
    "Direct-push round trip: owner send to completion ack",
    component="fastpath",
)
# --- chaos ------------------------------------------------------------------
CHAOS_INJECTIONS = Counter(
    "raytpu_chaos_injections_total",
    "Faults injected by the chaos controller, by point and action",
    component="chaos",
    tag_keys=("point", "action"),
)
NET_PARTITIONS = Counter(
    "raytpu_net_partitions_total",
    "Network-partition specs installed in this process by chaos.partition",
    component="chaos",
)
NET_BLOCKED = Counter(
    "raytpu_net_blocked_total",
    "Control-plane sends and connects black-holed by an active chaos partition",
    component="chaos",
)
NODE_HEARTBEAT_LAG = Gauge(
    "raytpu_node_heartbeat_lag_s",
    "Seconds since each alive node's last raylet heartbeat (GCS-reported)",
    component="gcs",
    tag_keys=("node",),
)
# --- the lock-order detector (utils/lock_order.py) --------------------------
LOCK_ORDER_VIOLATIONS = Counter(
    "raytpu_lock_order_violations_total",
    "Lock-order hazards seen by the dynamic detector (RAY_TPU_LOCK_ORDER=1), "
    "by kind: cycle (AB/BA inversion), self (non-reentrant re-acquire), "
    "long_hold (critical section past the hold threshold)",
    component="runtime",
    tag_keys=("kind",),
)
# --- the per-node reporter (ReporterAgent below) -----------------------------
NODE_CPU_PERCENT = Gauge(
    "raytpu_node_cpu_percent",
    "Node-wide CPU utilization (from /proc/stat)",
    component="reporter",
)
NODE_MEM_USED = Gauge(
    "raytpu_node_mem_used_bytes",
    "Node memory in use (MemTotal - MemAvailable)",
    component="reporter",
)
PROC_RSS = Gauge(
    "raytpu_proc_rss_bytes",
    "Resident set size of the reporting daemon",
    component="reporter",
)
PROC_FD_COUNT = Gauge(
    "raytpu_proc_fd_count",
    "Open file descriptors of the reporting daemon",
    component="reporter",
)
DEVICE_MEM_USED = Gauge(
    "raytpu_device_mem_used_bytes",
    "CUDA memory allocated by the reporting process, by device "
    "(torch.cuda.memory_allocated; only where CUDA is already initialised)",
    component="reporter",
    tag_keys=("device",),
)


class ReporterAgent:
    """Per-node system-stats collector (reference:
    dashboard/modules/reporter/reporter_agent.py:336; the JAX package's
    ReporterAgent): /proc reads into the reporter gauges every `interval_s`,
    flushed by the process's flusher.
    Every read is best-effort: a missing /proc degrades to no gauge."""

    def __init__(self, interval_s: float = 1.0):
        self.interval_s = interval_s
        self._prev_cpu: Optional[Tuple[float, float]] = None  # (busy, total)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        if not _enabled or self._thread is not None:
            return
        self._thread = threading.Thread(target=self._loop, daemon=True, name="reporter-agent")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.collect_once()
            except Exception:  # lint: swallow-ok(one bad sample round; reporter retries next tick)
                pass

    def collect_once(self) -> None:
        cpu = self._cpu_percent()
        if cpu is not None:
            NODE_CPU_PERCENT.set(cpu)
        mem = self._node_mem_used()
        if mem is not None:
            NODE_MEM_USED.set(mem)
        rss = self._proc_rss()
        if rss is not None:
            PROC_RSS.set(rss)
        try:
            PROC_FD_COUNT.set(len(os.listdir("/proc/self/fd")))
        except OSError:
            pass
        for dev, used in self._device_mem():
            DEVICE_MEM_USED.set(used, device=dev)

    def _cpu_percent(self) -> Optional[float]:
        try:
            with open("/proc/stat") as f:
                vals = [float(v) for v in f.readline().split()[1:]]
        except (OSError, ValueError, IndexError):
            return None
        total = sum(vals)
        idle = vals[3] + (vals[4] if len(vals) > 4 else 0.0)  # idle + iowait
        busy = total - idle
        prev, self._prev_cpu = self._prev_cpu, (busy, total)
        if prev is None or total <= prev[1]:
            return None
        return 100.0 * (busy - prev[0]) / (total - prev[1])

    @staticmethod
    def _node_mem_used() -> Optional[float]:
        try:
            fields = {}
            with open("/proc/meminfo") as f:
                for line in f:
                    k, _, rest = line.partition(":")
                    fields[k] = float(rest.split()[0]) * 1024
            return fields["MemTotal"] - fields["MemAvailable"]
        except (OSError, KeyError, ValueError, IndexError):
            return None

    @staticmethod
    def _proc_rss() -> Optional[float]:
        try:
            with open("/proc/self/statm") as f:
                return float(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
        except (OSError, ValueError, IndexError):
            return None

    @staticmethod
    def _device_mem() -> List[Tuple[str, float]]:
        """(device index, torch.cuda.memory_allocated) for each device this
        process sees -- only when torch is already imported and CUDA already
        initialised here: asking any earlier would import torch into a
        daemon, or create a CUDA context in a process that has none."""
        import sys

        torch = sys.modules.get("torch")
        if torch is None:
            return []
        try:
            if not torch.cuda.is_initialized():
                return []
            return [(str(i), float(torch.cuda.memory_allocated(i)))
                    for i in range(torch.cuda.device_count())]
        except Exception:  # noqa: BLE001 - a broken CUDA runtime reports nothing
            return []
