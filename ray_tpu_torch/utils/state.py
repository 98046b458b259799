"""Cluster state API: live views of nodes, actors, tasks, objects, metrics
and errors (the port of ray_tpu/utils/state.py).

The analogue of the reference's state API (reference:
python/ray/util/state/api.py list_nodes/list_actors/list_tasks/list_objects
+ summarize_*). Queries go to the GCS tables that the raylets feed with
batched events and heartbeats; none touches a device.

    from ray_tpu_torch.utils import state
    state.list_tasks()          # the task table: states, nodes, history
    state.list_actors()         # with num_restarts
    state.cluster_stats()       # aggregate counters
    state.log_dir()             # per-process session logs
    state.cluster_logs(actor_id=...)   # structured records, every node
    state.list_incidents()      # the GCS trigger bus's incidents
    state.metrics_history("raytpu_cgraph_executions_total", as_rate=True)
    state.active_alerts()       # firing SLO watchdog rules
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional

from ..core import runtime_base


def _gcs():
    rt = runtime_base.current_runtime()
    gcs = getattr(rt, "_gcs", None)
    if gcs is None:
        raise RuntimeError("the state API requires cluster mode (ray_tpu_torch.init())")
    return gcs


def list_nodes(limit: Optional[int] = None) -> List[Dict[str, Any]]:
    """Nodes with liveness, resources, store stats, `Epoch` and `State`
    (ALIVE / DRAINING / DEAD). `limit` bounds the reply, in node-id order."""
    return _gcs().call("list_nodes", limit)


def node_summary() -> Dict[str, Any]:
    """Membership counts by state and summed capacity and availability."""
    return _gcs().call("node_summary")


def list_actors(limit: int = 1000) -> List[Dict[str, Any]]:
    """Actor table: state, placement, restart counts, death reasons."""
    return _gcs().call("list_actors", limit)


def list_tasks(limit: int = 1000) -> List[Dict[str, Any]]:
    """Recent task states (QUEUED/RUNNING/FINISHED/FAILED), each with its
    node, name, retries and `history` of (state, ts, node)."""
    return _gcs().call("list_tasks", limit)


def list_objects(limit: int = 1000) -> List[Dict[str, Any]]:
    """Object directory: locations, borrows, pending frees."""
    return _gcs().call("list_objects", limit)


def list_placement_groups() -> Dict[str, Dict[str, Any]]:
    return _gcs().call("placement_group_table")


def cluster_stats() -> Dict[str, Any]:
    """Aggregate counters: tasks by state, actors by state, store usage."""
    return _gcs().call("stats")


def user_metrics() -> List[Dict[str, Any]]:
    """Cluster-aggregated application metrics defined with
    ray_tpu_torch.utils.metrics Counter/Gauge/Histogram."""
    return _gcs().call("user_metrics")


def internal_metrics() -> List[Dict[str, Any]]:
    """Cluster-aggregated runtime metrics (the `raytpu_*` catalog of
    ray_tpu_torch.utils.internal_metrics), flushed by the GCS, raylets,
    workers and drivers. Every record carries `component` and `node_id`
    tags."""
    return _gcs().call("internal_metrics")


def metrics_history(name: Optional[str] = None, tags: Optional[Dict[str, str]] = None,
                    window_s: Optional[float] = None,
                    as_rate: bool = False) -> List[Dict[str, Any]]:
    """Time series of the internal metrics: matching series with `samples`
    lists of [ts, value] ([ts, count, sum] for histograms), fine-resolution
    recent samples plus coarse rollups of older ones
    (observability/history.py). `tags` is a subset filter; `as_rate` turns
    cumulative series into per-second rates, so

        state.metrics_history("raytpu_store_puts_total", window_s=60, as_rate=True)

    is puts/s over the last minute per (component, node) series. Empty when
    retention is off (RAY_TPU_METRICS_HISTORY=0)."""
    return _gcs().call("metrics_history", name, tags, window_s, as_rate)


def active_alerts() -> List[Dict[str, Any]]:
    """Firing SLO watchdog alerts (observability/watchdog.py): rule, metric,
    the observed value against its threshold, firing since. Transitions are
    also published on the `node_events` pubsub channel and flight-recorded."""
    return _gcs().call("active_alerts")


def list_incidents() -> List[Dict[str, Any]]:
    """Incidents opened by the GCS anomaly trigger bus
    (observability/postmortem.py): id, state (open / harvesting / staged /
    failed), the first trigger's kind, the coalesced-trigger count, and the
    staged bundle's path once the harvest lands."""
    return _gcs().call("list_incidents")


def get_incident(incident_id: str) -> Optional[Dict[str, Any]]:
    """One incident's full record, its trigger chain included."""
    return _gcs().call("get_incident", incident_id)


def cluster_errors(limit: int = 100) -> List[Dict[str, Any]]:
    """Recent cluster error reports: uncaught task exceptions reported by
    workers and worker crashes reported by raylets, each with node, worker,
    task and actor, and for a crash the dying process's output tail. Also
    published live on the `error_reports` pubsub channel."""
    return _gcs().call("cluster_errors", limit)


def cluster_logs(node: Optional[str] = None, tail: Optional[int] = 1000,
                 **filters: Any) -> List[Dict[str, Any]]:
    """Cluster-wide structured log query: the raylets' `tail_logs` on every
    alive node, merged by timestamp. Filters: component, level (minimum),
    task_id / actor_id / trace_id / worker_id (prefix match), grep
    (substring), since_ts."""
    from ..observability import logs as _logs

    return _logs.query_cluster(_gcs(), node=node, tail=tail, **filters)


def get_task(task_id: str) -> Optional[Dict[str, Any]]:
    return _gcs().call("get_task_states", [task_id]).get(task_id)


def task_timeline_events() -> List[Dict[str, Any]]:
    """Chrome-trace duration events from the GCS task table (RUNNING ->
    FINISHED/FAILED transitions), one `node:<id>` track per node."""
    events: List[Dict[str, Any]] = []
    for rec in list_tasks(limit=100_000):
        start = None
        for st, ts, node in rec.get("history") or []:
            if st == "RUNNING":
                start = (ts, node)
            elif st in ("FINISHED", "FAILED") and start is not None:
                t0, node0 = start
                events.append({
                    "name": rec.get("name") or rec["task_id"][:8], "cat": "task", "ph": "X",
                    "ts": t0 * 1e6, "dur": max(0.0, (ts - t0) * 1e6),
                    "pid": f"node:{node0[:8]}", "tid": rec["task_id"][:8],
                    "args": {"state": st, "task_id": rec["task_id"]}})
                start = None
    return events


def timeline(path: Optional[str] = None) -> List[Dict[str, Any]]:
    """Chrome-trace (Perfetto / chrome://tracing) export of task execution
    spans from the task table (reference: `ray timeline`), with every
    collected trace span merged in (tracing.collect: submit and execute,
    the actor-launch phases, Serve's request and replica spans; a span that
    never closed lands on an "open at dump" track), stable-sorted by start;
    writes JSON when `path` is given."""
    from .. import tracing
    from ..observability import perfetto

    events = task_timeline_events()
    events += perfetto.span_events(tracing.collect(), dump_us=int(time.time() * 1e6))
    events.sort(key=lambda e: e.get("ts", 0))  # stable: ties keep order
    if path:
        with open(path, "w") as f:
            json.dump(events, f, default=repr)
    return events


def log_dir() -> Optional[str]:
    """The session's log directory (gcs/raylet/worker stdout+stderr)."""
    rt = runtime_base.current_runtime()
    cluster = getattr(rt, "_cluster", None)
    session = getattr(cluster, "session_dir", None)
    if session is None:
        # A worker (or a driver attached by sockets): the raylet socket's dir.
        raylet = getattr(rt, "_raylet", None)
        if raylet is None:
            return None
        session = os.path.dirname(raylet.path)
    return os.path.join(session, "logs")


def read_worker_logs() -> Dict[str, str]:
    """All captured worker output, keyed by log file name."""
    d = log_dir()
    out: Dict[str, str] = {}
    if d and os.path.isdir(d):
        for fname in sorted(os.listdir(d)):
            if fname.startswith("worker_"):
                try:
                    with open(os.path.join(d, fname)) as f:
                        data = f.read()
                except OSError:
                    continue
                if data:
                    out[fname] = data
    return out
