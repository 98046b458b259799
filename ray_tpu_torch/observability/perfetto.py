"""Perfetto/chrome-trace exporter: one timeline for the whole cluster (the
port of ray_tpu/observability/perfetto.py).

Merges every process's tracing spans (tracing.collect), flight-recorder
dumps, task events, structured log records and internal-metrics counters
into a single chrome-trace JSON (the format Perfetto, chrome://tracing and
`ui.perfetto.dev` load; reference: `ray timeline`'s chrome_tracing_dump,
here with cross-process flow arrows). postmortem.merge_trace builds an
incident bundle's trace through `build_trace`.

Layout:
- one trace *process* per OS process (pid from the span), named via
  metadata events; node-scoped rows keep their `node:<id>` tracks;
- spans with both timestamps render as `X` duration events on their
  thread's track;
- spans that never closed (crash, hang, killed worker: reconstructed from
  flight-recorder `span_open` events without a matching close, or any span
  record missing `end_us`) land on a dedicated **"open at dump"** track
  running to the dump timestamp;
- flow arrows: submit->schedule->execute edges stitch via the `flow_out` /
  `flow_step` / `flow_in` span attrs minted by tracing.inject_context,
  rendered as chrome flow events (`ph: s/t/f`, one chain per flow id);
- flight-recorder events render as instants (`ph: i`) on a per-process
  "flight" track; internal-metrics counters become counter tracks
  (`ph: C`) sampled at export time.

Pure Python: no torch, no device.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Tuple

OPEN_TRACK = "open at dump"


def _span_track(sp: dict) -> Tuple[Any, Any]:
    return sp.get("pid", 0), sp.get("tid", 0)


def span_events(spans: List[dict], dump_us: Optional[int] = None) -> List[dict]:
    """Duration events for closed spans; open-at-dump entries otherwise."""
    events: List[dict] = []
    for sp in spans:
        start = sp.get("start_us")
        if start is None:
            continue
        pid, tid = _span_track(sp)
        args = {
            "span_id": sp.get("span_id"),
            "parent_id": sp.get("parent_id"),
            "trace_id": sp.get("trace_id"),
            **(sp.get("attrs") or {}),
        }
        end = sp.get("end_us")
        if end is None:
            # Never closed: visible on its own track, stretched to the
            # dump moment so the hang's extent is readable.
            events.append(
                {
                    "name": sp.get("name", "span"),
                    "cat": "span,open",
                    "ph": "X",
                    "ts": start,
                    "dur": max(1, (dump_us or start) - start),
                    "pid": pid,
                    "tid": OPEN_TRACK,
                    "args": {**args, "open_at_dump": True},
                }
            )
            continue
        events.append(
            {
                "name": sp.get("name", "span"),
                "cat": "span",
                "ph": "X",
                "ts": start,
                "dur": max(0, end - start),
                "pid": pid,
                "tid": tid,
                "args": args,
            }
        )
    return events


def flow_events(spans: List[dict]) -> List[dict]:
    """Chrome flow chains (`s` -> `t`* -> `f`) from the flow_out /
    flow_step / flow_in span attributes, one chain per flow id ordered by
    span start time. Emitted only for ids with >= 2 endpoints — a dangling
    tail (executor died before its span) must not break the import."""
    roles = ("flow_out", "flow_step", "flow_in")
    chains: Dict[str, List[Tuple[int, int, dict]]] = {}
    for sp in spans:
        attrs = sp.get("attrs") or {}
        start = sp.get("start_us")
        if start is None:
            continue
        for role, key in enumerate(roles):
            fid = attrs.get(key)
            if fid:
                # Anchor the arrow where causality happens: tails leave a
                # span's END (submit completed), heads arrive at its START.
                ts = sp.get("end_us", start) if key == "flow_out" else start
                chains.setdefault(str(fid), []).append((role, ts, sp))
    events: List[dict] = []
    for fid, points in chains.items():
        if len(points) < 2:
            continue
        # Order by ROLE (out -> step -> in), ts only as tiebreak: a
        # consumer's span routinely OPENS before the producer's span ends
        # (an exec-loop iteration blocks in its read before the driver's
        # execute span even starts), and a ts-only sort would draw the
        # causality arrow backwards.
        points.sort(key=lambda p: (p[0], p[1]))
        for i, (_role, ts, sp) in enumerate(points):
            ph = "s" if i == 0 else ("f" if i == len(points) - 1 else "t")
            pid, tid = _span_track(sp)
            ev = {
                "name": "flow",
                "cat": "flow",
                "ph": ph,
                "id": fid,
                "ts": ts,
                "pid": pid,
                "tid": tid,
            }
            if ph == "f":
                ev["bp"] = "e"  # bind to the enclosing slice
            events.append(ev)
    return events


def flight_events(dumps: List[dict]) -> List[dict]:
    """Instants from flight-recorder dumps, plus open-at-dump spans
    reconstructed from unmatched span_open events."""
    events: List[dict] = []
    for dump in dumps:
        pid = dump.get("pid", 0)
        dump_us = dump.get("dump_us")
        # Keyed by the recorded (name, tid) detail, with a STACK of open
        # timestamps per key: two threads (or nested spans) both inside a
        # same-named span must not collapse to one entry — the collision
        # would drop exactly the blocked span a hang dump exists to show.
        open_spans: Dict[str, List[tuple]] = {}
        for ev in dump.get("events", ()):
            try:
                ts, kind, detail = ev[0], ev[1], ev[2] if len(ev) > 2 else None
            except (TypeError, IndexError):
                continue
            if kind == "span_open":
                # Detail is (name, tid) for tracing spans; bare values from
                # other recorders display as-is.
                name = (
                    str(detail[0])
                    if isinstance(detail, (list, tuple)) and detail
                    else str(detail)
                )
                open_spans.setdefault(str(detail), []).append((ts, name))
                continue
            if kind == "span_close":
                stack = open_spans.get(str(detail))
                if stack:
                    stack.pop()
                continue
            events.append(
                {
                    "name": str(kind),
                    "cat": "flight",
                    "ph": "i",
                    "s": "t",
                    "ts": ts,
                    "pid": pid,
                    "tid": "flight",
                    "args": {"detail": repr(detail), "reason": dump.get("reason", "")},
                }
            )
        for stack in open_spans.values():
            for ts, name in stack:
                events.append(
                    {
                        "name": name,
                        "cat": "span,open",
                        "ph": "X",
                        "ts": ts,
                        "dur": max(1, (dump_us or ts) - ts),
                        "pid": pid,
                        "tid": OPEN_TRACK,
                        "args": {"open_at_dump": True, "reason": dump.get("reason", "")},
                    }
                )
    return events


def profile_dir() -> str:
    """Where the sampling profiler's structured dumps land (its
    `profile_dir`: RAY_TPU_SAMPLING_PROFILE, else <trace_dir>/profile)."""
    from ..utils.sampling_profiler import profile_dir as _profile_dir

    return _profile_dir()


def collect_profiles(directory: Optional[str] = None) -> List[dict]:
    """Sampling-profiler dumps (JSON, `profile_<...>.json`): every
    process's, tolerating partial/corrupt files like the other
    collectors."""
    import os

    if directory is None:
        directory = profile_dir()
    out: List[dict] = []
    try:
        names = sorted(os.listdir(directory))
    except OSError:
        return out
    for fname in names:
        if not (fname.startswith("profile_") and fname.endswith(".json")):
            continue
        try:
            with open(os.path.join(directory, fname), errors="replace") as f:
                payload = json.load(f)
        except (OSError, ValueError):
            continue
        if isinstance(payload, dict) and isinstance(payload.get("stacks"), list):
            out.append(payload)
    return out


def profile_events(profiles: List[dict], top_n: int = 25) -> List[dict]:
    """Hottest-stack instants from sampling-profiler dumps: one `i`
    event per top stack on the process's "profiler" track at dump time,
    with the sample count and share in args — the aggregated profile is
    not a timeline, but landing it on the same view answers "what was
    this daemon DOING" next to the spans that were slow."""
    events: List[dict] = []
    for prof in profiles:
        pid = prof.get("pid", 0)
        dump_us = prof.get("dump_us", 0)
        total = max(1, int(prof.get("samples") or 1))
        for entry in (prof.get("stacks") or [])[:top_n]:
            try:
                count, stack = int(entry[0]), str(entry[1])
            except (TypeError, ValueError, IndexError):
                continue
            top_frame = stack.split(" < ", 1)[0]
            events.append(
                {
                    "name": f"{top_frame} ({count})",
                    "cat": "profile",
                    "ph": "i",
                    "s": "t",
                    "ts": dump_us,
                    "pid": pid,
                    "tid": "profiler",
                    "args": {
                        "stack": stack,
                        "count": count,
                        "share": round(count / total, 4),
                        "profile": prof.get("name", ""),
                    },
                }
            )
    return events


def log_events(records: List[dict]) -> List[dict]:
    """Structured log records (observability/logs.py) as instants on a
    per-process "log" track. A record carrying a trace_id lands on the
    SAME pid track as that request's spans (both key on the emitting
    process), so one trace shows metrics, spans, flight events,
    and log lines on one timeline — the log instant sits visually inside
    the span that emitted it."""
    events: List[dict] = []
    for rec in records:
        ts = rec.get("ts")
        if not isinstance(ts, (int, float)):
            continue
        msg = str(rec.get("msg", ""))
        events.append(
            {
                "name": f"[{rec.get('level', '?')}] {msg[:80]}",
                "cat": "log",
                "ph": "i",
                "s": "t",
                "ts": int(ts * 1e6),
                "pid": rec.get("pid", 0),
                "tid": "log",
                "args": {
                    "msg": msg,
                    "component": rec.get("component"),
                    "level": rec.get("level"),
                    "node_id": rec.get("node_id"),
                    "worker_id": rec.get("worker_id"),
                    "task_id": rec.get("task_id"),
                    "actor_id": rec.get("actor_id"),
                    "trace_id": rec.get("trace_id"),
                },
            }
        )
    return events


def counter_events(metrics: List[dict], ts_us: int) -> List[dict]:
    """Counter tracks sampled at export time (the internal-metrics table
    holds current aggregates, not history — one sample per series)."""
    events: List[dict] = []
    for m in metrics:
        if m.get("kind") not in ("counter", "gauge"):
            continue
        tags = m.get("tags") or {}
        label = ",".join(
            f"{k}={v}" for k, v in sorted(tags.items()) if k != "node_id"
        )
        name = m.get("name", "?") + (f"{{{label}}}" if label else "")
        events.append(
            {
                "name": name,
                "cat": "metrics",
                "ph": "C",
                "ts": ts_us,
                "pid": f"node:{str(tags.get('node_id', ''))[:8]}",
                "args": {"value": m.get("value", 0.0)},
            }
        )
    return events


def metadata_events(events: List[dict]) -> List[dict]:
    """process_name metadata so numeric pids read as processes."""
    seen = set()
    out: List[dict] = []
    for ev in events:
        pid = ev.get("pid")
        if pid in seen:
            continue
        seen.add(pid)
        name = f"proc {pid}" if isinstance(pid, int) else str(pid)
        out.append(
            {
                "name": "process_name",
                "ph": "M",
                "pid": pid,
                "tid": 0,
                "args": {"name": name},
            }
        )
    return out


def build_trace(
    spans: Optional[List[dict]] = None,
    dumps: Optional[List[dict]] = None,
    task_events: Optional[List[dict]] = None,
    metrics: Optional[List[dict]] = None,
    profiles: Optional[List[dict]] = None,
    log_records: Optional[List[dict]] = None,
) -> dict:
    """Assembles the full chrome-trace object. Events are stable-sorted
    by timestamp (metadata first — required by some importers)."""
    import time

    now_us = int(time.time() * 1e6)
    events: List[dict] = []
    events += span_events(spans or [], dump_us=now_us)
    events += flow_events(spans or [])
    events += flight_events(dumps or [])
    events += profile_events(profiles or [])
    events += log_events(log_records or [])
    events += list(task_events or [])
    if metrics:
        events += counter_events(metrics, now_us)
    meta = metadata_events(events)
    events.sort(key=lambda e: e.get("ts", 0))
    return {"traceEvents": meta + events, "displayTimeUnit": "ms"}


def export(
    path: Optional[str] = None,
    trace_directory: Optional[str] = None,
    task_events: Optional[List[dict]] = None,
    metrics: Optional[List[dict]] = None,
    log_records: Optional[List[dict]] = None,
) -> dict:
    """Collects everything reachable from this process and builds (and
    optionally writes) the trace. Returns {"trace": ..., "summary": ...}."""
    from .. import tracing
    from . import flight_recorder

    spans = tracing.collect(trace_directory)
    dumps = flight_recorder.collect()
    profiles = collect_profiles()
    trace = build_trace(
        spans=spans,
        dumps=dumps,
        task_events=task_events,
        metrics=metrics,
        profiles=profiles,
        log_records=log_records,
    )
    if path:
        with open(path, "w") as f:
            json.dump(trace, f, default=repr)
    n_flows = sum(1 for e in trace["traceEvents"] if e.get("ph") == "s")
    summary = {
        "events": len(trace["traceEvents"]),
        "spans": len(spans),
        "flows": n_flows,
        "flight_dumps": len(dumps),
        "profiles": len(profiles),
        "log_records": len(log_records or []),
        "task_events": len(task_events or []),
    }
    return {"trace": trace, "summary": summary}
