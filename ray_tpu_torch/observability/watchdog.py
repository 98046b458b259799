"""SLO watchdogs: rules over the metrics-history stream that act (the port
of ray_tpu/observability/watchdog.py).

The reactive half of the observability layer: a small rules engine that
runs inside the GCS (it owns the history table and the `node_events` pubsub
channel) and turns bad signals into events instead of waiting for a person
to read the metrics at the right moment.

Rule kinds:

- **threshold**: compare a statistic of a series over a window against a
  bound. `stat` picks the statistic: `value` (newest sample), `rate`
  (per-second delta across the window, cumulative series), `mean`
  (histogram dsum/dcount over the window), or `p50`/`p90`/`p99` (histogram
  percentile from windowed bucket-count deltas).
- **absence**: fire when a series that exists has produced no sample
  within the window (a raylet that stopped heartbeating, a flusher that
  died). A series that never existed does not fire.

On a firing transition the watchdog publishes
``{"event": "slo_alert", "rule", "state": "firing", "value", ...}`` on the
`node_events` pubsub channel (the feed supervisors already watch for
drains), records it in the flight ring, raises a `watchdog.alert` trigger
on the incident bus (observability/postmortem.py), and writes a flight
dump, at most one per `_DUMP_MIN_INTERVAL_S`, so the context around the
breach is on disk before anyone asks. Clearing publishes the matching
``"cleared"`` event. Firing alerts are read with `utils/state.py`'s
`active_alerts()`, the dashboard's `/api/alerts` and the CLI's `status` and
`top`.

Config: RAY_TPU_WATCHDOG=0 disarms; RAY_TPU_WATCHDOG_RULES takes a JSON list
of rule dicts that REPLACES the defaults (include ``{"defaults": true}`` as
a list entry to extend them instead). Standard library only.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from .flight_recorder import record as _flight_record

_STATS = ("value", "rate", "mean", "p50", "p90", "p99")
_KINDS = ("threshold", "absence")
# A firing rule re-dumps at most this often: alert storms must not churn
# the flight dir.
_DUMP_MIN_INTERVAL_S = 30.0


def watchdog_enabled() -> bool:
    return os.environ.get("RAY_TPU_WATCHDOG", "1") != "0"


@dataclasses.dataclass
class Rule:
    name: str
    metric: str
    kind: str = "threshold"
    stat: str = "value"
    op: str = ">"
    threshold: float = 0.0
    window_s: float = 30.0
    for_s: float = 0.0
    tags: Optional[Dict[str, str]] = None
    description: str = ""

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"rule {self.name!r}: unknown kind {self.kind!r}")
        if self.stat not in _STATS:
            raise ValueError(f"rule {self.name!r}: unknown stat {self.stat!r}")
        if self.op not in (">", "<"):
            raise ValueError(f"rule {self.name!r}: op must be '>' or '<'")
        if self.window_s <= 0:
            raise ValueError(f"rule {self.name!r}: window_s must be positive")

    def breaches(self, value: float) -> bool:
        return value > self.threshold if self.op == ">" else value < self.threshold


# The shipped rule set: each names a signal this repo already emits and a
# bound that means "a person should look". README documents them.
DEFAULT_RULES: List[Dict[str, Any]] = [
    {
        "name": "heartbeat_lag",
        "metric": "raytpu_node_heartbeat_lag_s",
        "stat": "value",
        "op": ">",
        "threshold": 3.0,
        "window_s": 15.0,
        "description": "a raylet's heartbeat is stalling (node death imminent)",
    },
    {
        "name": "cgraph_execute_p99",
        "metric": "raytpu_cgraph_execute_latency_ms",
        "stat": "p99",
        "op": ">",
        "threshold": 1000.0,
        "window_s": 30.0,
        "for_s": 2.0,
        "description": "compiled-graph iterations are stalling",
    },
    {
        "name": "goodput_floor",
        "metric": "raytpu_train_goodput",
        "stat": "value",
        "op": "<",
        "threshold": 0.5,
        "window_s": 120.0,
        "for_s": 5.0,
        "description": "less than half of training wall time is productive",
    },
    {
        "name": "serve_ttft_p99",
        "metric": "raytpu_serve_ttft_ms",
        "stat": "p99",
        "op": ">",
        "threshold": 2000.0,
        "window_s": 30.0,
        "for_s": 2.0,
        "description": "serve time-to-first-token p99 over its SLO",
    },
    {
        # A burst of backpressure edges is normal (that's the mechanism
        # working); a SUSTAINED rate means an operator's byte budget is
        # chronically undersized for the pipeline's skew and the source
        # is spending its life gated instead of reading.
        "name": "data_backpressure",
        "metric": "raytpu_data_backpressure_total",
        "stat": "rate",
        "op": ">",
        "threshold": 5.0,
        "window_s": 30.0,
        "for_s": 5.0,
        "description": "data pipeline persistently backpressured: an operator budget is undersized",
    },
    {
        # KV-pool exhaustion is observable as its symptom: the LLM
        # engine rejecting admissions with backpressure. A sustained
        # shed rate means the page pool is undersized for the offered
        # load (or a prefix-cache regression is burning pages).
        "name": "kv_pool_exhausted",
        "metric": "raytpu_serve_requests_shed_total",
        "stat": "rate",
        "op": ">",
        "threshold": 0.5,
        "window_s": 30.0,
        "for_s": 2.0,
        "description": "LLM engine shedding requests: KV page pool exhausted at offered load",
    },
]


def rules_from_env() -> List[Rule]:
    raw = os.environ.get("RAY_TPU_WATCHDOG_RULES")
    specs: List[Dict[str, Any]] = []
    if raw:
        parsed = json.loads(raw)  # a broken rule set must fail LOUDLY
        if not isinstance(parsed, list):
            raise ValueError("RAY_TPU_WATCHDOG_RULES must be a JSON list")
        for entry in parsed:
            if isinstance(entry, dict) and entry.get("defaults"):
                specs.extend(DEFAULT_RULES)
            else:
                specs.append(entry)
    else:
        specs = list(DEFAULT_RULES)
    return [Rule(**spec) for spec in specs]


def percentile_from_buckets(
    boundaries: List[float], counts: List[int], q: float
) -> Optional[float]:
    """Prometheus-style upper-bound estimate: the first boundary whose
    cumulative count reaches q * total (the overflow bucket reports the
    last finite boundary — there is no upper edge to interpolate to)."""
    total = sum(counts)
    if total <= 0:
        return None
    target = q * total
    cum = 0
    for i, c in enumerate(counts):
        cum += c
        if cum >= target:
            return boundaries[i] if i < len(boundaries) else (
                boundaries[-1] if boundaries else None
            )
    return boundaries[-1] if boundaries else None


class Watchdog:
    """Evaluates rules on an interval. `history` is a
    history.MetricsHistory; `publish` sends one alert-event dict to the
    node_events channel; `metrics_fn` returns the current internal-
    metrics table view (for percentile rules, which need bucket counts);
    `dump_fn` writes a flight dump and returns its path."""

    def __init__(
        self,
        history,
        publish: Callable[[Dict[str, Any]], Any],
        rules: Optional[List[Rule]] = None,
        metrics_fn: Optional[Callable[[], List[dict]]] = None,
        dump_fn: Optional[Callable[..., Optional[str]]] = None,
        interval_s: float = 1.0,
    ):
        self._history = history
        self._publish = publish
        self.rules = list(rules if rules is not None else rules_from_env())
        self._metrics_fn = metrics_fn
        if dump_fn is None:
            from . import flight_recorder

            dump_fn = flight_recorder.dump
        self._dump_fn = dump_fn
        self.interval_s = interval_s
        self._lock = threading.Lock()
        # rule name -> {"since", "value", "pending_since"}
        self._firing: Dict[str, Dict[str, Any]] = {}
        self._pending: Dict[str, float] = {}
        # rule name -> [(ts, {series_key: (boundaries, counts)})]
        self._bucket_snaps: Dict[str, List[Tuple[float, Dict]]] = {}
        self._last_dump = 0.0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ----------------------------------------------------------- control
    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="slo-watchdog"
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.poll_once()
            # lint: swallow-ok(one bad tick must not kill the watchdog; poll_once logs per rule)
            except Exception:
                pass

    # -------------------------------------------------------- evaluation
    def _snapshot_buckets(self, rule: Rule, now: float) -> None:
        if self._metrics_fn is None:
            return
        snap: Dict[Any, Tuple[List[float], List[int]]] = {}
        for m in self._metrics_fn():
            if m.get("name") != rule.metric or m.get("kind") != "histogram":
                continue
            tags = m.get("tags") or {}
            if rule.tags and any(
                tags.get(k) != str(v) for k, v in rule.tags.items()
            ):
                continue
            key = tuple(sorted(tags.items()))
            snap[key] = (
                list(m.get("boundaries") or []),
                list(m.get("counts") or []),
            )
        snaps = self._bucket_snaps.setdefault(rule.name, [])
        snaps.append((now, snap))
        horizon = now - 2 * rule.window_s - 5.0
        while snaps and snaps[0][0] < horizon:
            snaps.pop(0)

    def _percentile_value(self, rule: Rule, now: float) -> Optional[float]:
        self._snapshot_buckets(rule, now)
        snaps = self._bucket_snaps.get(rule.name) or []
        if len(snaps) < 2:
            return None
        _, current = snaps[-1]
        # Baseline: the oldest snapshot still inside the window.
        base = None
        for ts, snap in snaps:
            if ts >= now - rule.window_s:
                base = snap
                break
        if base is None:
            base = snaps[0][1]
        q = {"p50": 0.5, "p90": 0.9, "p99": 0.99}[rule.stat]
        worst: Optional[float] = None
        for key, (boundaries, counts) in current.items():
            prev_counts = (base.get(key) or ([], []))[1]
            if len(prev_counts) == len(counts):
                counts = [c - p for c, p in zip(counts, prev_counts)]
            p = percentile_from_buckets(boundaries, counts, q)
            if p is None:
                continue
            if worst is None or (p > worst) == (rule.op == ">"):
                worst = p
        return worst

    def _evaluate(self, rule: Rule, now: float) -> Tuple[Optional[float], bool]:
        """(worst observed value or None, breached?)"""
        if rule.kind == "absence":
            newest: Optional[float] = None
            for series in self._history.query(rule.metric, rule.tags, now=now):
                if series["samples"]:
                    ts = series["samples"][-1][0]
                    newest = ts if newest is None else max(newest, ts)
            if newest is None:
                return None, False  # never existed: nothing to miss
            lag = now - newest
            return lag, lag > rule.window_s
        if rule.stat in ("p50", "p90", "p99"):
            value = self._percentile_value(rule, now)
            return value, value is not None and rule.breaches(value)
        worst: Optional[float] = None
        if rule.stat == "value":
            for _tags, sample in self._history.latest(
                rule.metric, rule.tags, rule.window_s, now=now
            ):
                v = sample[1]
                if worst is None or (v > worst) == (rule.op == ">"):
                    worst = v
        else:  # rate / mean: deltas across the window per series
            for series in self._history.query(
                rule.metric, rule.tags, rule.window_s, now=now
            ):
                samples = series["samples"]
                if len(samples) < 2:
                    continue
                first, last = samples[0], samples[-1]
                dt = last[0] - first[0]
                if dt <= 0:
                    continue
                if rule.stat == "rate":
                    v = (last[1] - first[1]) / dt
                else:  # mean: histogram [ts, count, sum]
                    if len(last) < 3 or len(first) < 3:
                        continue
                    dcount = last[1] - first[1]
                    if dcount <= 0:
                        continue
                    v = (last[2] - first[2]) / dcount
                if worst is None or (v > worst) == (rule.op == ">"):
                    worst = v
        return worst, worst is not None and rule.breaches(worst)

    def poll_once(self, now: Optional[float] = None) -> List[Dict[str, Any]]:
        """One evaluation pass; returns the alert events it published
        (tests drive this directly instead of the thread)."""
        now = time.time() if now is None else now
        published: List[Dict[str, Any]] = []
        for rule in self.rules:
            try:
                value, breached = self._evaluate(rule, now)
            except Exception:
                continue  # lint: swallow-ok(malformed rule/missing series; rule skipped this round)
            with self._lock:
                firing = rule.name in self._firing
                if breached and not firing:
                    pending_since = self._pending.setdefault(rule.name, now)
                    if now - pending_since < rule.for_s:
                        continue
                    self._pending.pop(rule.name, None)
                    self._firing[rule.name] = {
                        "since": now,
                        "value": value,
                    }
                    event = self._alert_event(rule, "firing", value, now)
                elif breached and firing:
                    self._firing[rule.name]["value"] = value
                    continue
                elif not breached and firing:
                    del self._firing[rule.name]
                    event = self._alert_event(rule, "cleared", value, now)
                else:
                    self._pending.pop(rule.name, None)
                    continue
            _flight_record("watchdog.alert", (rule.name, event["state"], value))
            if event["state"] == "firing":
                # Anomaly trigger: a firing SLO rule opens (or joins) an
                # incident on the GCS bus — in-process when the watchdog
                # runs inside the GCS, via RPC from standalone pollers.
                from .postmortem import publish_trigger

                publish_trigger(
                    "watchdog.alert",
                    {
                        "rule": rule.name,
                        "metric": rule.metric,
                        "value": value,
                        "threshold": rule.threshold,
                    },
                    source="watchdog",
                )
            try:
                from .logs import get_logger

                get_logger("watchdog").warning(
                    "alert %s %s: %s=%r %s %r",
                    rule.name,
                    event["state"],
                    rule.metric,
                    value,
                    rule.op,
                    rule.threshold,
                )
            # lint: swallow-ok(alert logging is best-effort; publish below is the contract)
            except Exception:
                pass
            # Dump BEFORE publishing: the alert event carries its dump
            # path, and in-process subscribers may read the published
            # dict before a post-publish mutation lands.
            if event["state"] == "firing" and now - self._last_dump >= _DUMP_MIN_INTERVAL_S:
                self._last_dump = now
                try:
                    event["flight_dump"] = self._dump_fn(
                        reason=f"watchdog: {rule.name} firing "
                        f"(value={value!r} threshold={rule.threshold})"
                    )
                except Exception:  # lint: swallow-ok(flight dump is best-effort enrichment)
                    pass
            try:
                self._publish(event)
            except Exception:
                pass  # lint: swallow-ok(pubsub down means GCS is down; alert kept in return value)
            published.append(event)
        return published

    @staticmethod
    def _alert_event(
        rule: Rule, state: str, value: Optional[float], now: float
    ) -> Dict[str, Any]:
        return {
            "event": "slo_alert",
            "rule": rule.name,
            "metric": rule.metric,
            "stat": rule.stat,
            "state": state,
            "value": value,
            "op": rule.op,
            "threshold": rule.threshold,
            "description": rule.description,
            "ts": now,
        }

    def active_alerts(self) -> List[Dict[str, Any]]:
        with self._lock:
            out = []
            for rule in self.rules:
                info = self._firing.get(rule.name)
                if info is None:
                    continue
                out.append(
                    {
                        "rule": rule.name,
                        "metric": rule.metric,
                        "stat": rule.stat,
                        "op": rule.op,
                        "threshold": rule.threshold,
                        "value": info["value"],
                        "since": info["since"],
                        "description": rule.description,
                    }
                )
            return out
