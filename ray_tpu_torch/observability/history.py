"""Metrics history: bounded per-series ring buffers with coarse rollups
(the port of ray_tpu/observability/history.py).

The internal-metrics table (core/gcs.py) holds *current* aggregates, "what
is the counter now", which answers nothing a minute later: a throughput
regression, a drain or a latency climb is invisible once the moment passes.
This module gives every metric series a short memory:

- **Fine ring**: one sample per `resolution_s` bucket (newest wins inside a
  bucket), capped at `fine_samples` entries. Samples store the *cumulative*
  value for counters and histograms and the current value for gauges, so
  rates fall out of adjacent-sample differences and no flush is counted
  twice.
- **Coarse rollup**: samples evicted from the fine ring fold into
  `rollup_s`-wide buckets (capped at `coarse_samples`), keeping the last
  cumulative value per bucket for counters and histograms (lossless for
  rates at coarse granularity) and the mean for gauges. Old history gets
  cheaper, not absent.
- **Bounded everything**: at most `max_series` series are tracked; the
  overflow count is queryable, so silent truncation cannot pass for a quiet
  cluster.

Sample shape: `[ts, value]` for counters and gauges; `[ts, count, sum]` for
histograms (both cumulative), so the rate of observations and the mean
latency derive from the same ring.

The GCS owns the instance (fed from each `report_internal_metrics` merge)
and serves the `metrics_history` RPC; `utils/state.py`'s
`metrics_history()` reads it, and so do the dashboard's
`/api/metrics_history` and `python -m ray_tpu_torch.scripts top`. Disable with
RAY_TPU_METRICS_HISTORY=0; tune with RAY_TPU_METRICS_HISTORY_RESOLUTION_S /
_SAMPLES / _ROLLUP_S / _ROLLUP_SAMPLES. Standard library only.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

_DEFAULTS = {
    "resolution_s": 0.2,
    "fine_samples": 720,
    "rollup_s": 30.0,
    "coarse_samples": 480,
    "max_series": 8192,
}


def history_enabled() -> bool:
    return os.environ.get("RAY_TPU_METRICS_HISTORY", "1") != "0"


class _Series:
    """One (name, tags) series: fine ring + coarse rollup ring."""

    __slots__ = (
        "name", "kind", "tags", "fine", "coarse",
        "_coarse_key", "_gauge_sum", "_gauge_n",
    )

    def __init__(self, name: str, kind: str, tags: Dict[str, str]):
        self.name = name
        self.kind = kind
        self.tags = dict(tags)
        self.fine: List[List[float]] = []
        self.coarse: List[List[float]] = []
        self._coarse_key: Optional[int] = None
        self._gauge_sum = 0.0
        self._gauge_n = 0

    def _rollup(self, sample: List[float], rollup_s: float, coarse_cap: int) -> None:
        key = int(sample[0] // rollup_s) if rollup_s > 0 else 0
        if key != self._coarse_key:
            self._coarse_key = key
            self._gauge_sum = sample[1]
            self._gauge_n = 1
            self.coarse.append(list(sample))
            if len(self.coarse) > coarse_cap:
                del self.coarse[: len(self.coarse) - coarse_cap]
        elif self.coarse:
            if self.kind == "gauge":
                # Mean over the bucket: a spiky gauge must not survive
                # rollup as whichever edge happened to be evicted last.
                self._gauge_sum += sample[1]
                self._gauge_n += 1
                self.coarse[-1] = [
                    sample[0],
                    self._gauge_sum / max(1, self._gauge_n),
                ]
            else:
                # Cumulative series: last value in the bucket is lossless
                # for rate queries at coarse granularity.
                self.coarse[-1] = list(sample)

    def observe(
        self,
        ts: float,
        values: Tuple[float, ...],
        resolution_s: float,
        fine_cap: int,
        rollup_s: float,
        coarse_cap: int,
    ) -> None:
        sample = [ts, *values]
        if (
            self.fine
            and resolution_s > 0
            and int(ts // resolution_s) == int(self.fine[-1][0] // resolution_s)
        ):
            # Same resolution bucket: newest wins (values are cumulative
            # or current-state, so overwriting loses nothing). Bucket
            # INDEX comparison, not distance-from-last: a sliding window
            # would let many staggered reporters (< resolution apart
            # forever) pin the ring at one eternally-rewritten sample.
            self.fine[-1] = sample
            return
        self.fine.append(sample)
        while len(self.fine) > fine_cap:
            self._rollup(self.fine.pop(0), rollup_s, coarse_cap)

    def samples(self, since: Optional[float] = None) -> List[List[float]]:
        out = [s for s in self.coarse if since is None or s[0] >= since]
        out += [s for s in self.fine if since is None or s[0] >= since]
        return out


def _rate_samples(samples: List[List[float]]) -> List[List[float]]:
    """Per-second deltas between adjacent cumulative samples. Histogram
    samples ([ts, count, sum]) rate BOTH channels, so observations/s and
    (via dsum/dcount) windowed means derive from one query."""
    out: List[List[float]] = []
    for prev, cur in zip(samples, samples[1:]):
        dt = cur[0] - prev[0]
        if dt <= 0:
            continue
        deltas = [(c - p) / dt for c, p in zip(cur[1:], prev[1:])]
        out.append([cur[0], *deltas])
    return out


class MetricsHistory:
    def __init__(
        self,
        resolution_s: Optional[float] = None,
        fine_samples: Optional[int] = None,
        rollup_s: Optional[float] = None,
        coarse_samples: Optional[int] = None,
        max_series: Optional[int] = None,
    ):
        def _env(key: str, default):
            raw = os.environ.get(f"RAY_TPU_METRICS_HISTORY_{key}")
            if raw is None:
                return default
            try:
                return type(default)(raw)
            except ValueError:
                return default

        self.resolution_s = (
            resolution_s if resolution_s is not None
            else _env("RESOLUTION_S", _DEFAULTS["resolution_s"])
        )
        self.fine_samples = max(2, int(
            fine_samples if fine_samples is not None
            else _env("SAMPLES", _DEFAULTS["fine_samples"])
        ))
        self.rollup_s = (
            rollup_s if rollup_s is not None
            else _env("ROLLUP_S", _DEFAULTS["rollup_s"])
        )
        self.coarse_samples = max(1, int(
            coarse_samples if coarse_samples is not None
            else _env("ROLLUP_SAMPLES", _DEFAULTS["coarse_samples"])
        ))
        self.max_series = int(
            max_series if max_series is not None
            else _DEFAULTS["max_series"]
        )
        self._lock = threading.Lock()
        self._series: Dict[Tuple, _Series] = {}
        self.dropped_series = 0

    # ------------------------------------------------------------- writes
    def observe(
        self,
        name: str,
        kind: str,
        tags: Dict[str, str],
        value: float,
        hist_sum: Optional[float] = None,
        ts: Optional[float] = None,
    ) -> None:
        """Record one sample. For counters/histograms `value` is the
        CUMULATIVE total (count for histograms, with `hist_sum` the
        cumulative sum); for gauges it is the current value."""
        ts = time.time() if ts is None else ts
        key = (name, tuple(sorted(tags.items())))
        with self._lock:
            s = self._series.get(key)
            if s is None:
                if len(self._series) >= self.max_series:
                    self.dropped_series += 1
                    return
                s = _Series(name, kind, tags)
                self._series[key] = s
            values = (value,) if hist_sum is None else (value, hist_sum)
            s.observe(
                ts, values, self.resolution_s, self.fine_samples,
                self.rollup_s, self.coarse_samples,
            )

    # ------------------------------------------------------------- reads
    def query(
        self,
        name: Optional[str] = None,
        tags: Optional[Dict[str, str]] = None,
        window_s: Optional[float] = None,
        as_rate: bool = False,
        now: Optional[float] = None,
    ) -> List[Dict[str, Any]]:
        """Matching series with their sample lists. `tags` is a subset
        filter; `window_s` keeps samples newer than now - window_s;
        `as_rate` converts cumulative series (counter/histogram) to
        per-second deltas (gauges pass through unchanged)."""
        since = None
        if window_s is not None:
            since = (time.time() if now is None else now) - window_s
        out: List[Dict[str, Any]] = []
        with self._lock:
            # Filter AND snapshot the sample lists UNDER the lock: a
            # concurrent observe/rollup mutates fine/coarse in place,
            # and an unsynchronized read can skip or duplicate samples
            # on exactly the tick a watchdog decision is made.
            snapshot = [
                (s, s.samples(since))
                for s in self._series.values()
                if (name is None or s.name == name)
                and not (
                    tags
                    and any(s.tags.get(k) != str(v) for k, v in tags.items())
                )
            ]
        for s, samples in snapshot:
            if not samples:
                continue
            if as_rate and s.kind in ("counter", "histogram"):
                samples = _rate_samples(samples)
            out.append(
                {
                    "name": s.name,
                    "kind": s.kind,
                    "tags": dict(s.tags),
                    "samples": samples,
                }
            )
        return out

    def latest(
        self, name: str, tags: Optional[Dict[str, str]] = None,
        window_s: Optional[float] = None, now: Optional[float] = None,
    ) -> List[Tuple[Dict[str, str], List[float]]]:
        """(tags, newest sample) per matching series — the watchdog's
        threshold-rule read."""
        out = []
        for series in self.query(name, tags, window_s, now=now):
            if series["samples"]:
                out.append((series["tags"], series["samples"][-1]))
        return out

    def series_count(self) -> int:
        with self._lock:
            return len(self._series)


def merge_series(
    series: List[Dict[str, Any]],
    bucket_s: float = 2.0,
    agg: str = "sum",
) -> List[Tuple[float, float]]:
    """Collapses multiple series (e.g. one per node) into one
    [(ts, value)] line for display: samples bucket by `bucket_s`, then
    buckets aggregate across series — the shape `ray-tpu top`
    sparklines want. `agg` is `sum`, `mean`, or `max` (worst-of: a
    single node's bad heartbeat lag must not be averaged away by its
    healthy peers); within a series' bucket, samples take the mean
    (max for agg='max')."""
    per_series_buckets: List[Dict[int, float]] = []
    for s in series:
        acc: Dict[int, List[float]] = {}
        for sample in s.get("samples") or []:
            acc.setdefault(int(sample[0] // bucket_s), []).append(sample[1])
        per_series_buckets.append(
            {
                k: (max(v) if agg == "max" else sum(v) / len(v))
                for k, v in acc.items()
            }
        )
    merged: Dict[int, List[float]] = {}
    for buckets in per_series_buckets:
        for k, v in buckets.items():
            merged.setdefault(k, []).append(v)
    out = []
    for k in sorted(merged):
        vals = merged[k]
        if agg == "sum":
            v = sum(vals)
        elif agg == "max":
            v = max(vals)
        else:
            v = sum(vals) / len(vals)
        out.append((k * bucket_s, v))
    return out
