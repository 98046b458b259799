"""Autoscaling actor pools for streaming-executor operators (the port of
ray_tpu/data/op_pool.py).

Re-design of the reference's autoscaling actor-pool map operator
(reference: python/ray/data/_internal/execution/operators/
actor_pool_map_operator.py:34 with the autoscaler in
_internal/execution/autoscaler/default_autoscaler.py — util-driven
scale-up, idle scale-down). Differences:

- **Pressure, not utilization.** The executor hands each pool a pair of
  signals every scheduling tick: *backlogged upstream* (this operator's
  input queue is non-empty and every actor is saturated) and *starved
  downstream* (the next operator — or the consumer — is out of work).
  Only the conjunction, sustained for `up_s`, triggers a scale-up: a
  backlog the downstream can't absorb anyway is a byte-budget problem
  (backpressure), not a parallelism problem.

- **Forecast-first growth.** Before an actor is ever spawned, the pool
  declares the projected growth to the GCS demand-forecast table
  (`report_demand_forecast(n, ttl, source="data")`, keyed by source).
  Raylets fold the forecast into their next
  heartbeat's `pool_hint` and pre-size the warm worker pool, so by the
  time the sustain window elapses and the spawn lands, it pops a live
  idle worker or a parked zygote pre-fork instead of cold-booting
  python+torch.

- **Idle decay.** A pool whose actors have all been idle for `idle_s`
  sheds one actor per interval back to `min_size` — storms are spiky;
  a slow decay keeps the warm capacity through a burst train without
  pinning it forever.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional

from .. import api
from ..utils import internal_metrics as imet
from ..utils import config


def _flight_record(kind: str, payload: Any) -> None:
    try:
        from ..observability.flight_recorder import record

        record(kind, payload)
    except Exception:  # lint: swallow-ok(flight recorder must not break the data plane)
        pass


def _declare_forecast(n: int, ttl_s: float = 30.0) -> None:
    """Declares imminent pool growth to the GCS so warm worker pools
    pre-size before the spawn (a hint, not a reservation — failures and
    local_mode, which has no GCS, degrade to cold spawns)."""
    from ..core import runtime_base

    rt = runtime_base.maybe_runtime()
    gcs = getattr(rt, "_gcs", None)
    if gcs is None:
        return
    try:
        gcs.call("report_demand_forecast", int(n), float(ttl_s), "data")
    except Exception:  # lint: swallow-ok(forecast is an optimization hint; growth proceeds cold)
        pass


class OperatorPool:
    """One operator's actor pool: least-loaded dispatch + pressure-driven
    autoscaling between [min_size, max_size]."""

    def __init__(
        self,
        name: str,
        spawn: Callable[[], Any],
        min_size: int = 1,
        max_size: Optional[int] = None,
        up_s: Optional[float] = None,
        idle_s: Optional[float] = None,
    ):
        self.name = name
        self._spawn = spawn
        self.min_size = max(1, int(min_size))
        cap = max_size if max_size is not None else config.DATA_POOL_MAX
        self.max_size = max(self.min_size, int(cap))
        self._up_s = config.DATA_POOL_UP_S if up_s is None else float(up_s)
        self._idle_s = config.DATA_POOL_IDLE_S if idle_s is None else float(idle_s)
        # A pressure streak survives calm blips up to this wide: scheduler
        # races (inqueue drained into pending for one tick, one output
        # briefly parked) produce single calm observations mid-storm, and
        # resetting the sustain clock on each would keep a genuinely
        # backlogged pool at min_size forever.
        self._blip_s = min(0.25, self._up_s / 2)
        self._lock = threading.Lock()
        self._actors: List[Any] = []
        self._load: Dict[int, int] = {}  # id(actor) -> inflight count
        self._ref_owner: Dict[int, int] = {}  # id(ref) -> id(actor)
        self._pressured_since: Optional[float] = None
        self._last_pressured: Optional[float] = None
        self._forecast_declared = False
        self._idle_since: Optional[float] = None
        self.scale_ups = 0
        self.scale_downs = 0

    # ------------------------------------------------------------ lifecycle
    def start(self) -> None:
        with self._lock:
            while len(self._actors) < self.min_size:
                self._add_actor_locked()
        self._gauge()

    def shutdown(self, inflight: Optional[List[Any]] = None) -> None:
        """Tears the pool down; in-flight applies (early consumer exit) get
        a short grace first so refs already handed downstream resolve."""
        pending = list(inflight or [])
        stalled = 0.0
        while pending and stalled < 60.0:
            try:
                before = len(pending)
                _, pending = api.wait(pending, num_returns=len(pending), timeout=5)
                stalled = 0.0 if len(pending) < before else stalled + 5.0
            except Exception:
                break
        with self._lock:
            actors, self._actors = self._actors, []
            self._load.clear()
            self._ref_owner.clear()
        for a in actors:
            try:
                api.kill(a)
            except Exception:  # lint: swallow-ok(pool actor may already be dead)
                pass
        self._gauge()

    # ------------------------------------------------------------- dispatch
    @property
    def size(self) -> int:
        return len(self._actors)

    @property
    def capacity(self) -> int:
        """How many tasks the executor may keep in flight on this pool."""
        return 2 * max(1, len(self._actors))

    def submit(self, call: Callable[[Any], Any]) -> Any:
        """Dispatches `call(actor)` on the least-loaded actor."""
        with self._lock:
            actor = min(self._actors, key=lambda a: self._load.get(id(a), 0))
            self._load[id(actor)] = self._load.get(id(actor), 0) + 1
        ref = call(actor)
        with self._lock:
            self._ref_owner[id(ref)] = id(actor)
        return ref

    def task_done(self, ref: Any) -> None:
        with self._lock:
            owner = self._ref_owner.pop(id(ref), None)
            if owner is not None and owner in self._load:
                self._load[owner] = max(0, self._load[owner] - 1)

    # ---------------------------------------------------------- autoscaling
    def update_pressure(
        self, backlogged: bool, starved: bool, now: Optional[float] = None
    ) -> None:
        """One scheduler-tick observation; may scale the pool.

        Scale-up ladder: pressure appears -> forecast declared at once
        (warm pools pre-size during the sustain window) -> pressure
        sustained `up_s` -> actors actually spawn (doubling, capped)."""
        now = time.monotonic() if now is None else now
        grew = shrank = False
        with self._lock:
            size = len(self._actors)
            pressured = backlogged and starved and size < self.max_size
            if pressured:
                self._idle_since = None
                self._last_pressured = now
                if self._pressured_since is None:
                    self._pressured_since = now
                grow = min(self.max_size - size, max(1, size))
                if not self._forecast_declared:
                    self._forecast_declared = True
                    declare = grow
                else:
                    declare = 0
                if now - self._pressured_since >= self._up_s:
                    for _ in range(grow):
                        self._add_actor_locked()
                    self._pressured_since = None
                    self._forecast_declared = False
                    self.scale_ups += 1
                    grew = True
            elif (
                self._pressured_since is not None
                and self._last_pressured is not None
                and now - self._last_pressured <= self._blip_s
            ):
                # Calm blip inside an active streak: hold the sustain clock
                # (and the declared forecast) instead of restarting both.
                declare = 0
            else:
                self._pressured_since = None
                self._forecast_declared = False
                declare = 0
                busy = backlogged or any(self._load.get(id(a), 0) for a in self._actors)
                if busy or size <= self.min_size:
                    self._idle_since = None
                elif self._idle_since is None:
                    self._idle_since = now
                elif now - self._idle_since >= self._idle_s:
                    self._remove_idle_actor_locked()
                    self._idle_since = now
                    self.scale_downs += 1
                    shrank = True
        if declare:
            _declare_forecast(declare)
        if grew or shrank:
            self._gauge()
            _flight_record(
                "data.pool.scale",
                (self.name, "up" if grew else "down", len(self._actors)),
            )

    # -------------------------------------------------------------- helpers
    def _add_actor_locked(self) -> None:
        a = self._spawn()
        self._actors.append(a)
        self._load[id(a)] = 0

    def _remove_idle_actor_locked(self) -> None:
        for i in range(len(self._actors) - 1, -1, -1):
            a = self._actors[i]
            if self._load.get(id(a), 0) == 0:
                self._actors.pop(i)
                self._load.pop(id(a), None)
                try:
                    api.kill(a)
                except Exception:  # lint: swallow-ok(pool actor may already be dead)
                    pass
                return

    def _gauge(self) -> None:
        try:
            imet.DATA_OP_POOL_SIZE.set(float(len(self._actors)), operator=self.name)
        except Exception:  # lint: swallow-ok(metrics must not break the data plane)
            pass
