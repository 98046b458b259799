"""Event-driven actor manager shared by library controllers (copy of
ray_tpu/air/execution.py for the PyTorch port).

Re-design of the reference's AIR execution layer (reference:
python/ray/air/execution/_internal/actor_manager.py:22 RayActorManager —
the event-driven actor pool that Tune's TuneController drives,
tune/execution/tune_controller.py:68). Controllers declare actors and
method calls with CALLBACKS; the manager owns the wait loop: each
`next()` blocks for one completion event and dispatches its callback on
the caller's thread. This inverts the bookkeeping out of every
controller (tune trials, train coordinators, evaluation pools) into one
place — actor tracking, in-flight task maps, fair completion ordering,
error routing.
"""

from __future__ import annotations

import random
from typing import Any, Callable, Dict, List, Optional, Tuple

from .. import api


class TrackedActor:
    """Handle + bookkeeping for one managed actor."""

    __slots__ = ("tracked_id", "handle", "alive")

    def __init__(self, tracked_id: str, handle: Any):
        self.tracked_id = tracked_id
        self.handle = handle
        self.alive = True


class ActorManager:
    """Owns actors + in-flight method calls; next() pumps ONE event."""

    def __init__(self):
        self._actors: Dict[str, TrackedActor] = {}
        self._next_id = 0
        # ref-hex -> (tracked_id, on_result, on_error)
        self._inflight: Dict[str, Tuple[str, Any, Callable, Optional[Callable]]] = {}

    # -------------------------------------------------------------- actors
    def add_actor(self, actor_cls, *args, **kwargs) -> TrackedActor:
        """Creates a managed actor (actor_cls is an @remote class)."""
        self._next_id += 1
        tid = f"actor_{self._next_id:05d}"
        tracked = TrackedActor(tid, actor_cls.remote(*args, **kwargs))
        self._actors[tid] = tracked
        return tracked

    def remove_actor(self, tracked: TrackedActor, kill: bool = True) -> None:
        tracked.alive = False
        self._actors.pop(tracked.tracked_id, None)
        # Drop queued events for it: callbacks must not fire after removal
        # (reference: actor_manager's clear_actor_task_futures).
        self._inflight = {
            h: rec for h, rec in self._inflight.items() if rec[0] != tracked.tracked_id
        }
        if kill:
            try:
                api.kill(tracked.handle)
            except Exception:  # actor may already be dead
                pass

    @property
    def num_live_actors(self) -> int:
        return len(self._actors)

    # --------------------------------------------------------------- tasks
    def schedule_task(
        self,
        tracked: TrackedActor,
        method: str,
        *args,
        on_result: Callable[[Any], None],
        on_error: Optional[Callable[[BaseException], None]] = None,
        **kwargs,
    ) -> None:
        """Schedules `tracked.handle.method(*args)`; its completion event
        dispatches on_result(value) (or on_error(exc)) from next(). With
        no on_error, the failure RAISES out of next() — errors must never
        vanish silently."""
        if not tracked.alive:
            raise RuntimeError(
                f"cannot schedule {method!r} on removed actor {tracked.tracked_id}"
            )
        ref = getattr(tracked.handle, method).remote(*args, **kwargs)
        self._inflight[ref.id().hex()] = (tracked.tracked_id, ref, on_result, on_error)

    @property
    def num_pending_tasks(self) -> int:
        return len(self._inflight)

    # --------------------------------------------------------------- pump
    def next(self, timeout: Optional[float] = None) -> bool:
        """Waits for ONE completion and dispatches its callback. Returns
        False when nothing is in flight or the wait timed out. Completion
        polling order is randomized each call so no actor's results are
        systematically served first (fair rung arrival for ASHA-style
        consumers — the reference shuffles for the same reason)."""
        if not self._inflight:
            return False
        refs = [rec[1] for rec in self._inflight.values()]
        random.shuffle(refs)
        ready, _ = api.wait(refs, num_returns=1, timeout=timeout)
        if not ready:
            return False
        ref = ready[0]
        rec = self._inflight.pop(ref.id().hex(), None)
        if rec is None:
            return self.next(timeout)  # raced a remove_actor: try again
        _, _, on_result, on_error = rec
        try:
            value = api.get(ref)
        except BaseException as e:  # noqa: BLE001
            if on_error is None:
                raise  # no handler: a swallowed failure would hang the loop
            on_error(e)
            return True
        on_result(value)
        return True
