"""ActorPool: load-balanced work distribution over a fixed set of actors
(the port of ray_tpu/utils/actor_pool.py).

Re-design of the reference's ray.util.ActorPool (reference:
python/ray/util/actor_pool.py — submit/get_next/map/map_unordered over
pre-created actor handles). Results are tracked by ObjectRef; the pool
reuses whichever actor frees up first.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, Iterator, List

from .. import api, exceptions


class ActorPool:
    def __init__(self, actors: List[Any]):
        if not actors:
            raise ValueError("ActorPool needs at least one actor")
        self._idle: List[Any] = list(actors)
        self._future_to_actor: dict = {}
        self._pending: List[Any] = []  # submission-ordered refs
        self._index_to_future: dict = {}
        self._next_task_index = 0
        self._next_return_index = 0

    # ------------------------------------------------------------- submit
    def submit(self, fn: Callable[[Any, Any], Any], value: Any) -> None:
        """fn(actor, value) -> ObjectRef; blocks only when no actor idles."""
        if not self._idle:
            self._wait_for_any()
        actor = self._idle.pop()
        ref = fn(actor, value)
        self._future_to_actor[ref] = actor
        self._index_to_future[self._next_task_index] = ref
        self._next_task_index += 1

    def has_next(self) -> bool:
        return bool(self._index_to_future)

    def has_free(self) -> bool:
        return bool(self._idle)

    def get_next(self, timeout: float = None) -> Any:
        """Next result in SUBMISSION order."""
        if not self.has_next():
            raise StopIteration("no pending results")
        if self._next_return_index not in self._index_to_future:
            # Earlier indices were consumed unordered: resume at the
            # oldest still-pending submission.
            self._next_return_index = min(self._index_to_future)
        idx = self._next_return_index
        ref = self._index_to_future[idx]
        try:
            # Fetch BEFORE consuming bookkeeping: a timeout (or an
            # interrupt — the task may still be running) must leave the
            # result claimable by a retrying get_next.
            value = api.get(ref, timeout=timeout)
        except exceptions.GetTimeoutError:
            raise
        except exceptions.RayTpuError:
            # Any other framework error is TERMINAL for this submission
            # (task raised / cancelled / object lost / worker crashed):
            # its result is consumed (re-raising here is the delivery) and
            # its actor is free again — without this, one failing task
            # permanently leaks its actor from the pool and has_next()
            # livelocks.
            del self._index_to_future[idx]
            self._next_return_index = idx + 1
            self._release(ref)
            raise
        del self._index_to_future[idx]
        self._next_return_index = idx + 1
        self._release(ref)
        return value

    def get_next_unordered(self, timeout: float = None) -> Any:
        """Whichever pending result finishes first."""
        if not self.has_next():
            raise StopIteration("no pending results")
        refs = list(self._index_to_future.values())
        ready, _ = api.wait(refs, num_returns=1, timeout=timeout)
        if not ready:
            raise TimeoutError("no result within timeout")
        ref = ready[0]
        for idx, r in self._index_to_future.items():
            if r == ref:
                del self._index_to_future[idx]
                break
        try:
            value = api.get(ref)
        finally:
            # Ready means the task reached a terminal state: the actor is
            # free whether the result is a value or a raised error.
            self._release(ref)
        return value

    # ---------------------------------------------------------------- map
    def map(self, fn: Callable[[Any, Any], Any], values: Iterable[Any]) -> Iterator[Any]:
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next()

    def map_unordered(
        self, fn: Callable[[Any, Any], Any], values: Iterable[Any]
    ) -> Iterator[Any]:
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next_unordered()

    def _release(self, ref) -> None:
        freed = self._future_to_actor.pop(ref, None)
        if freed is not None and not isinstance(freed, _Returned):
            self._idle.append(freed)

    # ------------------------------------------------------------- manage
    def push(self, actor: Any) -> None:
        self._idle.append(actor)

    def pop_idle(self) -> Any:
        return self._idle.pop() if self._idle else None

    def _wait_for_any(self) -> None:
        # Only wait on refs whose actor hasn't already been handed back.
        refs = [
            r
            for r, a in self._future_to_actor.items()
            if not isinstance(a, _Returned)
        ]
        if not refs:
            return
        ready, _ = api.wait(refs, num_returns=1, timeout=None)
        for ref in ready:
            actor = self._future_to_actor.get(ref)
            if actor is None or isinstance(actor, _Returned):
                continue
            # The result stays claimable via get_next; the actor is free
            # to take new work as soon as its task finished.
            self._idle.append(actor)
            self._future_to_actor[ref] = _Returned(actor)
            break


class _Returned:
    """Marker wrapper: result not yet consumed but actor already reused."""

    __slots__ = ("actor",)

    def __init__(self, actor):
        self.actor = actor
