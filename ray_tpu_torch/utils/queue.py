"""Distributed FIFO queue backed by an actor (the port of
ray_tpu/utils/queue.py).

Re-design of the reference's ray.util.queue.Queue (reference:
python/ray/util/queue.py — an actor-hosted queue shared between
tasks/actors/drivers, with optional maxsize and blocking put/get).

Design note: actor methods never block — blocking semantics live in the
CLIENT as a poll loop. An actor that awaited inside get()/put() would hold
one of its max_concurrency slots per blocked caller, and enough blocked
consumers would starve the producer's call out of the actor entirely
(deadlock). Non-blocking methods keep every slot short-lived.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any, List, Optional

from .. import api

_POLL_S = 0.02


class Empty(Exception):
    pass


class Full(Exception):
    pass


class _QueueActor:
    """Purely non-blocking queue state holder."""

    def __init__(self, maxsize: int = 0):
        self._q: deque = deque()
        self._maxsize = maxsize

    def try_put(self, item: Any) -> bool:
        if self._maxsize and len(self._q) >= self._maxsize:
            return False
        self._q.append(item)
        return True

    def try_get(self):
        if not self._q:
            return (False, None)
        return (True, self._q.popleft())

    def try_put_batch(self, items: List[Any]) -> bool:
        """All-or-nothing: a partial enqueue on Full would silently split
        the batch."""
        if self._maxsize and len(self._q) + len(items) > self._maxsize:
            return False
        self._q.extend(items)
        return True

    def try_get_batch(self, n: int):
        """All-or-nothing: draining fewer than n and discarding them would
        destroy items for every consumer."""
        if len(self._q) < n:
            return (False, None)
        return (True, [self._q.popleft() for _ in range(n)])

    def qsize(self) -> int:
        return len(self._q)

    def empty(self) -> bool:
        return not self._q

    def full(self) -> bool:
        return bool(self._maxsize) and len(self._q) >= self._maxsize


class Queue:
    """Driver/task-side handle; all operations proxy to the queue actor."""

    def __init__(self, maxsize: int = 0, actor_options: Optional[dict] = None):
        opts = dict(actor_options or {})
        opts.setdefault("max_concurrency", 8)
        self._actor = api.remote(**opts)(_QueueActor).remote(maxsize)
        self._maxsize = maxsize

    def _poll(self, attempt, timeout: Optional[float], fail_exc) -> Any:
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            ok, value = attempt()
            if ok:
                return value
            if deadline is not None and time.monotonic() >= deadline:
                raise fail_exc
            time.sleep(_POLL_S)

    def put(self, item: Any, block: bool = True, timeout: Optional[float] = None) -> None:
        if not block:
            if not api.get(self._actor.try_put.remote(item)):
                raise Full("queue is full")
            return
        self._poll(
            lambda: (api.get(self._actor.try_put.remote(item)), None),
            timeout,
            Full("queue is full (timeout)"),
        )

    def get(self, block: bool = True, timeout: Optional[float] = None) -> Any:
        if not block:
            ok, item = api.get(self._actor.try_get.remote())
            if not ok:
                raise Empty("queue is empty")
            return item
        return self._poll(
            lambda: api.get(self._actor.try_get.remote()),
            timeout,
            Empty("queue is empty (timeout)"),
        )

    def put_nowait(self, item: Any) -> None:
        self.put(item, block=False)

    def get_nowait(self) -> Any:
        return self.get(block=False)

    def put_nowait_batch(self, items: List[Any]) -> None:
        if not api.get(self._actor.try_put_batch.remote(list(items))):
            raise Full(f"batch of {len(items)} does not fit")

    def get_nowait_batch(self, n: int) -> List[Any]:
        ok, items = api.get(self._actor.try_get_batch.remote(n))
        if not ok:
            raise Empty(f"queue holds fewer than {n} items")
        return items

    def qsize(self) -> int:
        return api.get(self._actor.qsize.remote())

    def empty(self) -> bool:
        return api.get(self._actor.empty.remote())

    def full(self) -> bool:
        return api.get(self._actor.full.remote())

    def shutdown(self) -> None:
        api.kill(self._actor)
