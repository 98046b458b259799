"""The port's copies of the exception types that the in-process runtime,
Serve and the LLM engine raise (ray_tpu/exceptions.py)."""

from __future__ import annotations

import traceback
from typing import Optional


class RayTpuError(Exception):
    """Base class for all framework errors."""


class TaskError(RayTpuError):
    """A task raised an exception; re-raised at `get` on the caller, with the
    remote traceback attached."""

    def __init__(self, cause: BaseException, remote_tb: Optional[str] = None, task_desc: str = ""):
        self.cause = cause
        self.remote_tb = remote_tb or "".join(
            traceback.format_exception(type(cause), cause, cause.__traceback__)
        )
        self.task_desc = task_desc
        super().__init__(str(cause))

    def __reduce__(self):
        return (TaskError, (self.cause, self.remote_tb, self.task_desc))

    def __str__(self):
        return (
            f"{type(self.cause).__name__}: {self.cause}\n"
            f"--- remote traceback ({self.task_desc}) ---\n{self.remote_tb}"
        )


class ActorError(RayTpuError):
    pass


class ActorDiedError(ActorError):
    def __init__(self, actor_id_hex: str = "", reason: str = "actor died"):
        self.actor_id_hex = actor_id_hex
        self.reason = reason
        super().__init__(f"Actor {actor_id_hex[:12]} died: {reason}")


class GetTimeoutError(RayTpuError, TimeoutError):
    pass


class ActorNameTakenError(RayTpuError, ValueError):
    """An actor name/namespace pair is already claimed. Subclasses
    ValueError to match the reference's naming error shape."""


class BackpressureError(RayTpuError):
    """A serve-side admission control rejected the request: the system is
    at capacity and queueing further would only grow tail latency. The
    caller should back off and retry (or route elsewhere) — the request
    was NOT partially executed."""

    def __init__(self, reason: str = "at capacity", retry_after_s: float = 0.5):
        self.reason = reason
        self.retry_after_s = retry_after_s
        super().__init__(f"request shed: {reason} (retry after {retry_after_s:.1f}s)")

    def __reduce__(self):
        return (type(self), (self.reason, self.retry_after_s))


class KVPoolExhaustedError(BackpressureError):
    """The paged KV-cache pool cannot hold the request's prompt even
    after evicting every unreferenced cached prefix. Carries pool
    occupancy so clients can distinguish 'transiently full' (retry) from
    'prompt larger than the pool' (never admissible)."""

    def __init__(self, needed_pages: int = 0, free_pages: int = 0,
                 total_pages: int = 0, retry_after_s: float = 0.5):
        self.needed_pages = needed_pages
        self.free_pages = free_pages
        self.total_pages = total_pages
        BackpressureError.__init__(
            self,
            reason=(
                f"KV page pool exhausted (need {needed_pages} pages, "
                f"{free_pages} free of {total_pages})"
            ),
            retry_after_s=retry_after_s,
        )

    def __reduce__(self):
        return (
            KVPoolExhaustedError,
            (self.needed_pages, self.free_pages, self.total_pages, self.retry_after_s),
        )


class BatchItemError(RayTpuError):
    """One item of a `@serve.batch` invocation failed: the batch handler
    put an Exception instance in that item's result slot, and only this
    item's waiter sees it."""

    def __init__(self, cause: BaseException, index: int = -1):
        self.cause = cause
        self.index = index
        super().__init__(
            f"batch item {index} failed: {type(cause).__name__}: {cause}"
        )

    def __reduce__(self):
        return (BatchItemError, (self.cause, self.index))
