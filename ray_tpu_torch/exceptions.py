"""The port's copies of the serving path's exception types
(ray_tpu/exceptions.py: RayTpuError, BackpressureError, KVPoolExhaustedError)."""

from __future__ import annotations


class RayTpuError(Exception):
    """Base class for all framework errors."""


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
