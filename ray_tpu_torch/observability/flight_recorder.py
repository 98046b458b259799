"""Per-process flight recorder: a fixed-size ring of recent runtime events
(the `record` of ray_tpu/observability/flight_recorder.py, for the
PyTorch port).

`record()` is one counter bump and one slot store, no lock and no IO, so
the channel's reads and writes, the chaos controller's injections and the
trainer's and the Serve controller's reactions can afford it
unconditionally; `snapshot()` reads the
ring back in order.
The JAX package's dumps, crash hooks and trace merge are not ported.

Env knobs: RAY_TPU_FLIGHT_RECORDER=0 turns the ring off,
RAY_TPU_FLIGHT_RECORDER_SIZE sets its capacity (default 4096 events).
"""

from __future__ import annotations

import itertools
import os
import time
from typing import Any, List, Optional

_DEFAULT_SIZE = 4096

# Event-kind prefixes (the segment before the first ".") the port records,
# the JAX package's KIND_PREFIXES for the paths the port has; consumers
# group and filter by prefix.
KIND_PREFIXES = {
    "chan",   # core/channel.py reads/writes/timeouts
    "chaos",  # chaos controller injections
    "pool",   # core/worker_pool.py pops, misses, refills, zygote loss and respawn
    "serve",  # the Serve controller's drain replacements (serve.drain_replace)
    "train",  # trainer drains, restores and elastic resizes
}


class FlightRecorder:
    """One process's ring. Module-level singleton below; separate
    instances exist only in tests."""

    def __init__(self, size: Optional[int] = None):
        if size is None:
            try:
                size = int(os.environ.get("RAY_TPU_FLIGHT_RECORDER_SIZE", _DEFAULT_SIZE))
            except ValueError:
                size = _DEFAULT_SIZE
        self.size = max(16, int(size))
        self._buf: List[Any] = [None] * self.size
        self._n = itertools.count()
        self._enabled = os.environ.get("RAY_TPU_FLIGHT_RECORDER") != "0"

    def record(self, kind: str, detail: Any = None) -> None:
        """Hot path: one counter bump + one slot store. The sequence
        number rides the slot so snapshot() can restore exact order."""
        if not self._enabled:
            return
        n = next(self._n)
        self._buf[n % self.size] = (n, time.time_ns() // 1000, kind, detail)

    def snapshot(self) -> List[tuple]:
        """(ts_us, kind, detail) events oldest -> newest."""
        events = [e for e in list(self._buf) if e is not None]
        events.sort(key=lambda e: e[0])
        return [e[1:] for e in events]


RECORDER = FlightRecorder()
record = RECORDER.record  # the hot-path alias instrumented code imports
