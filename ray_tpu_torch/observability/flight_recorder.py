"""Per-process flight recorder: a fixed-size ring of recent runtime events
(the port of ray_tpu/observability/flight_recorder.py).

`record()` is one counter bump and one slot store, no lock and no IO, so
the channel's reads and writes, the compiled graphs' node runs, the chaos
controller's injections, the collective's ops and timeouts, the watchdog's
alerts, the GCS's membership transitions and the
trainer's and the Serve controller's reactions can afford it
unconditionally. When something hangs or crashes, the last N events are
the post-mortem.

Lock-freedom: the slot index comes from `itertools.count()` (atomic under
the GIL) and each slot write is a single store. Concurrent writers may
interleave slots but never corrupt one.

Dump triggers:
- the raylet's `flight_dump` RPC (it fans SIGUSR2 out to its workers), which
  the GCS's incident harvest calls (observability/postmortem.py);
- unhandled exceptions in a hooked process (sys/threading excepthook).

Env knobs:
- RAY_TPU_FLIGHT_RECORDER=0     turn the ring off entirely
- RAY_TPU_FLIGHT_RECORDER_SIZE  ring capacity in events (default 4096)
- RAY_TPU_FLIGHT_DIR            dump directory (default <trace_dir>/flight)
"""

from __future__ import annotations

import itertools
import json
import os
import sys
import threading
import time
from typing import Any, Dict, List, Optional

_DEFAULT_SIZE = 4096

# Event-kind prefixes (the segment before the first ".") the port records,
# the JAX package's KIND_PREFIXES for the paths the port has; consumers
# group and filter by prefix.
KIND_PREFIXES = {
    "cgraph",    # compiled graphs: node runs, recompiles, elastic resizes
    "chan",      # core/channel.py reads/writes/timeouts
    "chaos",     # chaos controller injections
    "coll",      # collective.py rendezvous, ring up, ops, timeouts and destroys
    "data",      # data/op_pool.py scaling and data/executor.py backpressure edges
    "incident",  # the GCS trigger bus: incident open and staged
    "net",       # chaos/net.py partitions: installs, heals, blocked sends
    "node",      # membership: the GCS's deaths, fences and joins, a raylet's fence
    "pool",      # core/worker_pool.py pops, misses, refills, zygote loss and respawn
    "serve",     # the Serve controller's drain replacements (serve.drain_replace)
    "train",     # trainer drains, restores and elastic resizes
    "trigger",   # anomaly trigger publishes (observability/postmortem.py)
    "watchdog",  # SLO watchdog alert transitions (observability/watchdog.py)
}


def _enabled() -> bool:
    return os.environ.get("RAY_TPU_FLIGHT_RECORDER") != "0"


def flight_dir() -> str:
    """Where dumps land: beside tracing's span JSONL directory, so one
    sweep (the incident harvest's stage_bundle) finds both."""
    d = os.environ.get("RAY_TPU_FLIGHT_DIR")
    if d:
        return d
    # Lazy import: tracing imports this module at load time.
    from .. import tracing

    return os.path.join(tracing.trace_dir(), "flight")


class FlightRecorder:
    """One process's ring. Module-level singleton below; separate
    instances exist only in tests."""

    def __init__(self, size: Optional[int] = None):
        if size is None:
            try:
                size = int(
                    os.environ.get("RAY_TPU_FLIGHT_RECORDER_SIZE", _DEFAULT_SIZE)
                )
            except ValueError:
                size = _DEFAULT_SIZE
        self.size = max(16, int(size))
        self._buf: List[Any] = [None] * self.size
        self._n = itertools.count()
        self._enabled = _enabled()

    def record(self, kind: str, detail: Any = None) -> None:
        """Hot path: one counter bump + one slot store. The sequence
        number rides the slot so snapshot() can restore exact order —
        microsecond timestamps tie under bursts."""
        if not self._enabled:
            return
        n = next(self._n)
        self._buf[n % self.size] = (n, time.time_ns() // 1000, kind, detail)

    def snapshot(self) -> List[tuple]:
        """(ts_us, kind, detail) events oldest -> newest."""
        events = [e for e in list(self._buf) if e is not None]
        events.sort(key=lambda e: e[0])
        return [e[1:] for e in events]

    def dump(
        self,
        path: Optional[str] = None,
        reason: str = "",
        extra: Optional[Dict[str, Any]] = None,
    ) -> Optional[str]:
        """Writes the ring to JSON; returns the path (None if disabled).
        Uses a tmp-then-rename write so a crash mid-dump never leaves a
        truncated file for the trace merger to choke on."""
        if not self._enabled:
            return None
        if path is None:
            d = flight_dir()
            os.makedirs(d, exist_ok=True)
            path = os.path.join(
                d, f"flight_{os.getpid()}_{time.time_ns() // 1000}.json"
            )
        payload = {
            "pid": os.getpid(),
            "reason": reason,
            "dump_us": time.time_ns() // 1000,
            "extra": extra or {},
            "events": self.snapshot(),
        }
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(payload, f, default=repr)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        return path


RECORDER = FlightRecorder()
record = RECORDER.record  # the hot-path alias instrumented code imports


def dump(reason: str = "", extra: Optional[Dict[str, Any]] = None) -> Optional[str]:
    return RECORDER.dump(reason=reason, extra=extra)


def collect(directory: Optional[str] = None) -> List[Dict[str, Any]]:
    """All dumps on disk (every process's), tolerating partial/corrupt
    files the same way tracing.collect does."""
    directory = directory or flight_dir()
    out: List[Dict[str, Any]] = []
    try:
        names = sorted(os.listdir(directory))
    except OSError:
        return out
    for fname in names:
        if not (fname.startswith("flight_") and fname.endswith(".json")):
            continue
        try:
            with open(os.path.join(directory, fname), errors="replace") as f:
                payload = json.load(f)
        except (OSError, ValueError):
            continue
        if isinstance(payload, dict) and isinstance(payload.get("events"), list):
            out.append(payload)
    return out


# ----------------------------------------------------------- crash hooks
_hooks_installed = False
_hook_lock = threading.Lock()


def install_crash_hooks(role: str = "") -> None:
    """Dump the ring on any unhandled exception (main thread or worker
    threads), then defer to the previous hook. Also binds SIGUSR2 ->
    dump where this thread may install signal handlers (the raylet's
    `flight_dump` fans that signal out to its worker processes).

    Installed even when the recorder is DISABLED: the SIGUSR2 handler
    must exist regardless (the signal's default disposition is process
    termination: a dump fan-out must never kill a worker), it just dumps
    nothing."""
    global _hooks_installed
    with _hook_lock:
        if _hooks_installed:
            return
        _hooks_installed = True

    prev_except = sys.excepthook

    def _excepthook(tp, val, tb):
        try:
            # An empty ring has no post-mortem value (e.g. a worker whose
            # shutdown path raised before doing any work): skip the file.
            if RECORDER.snapshot():
                RECORDER.dump(reason=f"crash[{role}]: {tp.__name__}: {val}")
        except Exception:  # lint: swallow-ok(dump must never mask the original crash)
            pass
        prev_except(tp, val, tb)

    sys.excepthook = _excepthook

    prev_thread = threading.excepthook

    def _thread_hook(args):
        try:
            if RECORDER.snapshot():
                RECORDER.dump(
                    reason=(
                        f"thread-crash[{role}] {getattr(args.thread, 'name', '?')}: "
                        f"{args.exc_type.__name__}: {args.exc_value}"
                    )
                )
        except Exception:  # lint: swallow-ok(dump must never mask the original crash)
            pass
        prev_thread(args)

    threading.excepthook = _thread_hook

    try:
        import signal

        prev_usr2 = signal.getsignal(signal.SIGUSR2)

        def _on_usr2(signum, frame):
            try:
                if RECORDER.snapshot():
                    RECORDER.dump(reason=f"signal[{role}]: SIGUSR2")
            except Exception:  # lint: swallow-ok(signal-handler dump is best-effort)
                pass
            # Chain a pre-existing user handler (e.g. an application's own
            # dump-on-signal); SIG_DFL/SIG_IGN are not callables.
            if callable(prev_usr2):
                prev_usr2(signum, frame)

        signal.signal(signal.SIGUSR2, _on_usr2)
    except (ValueError, OSError, AttributeError):
        pass  # not the main thread / platform without SIGUSR2
