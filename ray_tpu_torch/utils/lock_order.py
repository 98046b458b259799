"""Dynamic lock-order detector (the port of ray_tpu/utils/lock_order.py).

The Python analogue of lockdep: control-plane locks are made through
``tracked_lock(name)`` / ``tracked_rlock(name)``. Disarmed (the default),
those return plain ``threading.Lock``/``RLock`` -- no wrapper, no cost per
acquire. With ``RAY_TPU_LOCK_ORDER=1`` they return wrappers that keep a
per-thread stack of held locks, a process-wide acquisition-order graph (an
edge A->B for every acquire of B while A is held) and each hold's time.

Violations, each reported once per signature per process through the
flight recorder, the structured log and the
``raytpu_lock_order_violations_total{kind}`` counter:

- ``cycle``      -- acquiring B while holding A when the graph already
                    proves B ->* A: two threads on those paths can deadlock,
                    even if this run did not;
- ``self``       -- re-acquiring a held non-reentrant Lock on the same
                    thread: a certain deadlock, reported before blocking;
- ``long_hold``  -- a critical section held past ``RAY_TPU_LOCK_ORDER_HOLD_S``
                    (default 1.0 s).

Edges between different instances of one name (per-object locks of one
class) are skipped: the graph is keyed by site name.

The port's GCS (``gcs.state``, ``gcs.incidents``), raylet (``raylet.*``)
and Serve controller (``serve.controller``) make their locks here, as the
JAX package's do. This module never imports torch.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Dict, List, Optional, Set, Tuple

ENV_VAR = "RAY_TPU_LOCK_ORDER"
HOLD_ENV = "RAY_TPU_LOCK_ORDER_HOLD_S"
_DEFAULT_HOLD_S = 1.0


def armed() -> bool:
    return os.environ.get(ENV_VAR) == "1"


def hold_threshold_s() -> float:
    try:
        return float(os.environ.get(HOLD_ENV, _DEFAULT_HOLD_S))
    except ValueError:
        return _DEFAULT_HOLD_S


# Cached on module load and refreshed by the factories and reset() — an
# os.environ read per lock RELEASE is measurable on the dispatch path.
_hold_s = hold_threshold_s()


# ------------------------------------------------------------- state
# One registry per process. The registry's own mutex is a PLAIN lock —
# instrumenting it would recurse.
_mu = threading.Lock()
_edges: Dict[Tuple[str, str], Dict[str, Any]] = {}  # (held, acquired) -> info
_adj: Dict[str, Set[str]] = {}                      # held -> {acquired, ...}
_violations: List[Dict[str, Any]] = []
_reported: Set[Tuple] = set()
_tls = threading.local()


def _held_stack() -> List[Dict[str, Any]]:
    st = getattr(_tls, "held", None)
    if st is None:
        st = _tls.held = []
    return st


def _report(kind: str, signature: Tuple, detail: Dict[str, Any]) -> None:
    """Once per (kind, signature) per process: flight record + metric +
    structured log + in-process list for tests/debug RPCs."""
    with _mu:
        if (kind,) + signature in _reported:
            return
        _reported.add((kind,) + signature)
        _violations.append(dict(detail, kind=kind))
    try:
        from ..observability.flight_recorder import record as _flight_record

        _flight_record(f"lock.order_{kind}", detail)
    except Exception:  # lint: swallow-ok(detector reporting must never break the runtime)
        pass
    try:
        from . import internal_metrics as imet

        imet.LOCK_ORDER_VIOLATIONS.inc(kind=kind)
    except Exception:  # lint: swallow-ok(detector reporting must never break the runtime)
        pass
    try:
        from ..observability.logs import get_logger

        get_logger("lock_order").warning("lock-order %s: %s", kind, detail)
    except Exception:  # lint: swallow-ok(detector reporting must never break the runtime)
        pass


def _reaches(src: str, dst: str) -> Optional[List[str]]:
    """Path src ->* dst in the order graph (caller holds _mu), or None."""
    stack = [(src, [src])]
    seen = {src}
    while stack:
        node, path = stack.pop()
        if node == dst:
            return path
        for nxt in _adj.get(node, ()):
            if nxt not in seen:
                seen.add(nxt)
                stack.append((nxt, path + [nxt]))
    return None


def _on_acquired(name: str, obj_id: int) -> None:
    held = _held_stack()
    if held:
        _note_nested(held, name)
    held.append((name, time.monotonic(), obj_id))


def _note_nested(held, name: str) -> None:
    # Entries are (name, t0, obj_id) tuples; the common cases — an edge
    # already known — touch no mutex (dict membership reads are
    # GIL-atomic; edges are add-only).
    for h_name, _t0, _hid in held:
        if h_name == name:
            # Same-site ordering among sibling instances (or RLock
            # reentrancy) — not a cross-site invariant; skip the edge.
            continue
        pair = (h_name, name)
        if pair in _edges:
            continue
        with _mu:
            if pair in _edges:
                continue
            # Before inserting held->name, a pre-existing path
            # name ->* held proves the inversion.
            path = _reaches(name, h_name)
            _edges[pair] = {"thread": threading.get_ident(),
                            "ts": time.monotonic()}
            _adj.setdefault(h_name, set()).add(name)
        if path is not None:
            _report(
                "cycle",
                (h_name, name),
                {
                    "acquiring": name,
                    "while_holding": h_name,
                    "established_order": "->".join(path),
                    "thread": threading.get_ident(),
                },
            )


def _on_released(name: str, obj_id: int) -> None:
    held = _held_stack()
    for i in range(len(held) - 1, -1, -1):
        if held[i][2] == obj_id and held[i][0] == name:
            _n, t0, _hid = held.pop(i)
            dt = time.monotonic() - t0
            if dt > _hold_s:
                _report(
                    "long_hold",
                    (name,),
                    {"lock": name, "held_s": round(dt, 3),
                     "thread": threading.get_ident()},
                )
            return


class TrackedLock:
    """Instrumented non-reentrant lock. Compatible with `with`, blocking
    and timeout acquires, and threading.Condition's lock protocol.

    The acquire/release fast path (no other lock held) is hand-inlined:
    the test suite arms this wrapper on every daemon it boots."""

    _reentrant = False
    __slots__ = ("name", "_id", "_inner", "_acq", "_rel")

    def __init__(self, name: str):
        self.name = name
        self._id = id(self)
        self._inner = threading.Lock()
        self._acq = self._inner.acquire
        self._rel = self._inner.release

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        held = getattr(_tls, "held", None)
        if held is None:
            held = _tls.held = []
        if held:
            if not self._reentrant and blocking and timeout < 0:
                # Guaranteed deadlock: report BEFORE blocking forever, so
                # the run survives to surface the bug, not demonstrate it.
                for h in held:
                    if h[2] == self._id:
                        _report(
                            "self",
                            (self.name, "self-deadlock"),
                            {"lock": self.name,
                             "thread": threading.get_ident()},
                        )
                        break
        got = self._acq(blocking, timeout)
        if got:
            if held:
                _note_nested(held, self.name)
            held.append((self.name, time.monotonic(), self._id))
        return got

    def release(self) -> None:
        held = getattr(_tls, "held", None)
        if held and held[-1][2] == self._id:
            t0 = held.pop()[1]
            if time.monotonic() - t0 > _hold_s:
                _report(
                    "long_hold",
                    (self.name,),
                    {"lock": self.name,
                     "held_s": round(time.monotonic() - t0, 3),
                     "thread": threading.get_ident()},
                )
        else:
            _on_released(self.name, self._id)
        self._rel()

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self) -> "TrackedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"<TrackedLock {self.name} {self._inner!r}>"


class TrackedRLock(TrackedLock):
    """Instrumented reentrant lock: recursion depth tracked so the held
    stack and hold timing cover the OUTERMOST hold only."""

    _reentrant = True

    def __init__(self, name: str):
        self.name = name
        self._id = id(self)
        self._inner = threading.RLock()
        self._acq = self._inner.acquire
        self._rel = self._inner.release

    def _depth_cell(self) -> Dict[int, int]:
        cell = getattr(_tls, "rdepth", None)
        if cell is None:
            cell = _tls.rdepth = {}
        return cell

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._inner.acquire(blocking, timeout)
        if got:
            cell = self._depth_cell()
            d = cell.get(id(self), 0)
            cell[id(self)] = d + 1
            if d == 0:
                _on_acquired(self.name, id(self))
        return got

    def release(self) -> None:
        cell = self._depth_cell()
        d = cell.get(id(self), 0)
        if d <= 1:
            cell.pop(id(self), None)
            _on_released(self.name, id(self))
        else:
            cell[id(self)] = d - 1
        self._inner.release()

    def locked(self) -> bool:  # RLock has no locked() before 3.12
        if self._inner.acquire(blocking=False):
            self._inner.release()
            return False
        return True

    def __repr__(self) -> str:
        return f"<TrackedRLock {self.name} {self._inner!r}>"


# ------------------------------------------------------------ factories
def tracked_lock(name: str):
    """A named control-plane lock: plain threading.Lock when disarmed
    (zero overhead), TrackedLock under RAY_TPU_LOCK_ORDER=1."""
    if armed():
        global _hold_s
        _hold_s = hold_threshold_s()
        return TrackedLock(name)
    return threading.Lock()


def tracked_rlock(name: str):
    if armed():
        global _hold_s
        _hold_s = hold_threshold_s()
        return TrackedRLock(name)
    return threading.RLock()


# ------------------------------------------------------------- queries
def violations() -> List[Dict[str, Any]]:
    with _mu:
        return [dict(v) for v in _violations]


def order_graph() -> Dict[str, List[str]]:
    with _mu:
        return {k: sorted(v) for k, v in _adj.items()}


def reset() -> None:
    """Test hook: forget edges, violations, and per-thread state for the
    CURRENT thread (other threads' stacks drain as they release)."""
    global _hold_s
    with _mu:
        _edges.clear()
        _adj.clear()
        _violations.clear()
        _reported.clear()
    _tls.held = []
    _tls.rdepth = {}
    _hold_s = hold_threshold_s()
