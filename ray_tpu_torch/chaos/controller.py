"""Seeded, deterministic fault injection (copy of
ray_tpu/chaos/controller.py for the PyTorch port, trimmed to the points
the port has: the channel's reads and writes and the LLM engine's decode
step).

Every injection site calls ``maybe_inject(point, detail)``; with no
controller armed that is one global load and a ``None`` check. Each rule
owns a ``random.Random`` seeded from (global seed, rule index), so two runs
with the same seed and the same sequence of hits inject identically. Every
injection is stamped into the flight recorder (``chaos.inject``) before
the fault is applied and counted in ``raytpu_chaos_injections_total``.

Arming: ``RAY_TPU_CHAOS='[{"point": "serve.decode", "action": "raise"}]'``
in the environment (``RAY_TPU_CHAOS_SEED`` seeds the rules), or
``chaos.configure([...], seed=7)`` / ``chaos.disable()`` in-process.

Rule fields: ``point`` (see POINTS), ``action`` (``kill`` SIGKILLs the
process, ``raise``, ``delay`` sleeps ``delay_s``, ``drop`` swallows the
message), ``match`` (substring(s) the site's detail must contain),
``after`` (skip the first N matching hits), ``times`` (at most N fires,
-1 = unlimited), ``prob`` (per-hit probability from the rule's RNG).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import random
import threading
from typing import Any, Dict, List, Optional, Sequence, Union

from ..observability.flight_recorder import record as _flight_record

_log = logging.getLogger(__name__)

ENV_VAR = "RAY_TPU_CHAOS"
SEED_ENV = "RAY_TPU_CHAOS_SEED"

# The injection sites compiled into the runtime, with the actions each
# site actually implements. Kept as data so tests (and the README) can
# enumerate the fault surface; a typo'd point OR a point/action pair no
# site implements fails loudly at parse time — otherwise the rule would
# "fire" (counted, flight-recorded) while applying no fault, and a chaos
# campaign would validate nothing while its telemetry says it did.
POINT_ACTIONS = {
    "chan.write": ("delay", "drop", "raise"),  # core/channel.py writer
    "chan.read": ("delay", "raise"),          # core/channel.py reader
    # LLM engine decode loop (serve/llm/engine.py), once per decode step,
    # detail = deployment name. `kill` SIGKILLs the process mid-decode,
    # `raise` fails the step (the engine fails the batch fast), `delay`
    # stretches the step.
    "serve.decode": ("kill", "raise", "delay"),
}
POINTS = tuple(POINT_ACTIONS)

_ACTIONS = ("kill", "raise", "delay", "drop")
_DEFAULT_DELAY_S = 0.05


@dataclasses.dataclass
class ChaosRule:
    point: str
    action: str = "raise"
    # One substring, or a list of substrings that must ALL appear in the
    # site's detail string (e.g. ["train_step", "@0"] = that function's
    # first attempt only — rule counters are per-process, but an
    # attempt-qualified match is deterministic across any worker churn).
    match: Union[str, tuple] = ""
    after: int = 0
    times: int = 1
    prob: float = 1.0
    # None = the default 0.05 s; resolved in validate().
    delay_s: Optional[float] = None
    # Mutable per-process state (not part of the spec).
    hits: int = 0
    injected: int = 0
    rng: Optional[random.Random] = None

    def validate(self) -> "ChaosRule":
        if self.point not in POINTS:
            raise ValueError(
                f"unknown chaos point {self.point!r}; valid: {sorted(POINTS)}"
            )
        if self.action not in _ACTIONS:
            raise ValueError(
                f"unknown chaos action {self.action!r}; valid: {sorted(_ACTIONS)}"
            )
        if self.action not in POINT_ACTIONS[self.point]:
            raise ValueError(
                f"chaos point {self.point!r} does not implement action "
                f"{self.action!r}; it supports: "
                f"{sorted(POINT_ACTIONS[self.point])}"
            )
        if self.delay_s is None:
            self.delay_s = _DEFAULT_DELAY_S
        if isinstance(self.match, list):
            self.match = tuple(self.match)
        return self

    def matches(self, detail: str) -> bool:
        if not self.match:
            return True
        needles = (
            self.match if isinstance(self.match, tuple) else (self.match,)
        )
        return all(n in detail for n in needles)


def _parse_rules(spec: Union[str, dict, Sequence]) -> List[ChaosRule]:
    if isinstance(spec, str):
        spec = json.loads(spec)
    if isinstance(spec, dict):
        spec = [spec]
    rules = []
    for r in spec:
        if isinstance(r, ChaosRule):
            # Copy: the controller owns its rules' mutable state (hits/
            # injected/rng); appending the caller's instance by reference
            # would make two controllers built from one rule list clobber
            # each other's counters and seeds.
            rules.append(dataclasses.replace(r).validate())
            continue
        known = {f.name for f in dataclasses.fields(ChaosRule)}
        extra = set(r) - known
        if extra:
            raise ValueError(f"unknown chaos rule field(s) {sorted(extra)}")
        rules.append(ChaosRule(**r).validate())
    return rules


class ChaosController:
    """One process's armed rule set. Decisions are serialized under a
    lock — injection points are never so hot that contention matters
    (the disabled path doesn't reach here at all)."""

    def __init__(self, rules: Union[str, dict, Sequence], seed: int = 0):
        self.seed = int(seed)
        self.rules: List[ChaosRule] = _parse_rules(rules)
        self._by_point: Dict[str, List[ChaosRule]] = {}
        import zlib

        for i, rule in enumerate(self.rules):
            # Independent deterministic stream per rule: adding a rule
            # never perturbs another rule's decisions. crc32 (not hash():
            # str hashing is salted per process) keeps the stream
            # identical across every worker/daemon process.
            rule.rng = random.Random(
                (self.seed << 32) ^ (i << 16) ^ zlib.crc32(rule.point.encode())
            )
            rule.hits = 0
            rule.injected = 0
            self._by_point.setdefault(rule.point, []).append(rule)
        self._lock = threading.Lock()

    @classmethod
    def from_env(cls) -> Optional["ChaosController"]:
        spec = os.environ.get(ENV_VAR)
        if not spec:
            return None
        seed = int(os.environ.get(SEED_ENV, "0") or 0)
        return cls(_parse_rules(spec), seed=seed)

    def maybe_inject(self, point: str, detail: str = "") -> Optional[ChaosRule]:
        rules = self._by_point.get(point)
        if not rules:
            return None
        with self._lock:
            for rule in rules:
                if not rule.matches(detail):
                    continue
                rule.hits += 1
                if rule.hits <= rule.after:
                    continue
                if rule.times >= 0 and rule.injected >= rule.times:
                    continue
                if rule.prob < 1.0 and rule.rng.random() >= rule.prob:
                    continue
                rule.injected += 1
                self._stamp(point, rule, detail)
                return rule
        return None

    @staticmethod
    def _stamp(point: str, rule: ChaosRule, detail: str) -> None:
        # Cause before symptom: the flight record lands before the fault
        # is applied.
        _flight_record("chaos.inject", (point, rule.action, detail))
        from ..utils import internal_metrics as imet

        imet.CHAOS_INJECTIONS.inc(point=point, action=rule.action)
        _log.warning("injecting %s at %s (%s)", rule.action, point, detail)

    def stats(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [
                {
                    "point": r.point,
                    "action": r.action,
                    "match": r.match,
                    "hits": r.hits,
                    "injected": r.injected,
                }
                for r in self.rules
            ]


# ------------------------------------------------------------- module API
# The controller is parsed from the environment once, at import: import
# cost is one getenv when unarmed.
_controller: Optional[ChaosController] = ChaosController.from_env()


def enabled() -> bool:
    return _controller is not None


def controller() -> Optional[ChaosController]:
    return _controller


def configure(
    rules: Union[str, dict, Sequence], seed: Optional[int] = None
) -> ChaosController:
    """Arms THIS process programmatically (tests)."""
    global _controller
    if seed is None:
        seed = int(os.environ.get(SEED_ENV, "0") or 0)
    _controller = ChaosController(rules, seed=seed)
    return _controller


def disable() -> None:
    global _controller
    _controller = None


def maybe_inject(point: str, detail: str = "") -> Optional[ChaosRule]:
    """The hot-path entry every injection site calls. Disabled cost: one
    global load + None check. Returns the fired rule (the site applies
    its action) or None."""
    c = _controller
    if c is None:
        return None
    return c.maybe_inject(point, detail)


def kill_now(point: str, detail: str = "") -> None:
    """Applies a `kill` action: SIGKILL this process, with no atexit and no
    graceful teardown, as an OOM kill would."""
    import signal

    os.kill(os.getpid(), signal.SIGKILL)
