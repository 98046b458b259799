"""Goodput accounting and MFU helpers (copy of
ray_tpu/observability/goodput.py for the PyTorch port).

goodput = productive step time / total wall time, with everything the run
did that did NOT advance the model (setup, checkpoint persists, drain
waits after a preemption notice, recomputing steps lost since the last
checkpoint) accounted explicitly.

`GoodputAccountant` is a segment clock: the supervisor (TorchTrainer.fit)
switches it between categories as the run moves through its lifecycle —
setup -> productive -> (checkpoint persist) -> productive -> restart_rework
on the restored attempt until the first fresh step lands -> productive
again. `fraction()` is the goodput number the result metrics carry.

MFU: `peak_flops()` resolves this process's peak FLOP/s (env
RAY_TPU_PEAK_FLOPS override, else the per-device spec table by CUDA device
name x device count, None when CUDA is not initialized), so
`mfu(tokens_per_s, flops_per_token)` turns a reported throughput into
model-FLOPs utilization using `models/transformer.py:flops_per_token`.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Dict, Optional

SETUP = "setup"
PRODUCTIVE = "productive"
CHECKPOINT = "checkpoint"
DRAIN_WAIT = "drain_wait"
RESTART_REWORK = "restart_rework"
# Elastic runs: steps ARE advancing but the gang is below its target
# world size. Weighted into goodput by world/target.
DEGRADED = "degraded"

CATEGORIES = (SETUP, PRODUCTIVE, CHECKPOINT, DRAIN_WAIT, RESTART_REWORK, DEGRADED)

# Dense bf16 tensor-core FLOP/s per device by name (NVIDIA's data sheet,
# H100 SXM; the peak chip_smoke.py's MFU uses).
PEAK_FLOPS_PER_DEVICE = {
    "H100": 989e12,
}


class GoodputAccountant:
    """Wall-clock ledger over the run's lifecycle categories. Not
    thread-safe by design: exactly one supervisor drives it."""

    def __init__(self, clock: Callable[[], float] = time.monotonic):
        self._clock = clock
        self._category: Optional[str] = None
        self._since: float = 0.0
        self.seconds: Dict[str, float] = {c: 0.0 for c in CATEGORIES}
        # Category -> goodput weight. PRODUCTIVE counts 1.0; DEGRADED is
        # set by the supervisor to world/target when it downsizes.
        self._weights: Dict[str, float] = {PRODUCTIVE: 1.0}

    def set_weight(self, category: str, weight: float) -> None:
        """Credit `category` seconds at `weight` (0..1) in fraction()."""
        if category not in self.seconds:
            raise ValueError(f"unknown goodput category {category!r}")
        self._weights[category] = max(0.0, min(1.0, float(weight)))

    @property
    def category(self) -> Optional[str]:
        return self._category

    def begin(self, category: str) -> None:
        """Close the running segment and start `category`."""
        if category not in self.seconds:
            raise ValueError(f"unknown goodput category {category!r}")
        now = self._clock()
        if self._category is not None:
            self.seconds[self._category] += now - self._since
        self._category = category
        self._since = now

    def finish(self) -> None:
        """Close the running segment (end of run)."""
        if self._category is not None:
            self.seconds[self._category] += self._clock() - self._since
            self._category = None

    def total(self) -> float:
        extra = self._clock() - self._since if self._category else 0.0
        return sum(self.seconds.values()) + extra

    def fraction(self) -> float:
        """Weighted productive time / total (PRODUCTIVE at 1.0, DEGRADED
        at its world/target weight); 1.0 for a run too short to have
        history."""
        total = self.total()
        if total <= 0:
            return 1.0
        seconds = dict(self.seconds)
        if self._category is not None:
            seconds[self._category] += self._clock() - self._since
        productive = sum(
            seconds[c] * w for c, w in self._weights.items() if w > 0
        )
        return productive / total

    def snapshot(self) -> Dict[str, object]:
        """Breakdown with the in-flight segment included."""
        seconds = dict(self.seconds)
        if self._category is not None:
            seconds[self._category] += self._clock() - self._since
        return {
            "goodput": self.fraction(),
            "seconds": {k: round(v, 4) for k, v in seconds.items()},
        }


def peak_flops() -> Optional[float]:
    """This process's peak FLOP/s: RAY_TPU_PEAK_FLOPS wins; otherwise the
    per-device spec x CUDA device count, but ONLY when CUDA is already
    initialized in this process (asking earlier would initialize it from
    processes that never use the GPU). None = unknown, skip MFU."""
    env = os.environ.get("RAY_TPU_PEAK_FLOPS")
    if env:
        try:
            return float(env)
        except ValueError:
            pass
    import torch

    if not torch.cuda.is_initialized():
        return None
    total = 0.0
    for i in range(torch.cuda.device_count()):
        name = torch.cuda.get_device_name(i)
        for key, val in PEAK_FLOPS_PER_DEVICE.items():
            if key in name:
                total += val
                break
    return total or None


def mfu(
    tokens_per_s: float,
    flops_per_token: float,
    peak_flops_per_s: Optional[float] = None,
) -> Optional[float]:
    """Model-FLOPs utilization; None when the peak is unknown (an MFU
    against a made-up denominator is worse than no MFU)."""
    peak = peak_flops_per_s if peak_flops_per_s is not None else peak_flops()
    if not peak or peak <= 0:
        return None
    return tokens_per_s * flops_per_token / peak
