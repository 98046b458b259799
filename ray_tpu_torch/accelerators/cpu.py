"""CpuAcceleratorManager: the always-available family (the port of
ray_tpu/accelerators/cpu.py).

CPU rides the same registry as the GPU family, so node resource detection
has one path: ask each registered manager for its count.
"""

from __future__ import annotations

import os
from typing import Optional

from .accelerator import AcceleratorManager


class CpuAcceleratorManager(AcceleratorManager):
    def get_resource_name(self) -> str:
        return "CPU"

    def get_visible_accelerator_ids_env_var(self) -> Optional[str]:
        return None  # CPU affinity is the OS scheduler's job, not an env var

    def get_current_node_num_accelerators(self) -> int:
        return os.cpu_count() or 1

    def validate_resource_request_quantity(self, quantity: float):
        return True, None  # fractional CPUs are fine (timesharing)
