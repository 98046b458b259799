"""GpuAcceleratorManager: CUDA device detection and visibility, the GPU
counterpart of ray_tpu/accelerators/tpu.py.

Where the TPU manager reads chip device files and GCE metadata and hands a
worker TPU_VISIBLE_CHIPS, this one counts CUDA devices and hands a worker
CUDA_VISIBLE_DEVICES (reference: python/ray/_private/accelerators/nvidia_gpu.py).
Counting needs torch and happens only in the driver, which has it; the GCS
and the raylets never import torch and get the count passed in. An inherited
CUDA_VISIBLE_DEVICES restricts the ids a raylet may lease, as an inherited
TPU_VISIBLE_CHIPS does there. Ids are kept as strings: CUDA_VISIBLE_DEVICES
may name devices by index or by UUID.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, List, Mapping, Optional

from .accelerator import AcceleratorManager

CUDA_VISIBLE_DEVICES_ENV = "CUDA_VISIBLE_DEVICES"


def _torch_device_count() -> int:
    import torch

    return torch.cuda.device_count()


class GpuAcceleratorManager(AcceleratorManager):
    """`env` and `device_count` are injectable so tests can fake a GPU host
    on the CPU."""

    def __init__(self, env: Optional[Mapping[str, str]] = None,
                 device_count: Optional[Callable[[], int]] = None):
        self._env = os.environ if env is None else env
        self._device_count = device_count or _torch_device_count

    def get_resource_name(self) -> str:
        return "GPU"

    def get_visible_accelerator_ids_env_var(self) -> Optional[str]:
        return CUDA_VISIBLE_DEVICES_ENV

    def get_current_node_num_accelerators(self) -> int:
        """CUDA devices this process sees (CUDA_VISIBLE_DEVICES applied)."""
        try:
            return int(self._device_count())
        except Exception:  # noqa: BLE001 - no usable CUDA runtime: no GPUs
            return 0

    def get_current_process_visible_accelerator_ids(self) -> Optional[List[str]]:
        raw = self._env.get(CUDA_VISIBLE_DEVICES_ENV)
        if raw is None:
            return None
        return [p.strip() for p in raw.split(",") if p.strip() != ""]

    def visible_gpu_ids(self, total: int) -> List[str]:
        """The device ids a raylet may lease: the process's own restriction
        when set (a raylet inside a device lease subleases only those), else
        "0".."total-1"."""
        visible = self.get_current_process_visible_accelerator_ids()
        if visible is not None:
            return visible[: int(total)] if total else []
        return [str(i) for i in range(int(total))]

    def worker_visibility_env(self, ids: List[str], **extra) -> Dict[str, str]:
        """CUDA_VISIBLE_DEVICES naming exactly `ids`; an empty list hides
        every device (a worker that asked for no GPU creates no CUDA
        context)."""
        return {CUDA_VISIBLE_DEVICES_ENV: ",".join(str(i) for i in ids)}
