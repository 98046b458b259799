"""ray_tpu_torch.accelerators: accelerator detection, visibility and
provisioning (the port of ray_tpu/accelerators/__init__.py, accelerator.py,
cpu.py and node_provider.py, with a GPU manager in place of the TPU one).

The registry half of the reference's accelerator package (reference:
python/ray/_private/accelerators/__init__.py
get_accelerator_manager_for_resource): the built-in families are CPU and
GPU; `register_accelerator_manager` adds or replaces one (tests swap in a
manager with a fake device count). The node-provider half
(node_provider.py) is what the autoscalers drive: `LocalNodeProvider`
starts labelled raylets on this machine. A GPU host's slice is its NVLink
domain (gpu.py `detect_slice_spec`), which SLICE_GANG places gangs on. The
JAX package's GCE TPU-VM provider talks to a TPU VM's metadata server and
the Cloud TPU API, and stays TPU-only. Nothing here imports torch at
import time.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from .accelerator import AcceleratorManager
from .cpu import CpuAcceleratorManager
from .gpu import CUDA_VISIBLE_DEVICES_ENV, GpuAcceleratorManager
from .node_provider import LocalNodeProvider, NodeProvider

__all__ = [
    "AcceleratorManager",
    "CUDA_VISIBLE_DEVICES_ENV",
    "CpuAcceleratorManager",
    "GpuAcceleratorManager",
    "LocalNodeProvider",
    "NodeProvider",
    "all_accelerator_managers",
    "detect_accelerators",
    "get_accelerator_manager",
    "register_accelerator_manager",
]

_registry: Dict[str, AcceleratorManager] = {}


def register_accelerator_manager(manager: AcceleratorManager, override: bool = False) -> None:
    """Registers a manager under its resource name; `override` replaces a
    built-in."""
    name = manager.get_resource_name()
    if name in _registry and not override:
        raise ValueError(f"accelerator manager for {name!r} already registered")
    _registry[name] = manager


def _ensure_builtin() -> None:
    if "CPU" not in _registry:
        _registry["CPU"] = CpuAcceleratorManager()
    if "GPU" not in _registry:
        _registry["GPU"] = GpuAcceleratorManager()


def get_accelerator_manager(resource_name: str) -> Optional[AcceleratorManager]:
    _ensure_builtin()
    return _registry.get(resource_name)


def all_accelerator_managers() -> List[AcceleratorManager]:
    _ensure_builtin()
    return list(_registry.values())


def detect_accelerators() -> Dict[str, float]:
    """resource name -> detected count for every family present on this
    host (CPU excluded: callers own the CPU default and override)."""
    out: Dict[str, float] = {}
    for mgr in all_accelerator_managers():
        name = mgr.get_resource_name()
        if name == "CPU":
            continue
        try:
            n = mgr.get_current_node_num_accelerators()
        except Exception:  # noqa: BLE001 - a family that cannot probe has none here
            n = 0
        if n:
            out[name] = float(n)
    return out
