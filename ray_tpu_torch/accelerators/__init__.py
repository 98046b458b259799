"""ray_tpu_torch.accelerators: accelerator detection and visibility (the
port of ray_tpu/accelerators/__init__.py and accelerator.py, with a GPU
manager in place of the TPU one).

The registry half of the reference's accelerator package (reference:
python/ray/_private/accelerators/__init__.py
get_accelerator_manager_for_resource). The built-in family is GPU;
`register_accelerator_manager` adds or replaces one (tests swap in a
manager with a fake device count). The JAX package's node-provider half
(autoscaling) is ROADMAP Queue 1 item 8. Nothing here imports torch at
import time.
"""

from __future__ import annotations

from typing import Dict, Optional

from .accelerator import AcceleratorManager
from .gpu import CUDA_VISIBLE_DEVICES_ENV, GpuAcceleratorManager

__all__ = [
    "AcceleratorManager",
    "CUDA_VISIBLE_DEVICES_ENV",
    "GpuAcceleratorManager",
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
    if "GPU" not in _registry:
        _registry["GPU"] = GpuAcceleratorManager()


def get_accelerator_manager(resource_name: str) -> Optional[AcceleratorManager]:
    _ensure_builtin()
    return _registry.get(resource_name)
