"""Train/AIR config dataclasses (copy of ray_tpu/train/config.py for the
PyTorch port).

Mirrors the reference's ScalingConfig/RunConfig/FailureConfig/
CheckpointConfig surface (reference: python/ray/air/config.py).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Optional

from ..parallel.mesh import MeshSpec


@dataclasses.dataclass
class ScalingConfig:
    """How many workers and what mesh each training job uses (reference:
    python/ray/air/config.py ScalingConfig).

    `use_gpu` takes the place of the JAX package's `use_tpu` and decides the
    mesh's devices: every CUDA device of the process, or the CPU with
    use_gpu=False. use_gpu=True without a CUDA device makes fit() raise; it
    never trains on the CPU instead. The JAX package's `topology` names TPU
    slices and is left out.

    `backend`, `elastic`, `min_workers` and `capacity_wait_s` are accepted
    at their defaults so call sites port mechanically. Nothing reads them
    under the in-process runtime (no multi-host rendezvous, no preemption),
    so any other value raises NotImplementedError until the cluster runtime
    lands (ROADMAP Queue 1 item 3).
    """

    num_workers: int = 1
    use_gpu: bool = True
    mesh: MeshSpec = dataclasses.field(default_factory=MeshSpec)
    resources_per_worker: Optional[Dict[str, float]] = None
    placement_strategy: str = "PACK"
    backend: Optional[Any] = None
    elastic: bool = False
    min_workers: Optional[int] = None
    capacity_wait_s: Optional[float] = None

    def __post_init__(self):
        given = [name for name in _CLUSTER_ONLY if getattr(self, name) != _CLUSTER_ONLY[name]]
        if given:
            raise NotImplementedError(
                f"ScalingConfig({', '.join(given)}=...) takes effect only with the cluster "
                "runtime (ROADMAP Queue 1 item 3); the in-process runtime has no "
                "multi-host rendezvous and no preemption"
            )


# ScalingConfig fields that only the cluster runtime reads, with the one
# value the in-process runtime accepts.
_CLUSTER_ONLY = {"backend": None, "elastic": False, "min_workers": None,
                 "capacity_wait_s": None}


@dataclasses.dataclass
class FailureConfig:
    """(reference: python/ray/air/config.py FailureConfig)"""

    max_failures: int = 0


@dataclasses.dataclass
class CheckpointConfig:
    """Keep-K + score-attribute retention
    (reference: python/ray/air/config.py CheckpointConfig,
    python/ray/train/_internal/checkpoint_manager.py)."""

    num_to_keep: Optional[int] = None
    checkpoint_score_attribute: Optional[str] = None
    checkpoint_score_order: str = "max"


@dataclasses.dataclass
class RunConfig:
    """(reference: python/ray/air/config.py RunConfig)"""

    name: Optional[str] = None
    storage_path: Optional[str] = None
    failure_config: FailureConfig = dataclasses.field(default_factory=FailureConfig)
    checkpoint_config: CheckpointConfig = dataclasses.field(default_factory=CheckpointConfig)

    def resolved_storage_path(self) -> str:
        return self.storage_path or os.path.expanduser("~/ray_tpu_results")
