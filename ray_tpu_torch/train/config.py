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

    `backend` (a TorchBackendConfig) is read on the cluster runtime: with it,
    or with num_workers > 1, every worker is a process that joins one
    torch.distributed group (NCCL on the card, gloo on the CPU) and builds
    its DeviceMesh from `mesh` over the whole world. The in-process runtime
    keeps each worker's local mesh, as the JAX package's does. On the
    cluster runtime with use_gpu=True, a worker whose resources_per_worker
    names no GPU asks for one whole GPU.

    `elastic`, `min_workers` and `capacity_wait_s` are read on the cluster
    runtime, after a preemption notice drained the gang: fit() waits up to
    `capacity_wait_s` (None: trainer.CAPACITY_WAIT_S) for capacity for
    num_workers workers; when the wait runs out, an elastic run re-forms at
    the largest feasible world >= min_workers and resumes from its last
    checkpoint (world-size independent), then grows back to num_workers at a
    checkpoint boundary once capacity returns; a run that is not elastic, or
    whose feasible world is below the floor, fails with
    CapacityTimeoutError. The in-process runtime has no nodes to lose: there
    the three are accepted and change nothing.
    """

    num_workers: int = 1
    use_gpu: bool = True
    mesh: MeshSpec = dataclasses.field(default_factory=MeshSpec)
    resources_per_worker: Optional[Dict[str, float]] = None
    placement_strategy: str = "PACK"
    backend: Optional[Any] = None
    elastic: bool = False
    min_workers: Optional[int] = None  # elastic floor; None -> 1
    capacity_wait_s: Optional[float] = None

    @property
    def total_workers(self) -> int:
        return max(1, self.num_workers)

    @property
    def elastic_floor(self) -> int:
        return max(1, self.min_workers if self.min_workers is not None else 1)


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
