"""ray_tpu_torch.train: training orchestration and the training state, the
counterpart of ray_tpu.train.

TorchTrainer (for the JAX package's JaxTrainer) runs the user's loop in a
worker actor's thread over a mesh of the process's CUDA devices, on the
in-process runtime (`init(local_mode=True)`); inside the loop, report /
get_checkpoint / phase / configure_telemetry / get_context / get_mesh work
as in the JAX package.

backend: torch.distributed rendezvous (NCCL on GPUs, gloo on the CPU);
zero: ZeRO-1, the AdamW state sharded over a process group;
checkpoint: Checkpoint, CheckpointManager, StorageContext, pytree and
  optimizer-state files;
elastic_checkpoint: world-size-independent checkpoints in the JAX package's
  format (each reads the other's);
hf_checkpoint: HF safetensors in and out of the param tree.
"""

from . import elastic_checkpoint, hf_checkpoint, zero
from .backend import TorchBackendConfig, coordinator_address, free_port, setup_torch_distributed
from .checkpoint import (Checkpoint, CheckpointManager, StorageContext, load_aux_state,
                         load_pytree, save_aux_state, save_pytree)
from .config import CheckpointConfig, FailureConfig, RunConfig, ScalingConfig
from .hf_checkpoint import export_hf_checkpoint, load_hf_checkpoint
from .session import (
    configure_telemetry,
    drain_requested,
    get_checkpoint,
    get_context,
    get_dataset_shard,
    get_session,
    phase,
    report,
)
from .trainer import Result, TorchTrainer
from .worker_group import WorkerGroup


def get_mesh():
    """The Mesh this worker participates in (set up by the trainer's backend
    phase; the analogue of fetching the torch process group, reference:
    train/torch/config.py)."""
    s = get_session()
    return getattr(s, "mesh", None) if s else None


__all__ = [
    "Checkpoint", "CheckpointConfig", "CheckpointManager", "FailureConfig", "Result",
    "RunConfig", "ScalingConfig", "StorageContext", "TorchBackendConfig", "TorchTrainer",
    "WorkerGroup", "configure_telemetry", "coordinator_address", "drain_requested",
    "elastic_checkpoint", "export_hf_checkpoint", "free_port", "get_checkpoint",
    "get_context", "get_dataset_shard", "get_mesh", "get_session", "hf_checkpoint",
    "load_aux_state", "load_hf_checkpoint", "load_pytree", "phase", "report",
    "save_aux_state", "save_pytree", "setup_torch_distributed", "zero",
]
