"""ray_tpu_torch.train: the training state below the trainer, the
counterpart of the parts of ray_tpu.train that need no runtime.

backend: torch.distributed rendezvous (NCCL on GPUs, gloo on the CPU);
zero: ZeRO-1, the AdamW state sharded over a process group;
checkpoint: Checkpoint, CheckpointManager, StorageContext, pytree and
  optimizer-state files;
elastic_checkpoint: world-size-independent checkpoints in the JAX package's
  format (each reads the other's);
hf_checkpoint: HF safetensors in and out of the param tree.
The trainer, its session, worker group and config wait for the port of the
runtime.
"""

from . import elastic_checkpoint, hf_checkpoint, zero
from .backend import TorchBackendConfig, coordinator_address, free_port, setup_torch_distributed
from .checkpoint import (Checkpoint, CheckpointManager, StorageContext, load_aux_state,
                         load_pytree, save_aux_state, save_pytree)
from .hf_checkpoint import export_hf_checkpoint, load_hf_checkpoint

__all__ = [
    "Checkpoint", "CheckpointManager", "StorageContext", "TorchBackendConfig",
    "coordinator_address", "elastic_checkpoint", "export_hf_checkpoint", "free_port",
    "hf_checkpoint", "load_aux_state", "load_hf_checkpoint", "load_pytree", "save_aux_state",
    "save_pytree", "setup_torch_distributed", "zero",
]
