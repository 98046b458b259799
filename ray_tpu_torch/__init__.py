"""ray_tpu_torch: the PyTorch/CUDA port of ray_tpu for NVIDIA Hopper GPUs.

It imports torch, numpy and the standard library, never jax and nothing of
the ray_tpu package. Entry points run on CUDA unless the caller passes
device="cpu". Ported so far: the in-process runtime (`init(local_mode=True)`,
tasks, actors, objects, placement groups), Serve with its LLM deployment
and channel feed (serve, serve.llm, core.channel), the LLM serving path
(serve.llm over models.transformer, with the flash-attention forward as a
CUDA kernel in ops), training (models.transformer.build_train_step, with
the flash backward kernels, remat and ZeRO-1), the training state in
train (torch.distributed set-up, ZeRO-1, elastic, pytree and HF
checkpoints), and on the in-process runtime the trainer
(train.TorchTrainer, train.report) and Tune (tune.Tuner).
"""

from . import exceptions  # noqa: F401
from .api import (  # noqa: F401
    ObjectRef,
    available_resources,
    cancel,
    cluster_resources,
    get,
    get_actor,
    get_runtime_context,
    init,
    is_initialized,
    kill,
    method,
    nodes,
    put,
    remote,
    shutdown,
    wait,
)
from .core.placement_group import (  # noqa: F401
    NodeAffinitySchedulingStrategy,
    PlacementGroupSchedulingStrategy,
    placement_group,
    remove_placement_group,
)
from .exceptions import BackpressureError, KVPoolExhaustedError, RayTpuError  # noqa: F401
from . import train, tune  # noqa: F401,E402  (after api: both build on it)

__all__ = [
    "BackpressureError",
    "KVPoolExhaustedError",
    "NodeAffinitySchedulingStrategy",
    "ObjectRef",
    "PlacementGroupSchedulingStrategy",
    "RayTpuError",
    "available_resources",
    "cancel",
    "cluster_resources",
    "exceptions",
    "get",
    "get_actor",
    "get_runtime_context",
    "init",
    "is_initialized",
    "kill",
    "method",
    "nodes",
    "placement_group",
    "put",
    "remote",
    "remove_placement_group",
    "shutdown",
    "train",
    "tune",
    "wait",
]
