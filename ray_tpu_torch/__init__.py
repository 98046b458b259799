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
checkpoints), the trainer (train.TorchTrainer, train.report) and Tune
(tune.Tuner), and the cluster runtime on one machine (`init()`: a GCS, a
raylet and worker processes over a shared-memory store, with CUDA devices
leased to workers through CUDA_VISIBLE_DEVICES), with spill to disk,
`broadcast`, runtime envs, out-of-band collective groups (collective), DAG
authoring (dag) and compiled graphs (cgraph), and its operator surface
(utils: the state API with metrics history and SLO alerts, metrics, pubsub;
observability: logs, flight dumps, incidents, the watchdog), Data
(data: lazy datasets with streaming execution, fed to TorchTrainer's
`datasets=` and to Serve's FeatureTable), and the operator's tools: node
labels and `init(address=<session dir> | "auto")`, jobs, the dashboard,
the command line (`python -m ray_tpu_torch.scripts`), the v1 and v2
autoscalers over accelerators.LocalNodeProvider, the lock-order detector
(utils.lock_order) and the device glue (utils.profiling over
torch.profiler, the reporter's device-memory gauge), and RL (rl: RLModule,
the learner on the card, env runners on the port's own CartPole and
Pendulum, PPO, IMPALA/APPO, DQN, SAC, CQL, offline and multi-agent).

Subpackages that need torch load on first use (PEP 562 `__getattr__`), so
that the cluster's daemons (`python -m ray_tpu_torch.core.gcs`, `...raylet`)
start without importing torch.
"""

from ._version import version as __version__  # noqa: F401
from . import exceptions  # noqa: F401
from .api import (  # noqa: F401
    ObjectRef,
    available_resources,
    broadcast,
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

_LAZY_SUBMODULES = ("train", "tune", "serve", "models", "ops", "parallel", "air",
                    "observability", "collective", "dag", "cgraph", "data", "rl")


def __getattr__(name):
    if name in _LAZY_SUBMODULES:
        import importlib

        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

__all__ = [
    "BackpressureError",
    "KVPoolExhaustedError",
    "NodeAffinitySchedulingStrategy",
    "ObjectRef",
    "PlacementGroupSchedulingStrategy",
    "RayTpuError",
    "available_resources",
    "broadcast",
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
