"""TorchBackendConfig: the torch.distributed rendezvous, the counterpart of
ray_tpu/train/backend.py.

Where every JAX worker calls `jax.distributed.initialize` and then runs one
SPMD program across hosts, every worker of the port joins one
torch.distributed process group: NCCL between CUDA devices, gloo on the CPU
(how the tests run a world of several ranks on one machine). Nothing on a
machine announces a cluster, so the caller passes the coordinator's address,
the world size and the rank.
"""

from __future__ import annotations

import dataclasses
import datetime
import socket
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist


@dataclasses.dataclass
class TorchBackendConfig:
    """backend: None = NCCL where the process has a CUDA device, else gloo.
    coordinator_host: rank 0's host; None = loopback (one machine).
    coordinator_port: None = a free port picked on this machine.
    init_timeout_s: rendezvous timeout."""

    backend: Optional[str] = None
    coordinator_host: Optional[str] = None
    coordinator_port: Optional[int] = None
    init_timeout_s: float = 60.0


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def coordinator_address(cfg: TorchBackendConfig) -> str:
    host = cfg.coordinator_host or "127.0.0.1"
    port = cfg.coordinator_port or free_port()
    return f"{host}:{port}"


def setup_torch_distributed(
    rank: int,
    world_size: int,
    coordinator: str,
    backend: Optional[str] = None,
    init_timeout_s: float = 60.0,
) -> Dict[str, Any]:
    """Joins this process to the default process group as `rank` of
    `world_size`. `coordinator` is "host:port" (a TCP store that rank 0
    opens) or an init-method URL ("tcp://...", "file://..."). A world of one
    initialises a real group too. Under NCCL each rank takes the CUDA device
    `rank % device_count` as its current device. Returns the JAX function's
    dict: process_index, process_count, local_devices, global_devices (one
    device per process)."""
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    kwargs = {}
    if backend == "nccl":
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
        kwargs["device_id"] = device
    url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group(
        backend, init_method=url, world_size=world_size, rank=rank,
        timeout=datetime.timedelta(seconds=init_timeout_s), **kwargs,
    )
    return {
        "process_index": dist.get_rank(),
        "process_count": dist.get_world_size(),
        "local_devices": 1,
        "global_devices": dist.get_world_size(),
    }
