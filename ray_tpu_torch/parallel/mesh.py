"""Mesh layout for the PyTorch port: the axis vocabulary and `MeshSpec` of
ray_tpu/parallel/mesh.py, and a device mesh without a process group.

Axis vocabulary (the framework standard, outermost first):

    "data"    - pure data parallelism (batch split, gradient all-reduce)
    "fsdp"    - sharded data parallelism (params/opt-state sharded)
    "stage"   - pipeline parallelism
    "expert"  - expert parallelism (MoE dispatch)
    "seq"     - sequence/context parallelism
    "tensor"  - tensor/model parallelism (weight matrices split)

`build_mesh` returns a `Mesh`: the axis names, their resolved sizes and a
numpy object array of `torch.device`s shaped by AXIS_ORDER, so
`mesh.devices.size` reads as it does on a `jax.sharding.Mesh`. Its devices
are the CUDA devices, or the CPU when the caller asks for it. DeviceMesh
placements, sharding rules and collectives come with the parallel layer.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

import numpy as np
import torch

# Canonical axis order: outermost (slowest-varying, cheapest link) first.
AXIS_ORDER = ("data", "fsdp", "stage", "expert", "seq", "tensor")


def default_devices(use_gpu: bool = True) -> List[torch.device]:
    """Every CUDA device of this process, or the one CPU device with
    use_gpu=False. use_gpu=True without a CUDA device raises: the port never
    falls back to the CPU on its own."""
    if not use_gpu:
        return [torch.device("cpu")]
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: ray_tpu_torch trains on the GPU unless the caller asks for the "
            "CPU (ScalingConfig(use_gpu=False))"
        )
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Logical parallelism layout: axis name -> size.

    Sizes of -1 mean "absorb remaining devices" (at most one axis may be -1).
    Axes of size 1 are kept in the mesh so a layout written for many devices
    runs unchanged on one.
    """

    data: int = -1
    fsdp: int = 1
    stage: int = 1
    tensor: int = 1
    seq: int = 1
    expert: int = 1

    def resolve(self, n_devices: int) -> Dict[str, int]:
        sizes = {
            "data": self.data,
            "fsdp": self.fsdp,
            "stage": self.stage,
            "expert": self.expert,
            "seq": self.seq,
            "tensor": self.tensor,
        }
        wild = [k for k, v in sizes.items() if v == -1]
        if len(wild) > 1:
            raise ValueError(f"at most one mesh axis may be -1, got {wild}")
        fixed = math.prod(v for v in sizes.values() if v != -1)
        if wild:
            if n_devices % fixed:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed axes product {fixed}"
                )
            sizes[wild[0]] = n_devices // fixed
        if math.prod(sizes.values()) != n_devices:
            raise ValueError(
                f"mesh {sizes} needs {math.prod(sizes.values())} devices, have {n_devices}"
            )
        return {k: sizes[k] for k in AXIS_ORDER}


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Devices laid out over named axes: `devices[i_data, ..., i_tensor]`."""

    axis_names: tuple
    axis_sizes: Dict[str, int]
    devices: np.ndarray


def build_mesh(axis_sizes: Optional[Dict[str, int]] = None, *, use_gpu: bool = True) -> Mesh:
    """A Mesh over `default_devices(use_gpu)`, sized by `axis_sizes` (axes
    not named are 1) or, without them, all devices on "data"."""
    devices = default_devices(use_gpu)
    if axis_sizes is None:
        axis_sizes = MeshSpec().resolve(len(devices))
    else:
        axis_sizes = {k: axis_sizes.get(k, 1) for k in AXIS_ORDER}
        if math.prod(axis_sizes.values()) != len(devices):
            raise ValueError(f"axis sizes {axis_sizes} do not cover {len(devices)} devices")
    arr = np.empty(len(devices), dtype=object)
    arr[:] = devices
    return Mesh(AXIS_ORDER, dict(axis_sizes),
                arr.reshape(tuple(axis_sizes[a] for a in AXIS_ORDER)))
