"""Cluster resource model (copy of ray_tpu/core/resources.py for the
PyTorch port).

Quantities are fixed-point integers (1/10000 granularity), so fractional
resources round-trip without float drift. The JAX package detects TPU
chips through its accelerator registry and carries a TpuSliceSpec per
node for slice-gang leases; the port counts CPUs and CUDA devices
(`GPU`), and has no slice topology.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

PRECISION = 10000

CPU = "CPU"
TPU = "TPU"  # accepted for API parity; never detected
GPU = "GPU"
MEMORY = "memory"
OBJECT_STORE_MEMORY = "object_store_memory"

_IMPLICIT_PREFIX = "node:"


def to_fixed(v: float) -> int:
    return round(v * PRECISION)


def from_fixed(v: int) -> float:
    return v / PRECISION


class ResourceSet:
    """A bag of named resource quantities (fixed-point internally)."""

    __slots__ = ("_map",)

    def __init__(self, resources: Optional[Dict[str, float]] = None):
        self._map: Dict[str, int] = {}
        for k, v in (resources or {}).items():
            if v < 0:
                raise ValueError(f"negative resource {k}={v}")
            fx = to_fixed(v)
            if fx > 0:
                self._map[k] = fx

    @classmethod
    def _from_fixed_map(cls, m: Dict[str, int]) -> "ResourceSet":
        rs = cls()
        rs._map = {k: v for k, v in m.items() if v > 0}
        return rs

    def to_dict(self) -> Dict[str, float]:
        return {k: from_fixed(v) for k, v in self._map.items()}

    def get(self, name: str) -> float:
        return from_fixed(self._map.get(name, 0))

    def is_empty(self) -> bool:
        return not self._map

    def is_subset_of(self, other: "ResourceSet") -> bool:
        return all(other._map.get(k, 0) >= v for k, v in self._map.items())

    def __add__(self, other: "ResourceSet") -> "ResourceSet":
        m = dict(self._map)
        for k, v in other._map.items():
            m[k] = m.get(k, 0) + v
        return ResourceSet._from_fixed_map(m)

    def __sub__(self, other: "ResourceSet") -> "ResourceSet":
        m = dict(self._map)
        for k, v in other._map.items():
            m[k] = m.get(k, 0) - v
            if m[k] < 0:
                raise ValueError(f"resource {k} went negative")
        return ResourceSet._from_fixed_map(m)

    def __eq__(self, other):
        return isinstance(other, ResourceSet) and self._map == other._map

    def __repr__(self):
        return f"ResourceSet({self.to_dict()})"


@dataclass
class NodeResources:
    """Total + available resources of one node."""

    node_id: str
    total: ResourceSet
    available: ResourceSet
    labels: Dict[str, str] = field(default_factory=dict)

    def can_fit(self, request: ResourceSet) -> bool:
        return request.is_subset_of(self.available)

    def could_ever_fit(self, request: ResourceSet) -> bool:
        return request.is_subset_of(self.total)

    def acquire(self, request: ResourceSet) -> None:
        self.available = self.available - request

    def release(self, request: ResourceSet) -> None:
        self.available = self.available + request


def task_resources(
    num_cpus: Optional[float] = None,
    num_tpus: Optional[float] = None,
    num_gpus: Optional[float] = None,
    memory: Optional[float] = None,
    resources: Optional[Dict[str, float]] = None,
    default_num_cpus: float = 1.0,
) -> ResourceSet:
    """Builds the resource request for one task/actor invocation, mirroring
    the reference's option normalization (python/ray/_private/ray_option_utils.py)."""
    req: Dict[str, float] = dict(resources or {})
    req[CPU] = default_num_cpus if num_cpus is None else num_cpus
    if num_tpus:
        req[TPU] = num_tpus
    if num_gpus:
        req[GPU] = num_gpus
    if memory:
        req[MEMORY] = memory
    return ResourceSet(req)


def detect_node_resources(
    num_cpus: Optional[float] = None,
    num_gpus: Optional[float] = None,
    object_store_memory: Optional[int] = None,
) -> Dict[str, float]:
    """This host's resources: CPUs from os.cpu_count() and CUDA devices from
    torch.cuda.device_count() (the JAX package asks its TPU accelerator
    registry, ray_tpu/core/resources.py:160-185). Explicit num_cpus /
    num_gpus override detection for their resource, as num_tpus= does
    there."""
    import os

    import torch

    res: Dict[str, float] = {CPU: float(num_cpus if num_cpus is not None else os.cpu_count() or 1)}
    gpus = torch.cuda.device_count() if num_gpus is None else num_gpus
    if gpus:
        res[GPU] = float(gpus)
    if object_store_memory:
        res[OBJECT_STORE_MEMORY] = float(object_store_memory)
    return res
