"""Mesh layout for the PyTorch port: the axis vocabulary and `MeshSpec` of
ray_tpu/parallel/mesh.py, a device mesh without a process group, and a
torch `DeviceMesh` over the process group.

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
are the CUDA devices, or the CPU when the caller asks for it; the trainer's
worker reads its device from it.

`build_device_mesh` is the counterpart of the JAX `build_mesh` for the
parallel layer: a `torch.distributed.device_mesh.DeviceMesh` over the ranks
of the default process group, one rank per device, with all six AXIS_ORDER
dims, size-1 dims kept. Each dim's process group is what the collectives,
the sharding rules, sequence and pipeline parallelism and ZeRO
(train/zero.py) run over. Where JAX's mesh holds every device of one SPMD
program, each rank of the port runs its own program and holds one
coordinate of the mesh.

A collective over several dims at once (JAX's psum over a tuple of axis
names: the gradient sum over ("data", "fsdp", "seq"), the MoE's token
groups) runs over `axes_group(mesh, axes)`: the ranks that share this
rank's coordinate on every other dim. `dist.new_group` must be called by
every rank, in the same order, for every group, so `build_device_mesh`
makes all of them up front, never lazily from a branch some ranks skip.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

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
class GpuTopology:
    """The physical description of a GPU slice (the hosts of one NVLink
    domain): the counterpart of the JAX package's TpuTopology. `mesh_shape`
    is () because NVSwitch joins every GPU of the domain to every other,
    where a TPU slice's chips sit on a torus; any logical mesh maps onto it
    alike."""

    generation: str = "cpu"  # "h100", "b200", ...; the device type off a card
    gpus_per_host: int = 1
    num_hosts: int = 1
    mesh_shape: Tuple[int, ...] = ()

    @property
    def num_gpus(self) -> int:
        return self.gpus_per_host * self.num_hosts

    @staticmethod
    def detect(use_gpu: bool = True, *, slice_spec=None,
               device_names: Optional[Sequence[str]] = None) -> "GpuTopology":
        """This host's slice: its CUDA devices (the generation from their
        name), the domain's host count from its GpuSliceSpec (read by
        accelerators/gpu.py `detect_slice_spec` unless given, which says 1:
        the fabric does not count a domain's hosts). With
        use_gpu=False, the one CPU device. `device_names` stands in for the
        CUDA devices' names (a host without a card, in tests)."""
        from ..accelerators.gpu import GpuAcceleratorManager, gpu_generation

        if device_names is None:
            devs = default_devices(use_gpu)
            if devs[0].type != "cuda":
                return GpuTopology(generation=devs[0].type, gpus_per_host=len(devs))
            device_names = [torch.cuda.get_device_name(d) for d in devs]
        if slice_spec is None:
            slice_spec = GpuAcceleratorManager().detect_slice_spec(len(device_names))
        return GpuTopology(generation=gpu_generation(device_names[0]),
                           gpus_per_host=len(device_names),
                           num_hosts=max(1, int(slice_spec.hosts_per_slice)))


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
    axis_sizes = _axis_sizes(axis_sizes, None, len(devices))
    arr = np.empty(len(devices), dtype=object)
    arr[:] = devices
    return Mesh(AXIS_ORDER, dict(axis_sizes),
                arr.reshape(tuple(axis_sizes[a] for a in AXIS_ORDER)))


class PartitionSpec(tuple):
    """jax.sharding.PartitionSpec's counterpart: one entry per tensor dim,
    each None (replicated), a mesh axis name, or a tuple of axis names
    (the dim split over their product, the first axis major)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


def _axis_sizes(axis_sizes: Optional[Dict[str, int]], spec: Optional[MeshSpec],
                n: int) -> Dict[str, int]:
    if axis_sizes is None:
        return (spec or MeshSpec()).resolve(n)
    sizes = {k: axis_sizes.get(k, 1) for k in AXIS_ORDER}
    if math.prod(sizes.values()) != n:
        raise ValueError(f"axis sizes {sizes} do not cover {n} devices")
    return sizes


def build_device_mesh(spec: Optional[MeshSpec] = None, *,
                      axis_sizes: Optional[Dict[str, int]] = None,
                      device_type: Optional[str] = None):
    """A DeviceMesh over every rank of the default process group (which
    must be initialised, e.g. by train.setup_torch_distributed), shaped by
    `spec` (MeshSpec().resolve: "data" absorbs the world) or `axis_sizes`
    (axes not named are 1), with dims named AXIS_ORDER. Rank r sits at the
    row-major coordinate r, so "tensor" neighbours are adjacent ranks.

    Its device type is "cuda" under NCCL, and under gloo where the process
    has a card (ranks sharing one GPU: DTensors keep their shards on it,
    and the port's collectives stage them through host memory); "cpu"
    otherwise; `device_type` ("cuda" or "cpu") sets it instead. It also
    makes every group over several of its dims (`axes_group`), on every rank
    in one order."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("build_device_mesh needs an initialised process group "
                           "(train.setup_torch_distributed)")
    sizes = _axis_sizes(axis_sizes, spec, dist.get_world_size())
    if device_type is None:
        cuda = dist.get_backend() == "nccl" or torch.cuda.is_available()
        device_type = "cuda" if cuda else "cpu"
    mesh = init_device_mesh(device_type, tuple(sizes[a] for a in AXIS_ORDER),
                            mesh_dim_names=AXIS_ORDER)
    mesh._axes_groups = _make_axes_groups(mesh)
    return mesh


def _split_axes(mesh, axes: Sequence[str]) -> tuple:
    """The dims of `axes` larger than 1, in AXIS_ORDER."""
    sizes = mesh_shape(mesh)
    unknown = set(axes) - set(sizes)
    if unknown:
        raise ValueError(f"mesh has no axis {sorted(unknown)}; axes: {tuple(sizes)}")
    return tuple(a for a in AXIS_ORDER if a in axes and sizes[a] > 1)


def _make_axes_groups(mesh) -> Dict[tuple, object]:
    """This rank's group for every set of two or more dims larger than 1 that
    leaves out another such dim (the set of all of them is the world).
    Every rank creates every group, in the order of itertools.combinations
    over AXIS_ORDER, as dist.new_group requires."""
    split = _split_axes(mesh, AXIS_ORDER)
    ranks = mesh.mesh  # [*sizes] global ranks, row-major
    me = dist.get_rank()
    groups = {}
    for k in range(2, len(split)):
        for axes in itertools.combinations(split, k):
            inner = [AXIS_ORDER.index(a) for a in axes]
            outer = [i for i in range(len(AXIS_ORDER)) if i not in inner]
            rows = ranks.permute(outer + inner).reshape(-1, math.prod(ranks.shape[i]
                                                                       for i in inner))
            for row in rows.tolist():
                group = dist.new_group(row)
                if me in row:
                    groups[axes] = group
    return groups


def axes_group(mesh, axes: Union[str, Sequence[str]]):
    """The process group of the ranks that share this rank's coordinate on
    every dim of `mesh` but `axes` (one name or several): what a collective
    over those dims runs on. Its rank order is row-major over `axes` in
    AXIS_ORDER. A single dim larger than 1 is the DeviceMesh's own group;
    dims all of size 1 give the group of the first (this rank alone)."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    split = _split_axes(mesh, axes)
    if len(split) <= 1:
        return mesh.get_group(split[0] if split else axes[0])
    if split == _split_axes(mesh, AXIS_ORDER):
        return dist.group.WORLD
    groups = getattr(mesh, "_axes_groups", None)
    if groups is None:
        raise ValueError("a group over several mesh dims needs a mesh from build_device_mesh, "
                         "which makes those groups on every rank")
    return groups[split]


def single_device_mesh():
    """A DeviceMesh of a world of one rank (raises in a larger world, as
    the JAX function does with more than one device)."""
    return build_device_mesh(MeshSpec(data=1))


def mesh_shape(mesh) -> Dict[str, int]:
    """Axis name -> size, of a DeviceMesh or a `Mesh`."""
    if isinstance(mesh, Mesh):
        return dict(mesh.axis_sizes)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def placements(mesh, spec) -> tuple:
    """The DTensor placements (one per mesh dim) that lay a tensor out as
    `spec` does on a JAX mesh: Shard(d) on each mesh dim that tensor dim d
    names, Replicate() elsewhere."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry} is not in the mesh's axis order {names}")
        for i in idx:
            out[i] = Shard(dim)
    return tuple(out)


def named_sharding(mesh, *spec) -> tuple:
    """The placements of PartitionSpec(*spec) on `mesh` (jax's
    NamedSharding(mesh, PartitionSpec(*spec)))."""
    return placements(mesh, PartitionSpec(*spec))


def host_local_device_count(use_gpu: bool = True) -> int:
    """Devices this process sees: CUDA devices, or the one CPU device."""
    return len(default_devices(use_gpu))


def data_parallel_rank(mesh) -> int:
    """This rank's (data x fsdp) coordinate in `mesh`: which shard of the
    global batch it loads. Raises if this rank is not in the mesh: a default
    would make every rank load shard 0."""
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError(f"rank {dist.get_rank()} is not in the mesh; cannot determine its "
                         "data-parallel rank")
    c = dict(zip(mesh.mesh_dim_names, coord))
    return int(c["data"] * mesh_shape(mesh)["fsdp"] + c["fsdp"])
