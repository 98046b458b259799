"""GpuAcceleratorManager: CUDA device detection and visibility, the GPU
counterpart of ray_tpu/accelerators/tpu.py.

Where the TPU manager reads chip device files and GCE metadata and hands a
worker TPU_VISIBLE_CHIPS, this one counts CUDA devices and hands a worker
CUDA_VISIBLE_DEVICES (reference: python/ray/_private/accelerators/nvidia_gpu.py).
Counting needs torch and happens only in the driver, which has it; the GCS
and the raylets never import torch and get the count passed in. An inherited
CUDA_VISIBLE_DEVICES restricts the ids a raylet may lease, as an inherited
TPU_VISIBLE_CHIPS does there. Ids are kept as strings: CUDA_VISIBLE_DEVICES
may name devices by index or by UUID.

Slices. Where the TPU manager reads a host's slice from GCE metadata, a GPU
host's slice is its NVLink domain: `detect_slice_spec` reads the fabric's
cluster UUID and clique id from `nvidia-smi -q` (an NVL72 rack's hosts share
them), else the host is a one-host domain named after itself (an HGX board's
GPUs meet on its own NVSwitches). Both inputs are injectable, and nothing
here reaches the network. A worker leased a bundle on a slice host gets the
slice's identity beside its devices: RAY_TPU_SLICE_NAME and
RAY_TPU_SLICE_WORKER_ID, the counterparts of TPU_SLICE_NAME and
TPU_WORKER_ID.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import socket
import subprocess
from typing import Callable, Dict, List, Mapping, Optional

from .accelerator import AcceleratorManager

CUDA_VISIBLE_DEVICES_ENV = "CUDA_VISIBLE_DEVICES"
SLICE_NAME_ENV = "RAY_TPU_SLICE_NAME"
SLICE_WORKER_ID_ENV = "RAY_TPU_SLICE_WORKER_ID"

# Device names -> generation, most specific first.
_GENERATIONS = (("gb200", "gb200"), ("b200", "b200"), ("h200", "h200"), ("h100", "h100"),
                ("h800", "h800"), ("a100", "a100"), ("a800", "a800"), ("l40", "l40"),
                ("v100", "v100"))


def gpu_generation(device_name: str) -> str:
    """"h100" for "NVIDIA H100 80GB HBM3", and so on; the name lowercased
    without spaces where no generation matches."""
    low = device_name.lower()
    for key, gen in _GENERATIONS:
        if key in low:
            return gen
    return low.replace(" ", "")


def _nvidia_smi_q() -> str:
    """`nvidia-smi -q`'s output; "" where the tool is missing or fails."""
    try:
        return subprocess.run(["nvidia-smi", "-q"], capture_output=True, text=True,
                              timeout=20.0, check=False).stdout
    except (OSError, subprocess.SubprocessError):
        return ""


def _fabric(report: str) -> Optional[str]:
    """The NVLink domain a `nvidia-smi -q` report names ("<cluster
    uuid>/<clique id>" of the first GPU whose fabric registration has
    one), or None (no fabric section, or N/A, or an all-zero uuid)."""
    uuid = clique = None
    in_fabric = False
    for line in report.splitlines():
        key, _, value = (p.strip() for p in line.partition(":"))
        if not value and key == "Fabric":
            in_fabric = True
            continue
        if not in_fabric:
            continue
        if not value:  # the next section
            in_fabric = False
        norm = key.replace(" ", "").lower()
        if norm == "clusteruuid":
            uuid = value
        elif norm == "cliqueid":
            clique = value
        if uuid is not None and clique is not None:
            break
    if not uuid or uuid.upper() == "N/A" or not re.sub(r"[0-]", "", uuid):
        return None
    return f"{uuid}/{clique}" if clique and clique.upper() != "N/A" else uuid


def _report_field(report: str, name: str) -> Optional[str]:
    for line in report.splitlines():
        key, _, value = (p.strip() for p in line.partition(":"))
        if key == name and value:
            return value
    return None


def _torch_device_count() -> int:
    import torch

    return torch.cuda.device_count()


class GpuAcceleratorManager(AcceleratorManager):
    """`env` and `device_count` are injectable so tests can fake a GPU host
    on the CPU."""

    def __init__(self, env: Optional[Mapping[str, str]] = None,
                 device_count: Optional[Callable[[], int]] = None,
                 smi: Optional[Callable[[], str]] = None,
                 hostname: Optional[Callable[[], str]] = None):
        self._env = os.environ if env is None else env
        self._device_count = device_count or _torch_device_count
        self._smi = smi or _nvidia_smi_q
        self._hostname = hostname or socket.gethostname

    def get_resource_name(self) -> str:
        return "GPU"

    def get_visible_accelerator_ids_env_var(self) -> Optional[str]:
        return CUDA_VISIBLE_DEVICES_ENV

    def get_current_node_num_accelerators(self) -> int:
        """CUDA devices this process sees (CUDA_VISIBLE_DEVICES applied)."""
        try:
            return int(self._device_count())
        except Exception:  # noqa: BLE001 - no usable CUDA runtime: no GPUs
            return 0

    def get_current_node_accelerator_type(self) -> Optional[str]:
        """The product name `nvidia-smi -q` reports ("NVIDIA H100 80GB
        HBM3"), or None where it reports none."""
        return _report_field(self._smi() or "", "Product Name")

    def get_current_process_visible_accelerator_ids(self) -> Optional[List[str]]:
        raw = self._env.get(CUDA_VISIBLE_DEVICES_ENV)
        if raw is None:
            return None
        return [p.strip() for p in raw.split(",") if p.strip() != ""]

    def visible_gpu_ids(self, total: int) -> List[str]:
        """The device ids a raylet may lease: the process's own restriction
        when set (a raylet inside a device lease subleases only those), else
        "0".."total-1"."""
        visible = self.get_current_process_visible_accelerator_ids()
        if visible is not None:
            return visible[: int(total)] if total else []
        return [str(i) for i in range(int(total))]

    def detect_slice_spec(self, num_gpus: int = 0, cache_dir: Optional[str] = None):
        """The GpuSliceSpec of the NVLink domain this host belongs to, which
        raylet registration folds into node labels (SLICE_GANG reads them).
        The domain is the fabric's cluster UUID and clique id where
        `nvidia-smi -q` reports a registered fabric, else a one-host domain
        named `host-<hostname>`. The fabric neither numbers a domain's hosts
        nor counts them, so the spec says worker 0 of 1 host either way: the
        GCS counts a slice's hosts from its alive nodes' labels, and a host
        started with its own `worker_index` label (`ray-tpu start --labels`)
        keeps it. `num_gpus` (the raylet's own count) stands in where the
        report gives none. With `cache_dir` (a session dir), the host reads
        `nvidia-smi -q` once: the first call writes its spec there and
        later ones (the session's other raylets on this host) read it."""
        from ..core.resources import GpuSliceSpec

        cache = cache_dir and os.path.join(cache_dir, f"slice_spec-{self._hostname()}.json")
        if cache:
            try:
                with open(cache) as f:
                    return GpuSliceSpec(**json.load(f))
            except (OSError, ValueError, TypeError):
                pass
        spec = self._read_slice_spec(num_gpus)
        if cache:
            tmp = f"{cache}.{os.getpid()}"
            try:
                with open(tmp, "w") as f:
                    json.dump(dataclasses.asdict(spec), f)
                os.replace(tmp, cache)
            except OSError:
                pass  # the next raylet reads the report again
        return spec

    def _read_slice_spec(self, num_gpus: int):
        from ..core.resources import GpuSliceSpec

        report = self._smi() or ""
        attached = _report_field(report, "Attached GPUs")
        per_host = int(attached) if attached and attached.isdigit() else int(num_gpus) or 1
        domain = _fabric(report)
        return GpuSliceSpec(
            slice_name=f"host-{self._hostname()}" if domain is None else f"nvl-{domain}",
            generation=gpu_generation(_report_field(report, "Product Name") or ""),
            gpus_per_host=per_host, hosts_per_slice=1, worker_index=0)

    def worker_visibility_env(self, ids: List[str], **extra) -> Dict[str, str]:
        """CUDA_VISIBLE_DEVICES naming exactly `ids`; an empty list hides
        every device (a worker that asked for no GPU creates no CUDA
        context). `extra` carries the slice's identity (slice_name,
        worker_index) for a worker on a slice host."""
        env = {CUDA_VISIBLE_DEVICES_ENV: ",".join(str(i) for i in ids)}
        env.update(slice_env(extra.get("slice_name"), extra.get("worker_index", 0)))
        return env


def slice_env(slice_name: Optional[str], worker_index: int = 0) -> Dict[str, str]:
    """RAY_TPU_SLICE_NAME and RAY_TPU_SLICE_WORKER_ID for a worker on a
    slice host; {} off a slice."""
    if not slice_name:
        return {}
    return {SLICE_NAME_ENV: str(slice_name), SLICE_WORKER_ID_ENV: str(int(worker_index))}
