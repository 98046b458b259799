"""Device choice for the port's entry points: CUDA unless the caller asks
for another device, and never a silent fall back to the CPU."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`device` as a torch.device; None means the current CUDA device, and
    raises when there is none."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: ray_tpu_torch runs on the GPU unless the caller "
            "passes device='cpu'"
        )
    return torch.device("cuda", torch.cuda.current_device())
