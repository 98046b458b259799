"""Small MLP classifier, the model of the trainer's end-to-end fit (the
counterpart of ray_tpu/models/mlp.py).

Params are the JAX package's tree, {"layers": [{"w": [din, dout], "b":
[dout]}, ...]}, so `models/convert.py` `mlp_params_from_numpy` carries a
JAX-made tree across unchanged.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Tuple

import torch
import torch.nn.functional as F

PyTree = Any


@dataclasses.dataclass(frozen=True)
class MLPConfig:
    in_dim: int = 784
    hidden: Tuple[int, ...] = (512, 256)
    n_classes: int = 10
    dtype: Any = torch.float32

    @property
    def dims(self) -> Tuple[int, ...]:
        return (self.in_dim,) + tuple(self.hidden) + (self.n_classes,)


def init_params(cfg: MLPConfig, generator: torch.Generator, device=None) -> PyTree:
    """normal / sqrt(fan_in) weights and zero biases in cfg.dtype; the
    generator lives on `device` (CUDA unless the caller passes "cpu")."""
    from .._device import resolve_device

    dev = resolve_device(device)
    layers = []
    for din, dout in zip(cfg.dims[:-1], cfg.dims[1:]):
        w = torch.randn((din, dout), generator=generator, dtype=torch.float32, device=dev)
        layers.append({"w": w.div_(math.sqrt(din)).to(cfg.dtype),
                       "b": torch.zeros((dout,), dtype=cfg.dtype, device=dev)})
    return {"layers": layers}


def forward(params: PyTree, x: torch.Tensor) -> torch.Tensor:
    layers = params["layers"]
    for layer in layers[:-1]:
        x = torch.relu(x @ layer["w"] + layer["b"])
    last = layers[-1]
    return x @ last["w"] + last["b"]


def loss_fn(params: PyTree, batch: dict) -> torch.Tensor:
    logp = F.log_softmax(forward(params, batch["x"]), dim=-1)
    return -torch.mean(torch.gather(logp, -1, batch["y"].long()[:, None]))


def accuracy(params: PyTree, batch: dict) -> torch.Tensor:
    return torch.mean((torch.argmax(forward(params, batch["x"]), -1) == batch["y"]).float())
