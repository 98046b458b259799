"""Hand-written GPU kernels of the PyTorch port, each with its plain version.
`flash_attention` is the module of the CUDA flash forward and backward
kernels (ops/csrc/, built on first launch), through which their launch
counters are read (`fa.flash_fwd`). The JAX package's
`ray_tpu.ops.flash_attention` function is `flash_attention_fn` here."""

from . import flash_attention
from .flash_attention import flash_attention as flash_attention_fn

__all__ = ["flash_attention", "flash_attention_fn"]
