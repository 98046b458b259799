"""ray_tpu_torch: the PyTorch/CUDA port of ray_tpu for NVIDIA Hopper GPUs.

It imports torch, numpy and the standard library, never jax and nothing of
the ray_tpu package. Entry points run on CUDA unless the caller passes
device="cpu". Ported so far: the LLM serving path (serve.llm over
models.transformer, with the flash-attention forward as a CUDA kernel in
ops), training (models.transformer.build_train_step, with the flash backward
kernels, remat and ZeRO-1) and the training state in train (torch.distributed
set-up, ZeRO-1, elastic, pytree and HF checkpoints).
"""

from .exceptions import BackpressureError, KVPoolExhaustedError, RayTpuError

__all__ = ["BackpressureError", "KVPoolExhaustedError", "RayTpuError"]
