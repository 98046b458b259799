"""The port's training state on the card (marker `cuda`; each test skips
without a CUDA device): ZeRO-1 over NCCL and the HF round trip.

This file imports neither jax nor ray_tpu, so it runs on a GPU machine
without them:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_train.py
"""

import os

import pytest
import torch

from ray_tpu_torch.models import transformer as tfm
from ray_tpu_torch.models.convert import flatten
from ray_tpu_torch.train import backend, hf_checkpoint, zero

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: NCCL and the flash kernels have no CPU mode")


def _bitwise(a, b) -> bool:
    (pa, la), (pb, lb) = flatten(a), flatten(b)
    return pa == pb and all(
        x.dtype == y.dtype and x.shape == y.shape
        and torch.equal(x.detach().reshape(-1).view(torch.uint8),
                        y.detach().reshape(-1).view(torch.uint8))
        for x, y in zip(la, lb))


def test_zero_step_at_world_one_on_nccl_is_the_plain_step(cuda):
    """A reduce-scatter over one rank is the identity and AdamW is
    elementwise: 3 ZeRO steps equal 3 plain steps bit for bit (deterministic
    algorithms, so the embedding's backward sums without atomics)."""
    import torch.distributed as dist

    cfg = tfm.tiny(dtype=torch.bfloat16, attn_impl="full", remat=True, remat_policy="hot")
    tokens = torch.randint(0, cfg.vocab_size, (2, 64), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(1))
    backend.setup_torch_distributed(0, 1, backend.coordinator_address(
        backend.TorchBackendConfig()), backend="nccl")
    env = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    try:
        runs = []
        for kw in ({}, {"zero_axis": "data"}):
            init, step = tfm.build_train_step(cfg, tfm.adamw(1e-3), device="cuda", **kw)
            params, opt = init(torch.Generator(device="cuda").manual_seed(0))
            runs.append(([step(params, opt, tokens).item() for _ in range(3)], params,
                         zero.per_device_bytes(opt)))
    finally:
        torch.use_deterministic_algorithms(False)
        if env is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG")
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = env
        dist.destroy_process_group()
    (plain_losses, plain_params, plain_bytes), (zero_losses, zero_params, zero_bytes) = runs
    assert plain_losses == zero_losses and plain_losses[-1] < plain_losses[0]
    assert _bitwise(plain_params, zero_params)
    assert zero_bytes == plain_bytes  # tiny()'s leaves need no pad at world 1


def test_hf_round_trip_on_the_card_is_bitwise(cuda, tmp_path):
    cfg = tfm.llama2_7b(n_layers=1, d_model=512, n_heads=4, n_kv_heads=4, d_ff=1024,
                        vocab_size=1000, dtype=torch.bfloat16)
    params = tfm.init_params(cfg, torch.Generator(device="cuda").manual_seed(3), device="cuda")
    path = str(tmp_path / "model.safetensors")
    hf_checkpoint.export_hf_checkpoint(params, cfg, path)
    loaded = hf_checkpoint.load_hf_checkpoint(path, cfg)
    assert all(t.device.type == "cuda" for t in flatten(loaded)[1])
    assert _bitwise(params, loaded)
