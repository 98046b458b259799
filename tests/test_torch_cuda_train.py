"""The port's training state and trainer on the card (marker `cuda`; each
test skips without a CUDA device): ZeRO-1 over NCCL, the HF round trip and
a one-step TorchTrainer fit through the flash kernels.

This file imports neither jax nor ray_tpu, so it runs on a GPU machine
without them:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_train.py
"""

import math
import os

import pytest
import torch

import ray_tpu_torch

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


def _one_step_loop(config):
    from ray_tpu_torch import train

    device = train.get_mesh().devices.flat[0]
    cfg = tfm.tiny(dtype=torch.bfloat16, attn_impl="full", remat=True, remat_policy="hot")
    init, step = tfm.build_train_step(cfg, tfm.adamw(1e-3), device=device)
    params, opt = init(torch.Generator(device=device).manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (2, 64), generator=torch.Generator().manual_seed(1))
    loss = step(params, opt, tokens).item()
    train.report({"loss": loss, "device": str(params["embed"]["embedding"].device),
                  "current": torch.cuda.current_device(), "layers": cfg.n_layers})


def test_torch_trainer_fits_one_step_through_the_kernels(cuda, tmp_path):
    """TorchTrainer.fit with the default ScalingConfig (use_gpu=True): the
    loop's thread runs on the mesh's CUDA device and its one step launches
    each flash kernel once per layer (remat "hot" keeps the forward's
    output)."""
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer

    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(local_mode=True)
    try:
        fa.flash_fwd.launches = fa.flash_bwd_dq.launches = fa.flash_bwd_dkv.launches = 0
        result = TorchTrainer(
            _one_step_loop,
            scaling_config=ScalingConfig(num_workers=1, resources_per_worker={"GPU": 1}),
            run_config=RunConfig(storage_path=str(tmp_path)),
        ).fit()
        launches = (fa.flash_fwd.launches, fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches)
    finally:
        ray_tpu_torch.shutdown()
    assert result.error is None, result.error
    m = result.metrics
    assert math.isfinite(m["loss"]) and m["device"] == "cuda:0" and m["current"] == 0
    assert launches == (m["layers"],) * 3
