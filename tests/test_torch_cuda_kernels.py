"""The port's CUDA kernels on the card (marker `cuda`; each test skips
without a CUDA device, since a CUDA kernel has no CPU mode).

This file imports neither jax nor ray_tpu, so it runs on a GPU machine
without them:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py
"""

import pytest
import torch

from ray_tpu_torch.ops import flash_attention as tfa

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.Generator(device="cuda").manual_seed(0)
    torch.backends.cuda.matmul.allow_tf32 = old


@pytest.mark.parametrize("dtype,tol_o,tol_lse", [(torch.float32, 1e-4, 1e-4),
                                                 (torch.bfloat16, 2e-2, 1e-2)])
@pytest.mark.parametrize("s,h,h_kv,d,causal", [(16, 4, 4, 128, True), (200, 8, 2, 64, True),
                                                (96, 4, 1, 16, False), (130, 2, 2, 32, True)])
def test_flash_fwd_matches_plain_version(cuda, dtype, tol_o, tol_lse, s, h, h_kv, d, causal):
    q, k, v = (torch.randn((2, s, hh, d), generator=cuda, device="cuda").to(dtype)
               for hh in (h, h_kv, h_kv))
    before = tfa.flash_fwd.launches
    o, lse = tfa.flash_fwd(q, k, v, causal=causal, scale=d ** -0.5)
    torch.cuda.synchronize()
    assert tfa.flash_fwd.launches == before + 1
    rep = h // h_kv
    o_ref, lse_ref = tfa.reference_attention_with_lse(
        q, k.repeat_interleave(rep, 2), v.repeat_interleave(rep, 2), causal=causal,
        scale=d ** -0.5,
    )
    assert (o.float() - o_ref.float()).abs().max().item() <= tol_o
    assert (lse - lse_ref).abs().max().item() <= tol_lse


def test_flash_attention_raises_on_what_the_kernel_does_not_take(cuda):
    x = torch.randn((1, 16, 2, 24), generator=cuda, device="cuda")
    with pytest.raises(ValueError, match="head_dim"):
        tfa.flash_attention(x, x, x)  # no fall back to the unfused path on CUDA
    y = torch.randn((1, 16, 2, 64), generator=cuda, device="cuda")
    t = y.transpose(1, 2)  # a [1, 2, 16, 64] view with a head stride of 64
    with pytest.raises(ValueError, match="contiguous"):
        tfa.flash_fwd(t, t, t, causal=True, scale=0.125)
    with pytest.raises(ValueError, match="float32/bfloat16"):
        tfa.flash_fwd(y.half(), y.half(), y.half(), causal=True, scale=0.125)


def test_paged_lm_on_cuda_matches_cpu(cuda):
    from ray_tpu_torch.models import transformer as tfm
    from ray_tpu_torch.serve.llm import PagedLM

    cfg = tfm.tiny(attn_impl="full", dtype=torch.float32)
    geo = dict(num_pages=16, page_tokens=8, max_slots=2, max_pages_per_seq=4)
    cpu = PagedLM(cfg, seed=0, device="cpu", **geo)
    gpu = PagedLM(cfg, tfm.map_tree(lambda t: t.cuda(), cpu.params), device="cuda", **geo)
    prompt = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3]
    before = tfa.flash_fwd.launches
    toks = [lm.prefill(prompt, [1, 2], 0) for lm in (cpu, gpu)]
    assert tfa.flash_fwd.launches == before + cfg.n_layers  # CPU path launches nothing
    assert toks[0] == toks[1]
    steps = [lm.decode([toks[0], 0], [len(prompt), -1], [[1, 2], []]) for lm in (cpu, gpu)]
    assert steps[0][0] == steps[1][0]
