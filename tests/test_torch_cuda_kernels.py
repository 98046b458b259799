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


def _entry_err(got, want):
    """max over entries of |got - want| / (|want| + rms(want))."""
    g, w = got.float(), want.float()
    return ((g - w).abs() / (w.abs() + w.pow(2).mean().sqrt())).max().item()


# Forward: the kernel against reference_flash_fwd, which rounds P where the
# Pallas kernel does. fp32 (FMA kernel): max |err| 1e-4 for o and lse. bf16
# (tensor-core kernel): each entry of o within 2**-6 x (|ref| + rms(ref)),
# since sums in another order put an output or a P one bf16 ulp apart, and
# lse (fp32, the log of a sum of unrounded P) within 1e-3.
FWD_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2 ** -6, 1e-3)}


def _check_fwd(gen, b, s, h, h_kv, d, dtype, causal):
    q, k, v = (torch.randn((b, s, hh, d), generator=gen, device="cuda").to(dtype)
               for hh in (h, h_kv, h_kv))
    kw = dict(causal=causal, scale=d ** -0.5)
    before = tfa.flash_fwd.launches
    o, lse = tfa.flash_fwd(q, k, v, **kw)
    torch.cuda.synchronize()
    assert tfa.flash_fwd.launches == before + 1
    o_ref, lse_ref = tfa.reference_flash_fwd(q, k, v, **kw)
    assert o.dtype == dtype and lse.dtype == torch.float32 and lse.shape == (b, h, s)
    tol_o, tol_lse = FWD_TOL[dtype]
    err_o = (_entry_err(o, o_ref) if dtype == torch.bfloat16
             else (o - o_ref).abs().max().item())
    assert err_o <= tol_o, err_o
    assert (lse - lse_ref).abs().max().item() <= tol_lse


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,h,h_kv,d,causal", [(16, 4, 4, 128, True), (200, 8, 2, 64, True),
                                                (96, 4, 1, 16, False), (130, 2, 2, 32, True),
                                                (200, 4, 2, 256, True), (70, 2, 2, 256, False)])
def test_flash_fwd_matches_plain_version(cuda, dtype, s, h, h_kv, d, causal):
    _check_fwd(cuda, 2, s, h, h_kv, d, dtype, causal)


# bf16, the tensor-core route: several 64-row tiles with a ragged last one,
# GQA with 4 query heads per kv head, every head dim.
@pytest.mark.parametrize("d", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("s,causal", [(130, True), (300, False), (1000, True)])
def test_flash_fwd_bf16_over_ragged_tiles_matches_plain_version(cuda, s, causal, d):
    _check_fwd(cuda, 2, s, 8, 2, d, torch.bfloat16, causal)


def test_flash_fwd_is_deterministic(cuda):
    q, k, v = (torch.randn((2, 1000, hh, 128), generator=cuda, device="cuda").bfloat16()
               for hh in (8, 2, 2))
    first = tfa.flash_fwd(q, k, v, causal=True, scale=128 ** -0.5)
    second = tfa.flash_fwd(q, k, v, causal=True, scale=128 ** -0.5)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_flash_fwd_bf16_raises_on_misaligned_inputs(cuda):
    q = torch.randn((1, 64, 2, 64), generator=cuda, device="cuda").bfloat16()
    flat = torch.empty(q.numel() + 1, dtype=q.dtype, device="cuda")
    shifted = flat[1:].view(q.shape).copy_(q)  # contiguous, 2 bytes past the alignment
    with pytest.raises(ValueError, match="16-byte"):
        tfa.flash_fwd(shifted, q, q, causal=True, scale=0.125)


# Backward tolerances: each entry is held to tol x (|ref| + rms(ref)), ref
# the plain version's gradient, so the check is relative where an entry is
# large and floored at the tensor's typical magnitude where it is near 0.
# fp32 (FMA kernels) sums in another order; bf16 (tensor-core kernels) sums
# in another order too, the outputs round to bf16, and a P or dS near a
# rounding boundary rounds one ulp apart: 2**-6 is four bf16 ulps.
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2 ** -6}


def _bwd_inputs(gen, b, s, h, h_kv, d, dtype, causal):
    q, k, v, do = (torch.randn((b, s, hh, d), generator=gen, device="cuda").to(dtype)
                   for hh in (h, h_kv, h_kv, h))
    o, lse = tfa.flash_fwd(q, k, v, causal=causal, scale=d ** -0.5)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    return q, k, v, o, lse, do, delta


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,h,h_kv,d,causal", [(16, 4, 4, 128, True), (200, 8, 2, 64, True),
                                                (96, 4, 1, 16, False), (130, 2, 2, 32, True),
                                                (200, 4, 2, 256, True), (70, 2, 2, 256, False)])
def test_flash_bwd_matches_plain_version(cuda, dtype, s, h, h_kv, d, causal):
    q, k, v, o, lse, do, delta = _bwd_inputs(cuda, 2, s, h, h_kv, d, dtype, causal)
    scale = d ** -0.5
    before = _launch_counts()
    got = tfa.flash_bwd(q, k, v, o, lse, do, delta, causal=causal, scale=scale)
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(_launch_counts(), before)) == (0, 1, 1)
    want = tfa.reference_flash_bwd(q, k, v, o, lse, do, delta, causal=causal, scale=scale)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape and g.dtype == w.dtype == dtype, name
        assert _entry_err(g, w) <= BWD_TOL[dtype], (name, _entry_err(g, w))


# bf16, the tensor-core route: several 64-row tiles with a ragged last one,
# GQA with 4 query heads per kv head, every head dim.
@pytest.mark.parametrize("d", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("s,causal", [(130, True), (300, False), (1000, True)])
def test_flash_bwd_bf16_over_ragged_tiles_matches_plain_version(cuda, s, causal, d):
    q, k, v, o, lse, do, delta = _bwd_inputs(cuda, 2, s, 8, 2, d, torch.bfloat16, causal)
    kw = dict(causal=causal, scale=d ** -0.5)
    got = tfa.flash_bwd(q, k, v, o, lse, do, delta, **kw)
    torch.cuda.synchronize()
    want = tfa.reference_flash_bwd(q, k, v, o, lse, do, delta, **kw)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert _entry_err(g, w) <= BWD_TOL[torch.bfloat16], (name, _entry_err(g, w))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_is_deterministic(cuda, dtype):
    """One owner per output tile, no atomics: two launches agree bit for bit."""
    q, k, v, o, lse, do, delta = _bwd_inputs(cuda, 2, 1000, 8, 2, 128, dtype, True)
    kw = dict(causal=True, scale=128 ** -0.5)
    first = tfa.flash_bwd(q, k, v, o, lse, do, delta, **kw)
    second = tfa.flash_bwd(q, k, v, o, lse, do, delta, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_flash_bwd_bf16_raises_on_misaligned_inputs(cuda):
    q, k, v, o, lse, do, delta = _bwd_inputs(cuda, 1, 64, 2, 2, 64, torch.bfloat16, True)
    flat = torch.empty(q.numel() + 1, dtype=q.dtype, device="cuda")
    shifted = flat[1:].view(q.shape).copy_(q)  # contiguous, 2 bytes past the alignment
    with pytest.raises(ValueError, match="16-byte"):
        tfa.flash_bwd_dq(shifted, k, v, lse, do, delta, causal=True, scale=0.125)


def _launch_counts():
    return tfa.flash_fwd.launches, tfa.flash_bwd_dq.launches, tfa.flash_bwd_dkv.launches


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernels_at_gptj_heads_match_plain_versions(cuda, dtype):
    """GPT-J's attention (16 heads of 256, causal) through all three kernels:
    bf16 on the tensor cores (the backward splits each output tile's columns
    over two blocks), fp32 on FMAs (the backward's 32-row tiles)."""
    _check_fwd(cuda, 1, 512, 16, 16, 256, dtype, True)
    q, k, v, o, lse, do, delta = _bwd_inputs(cuda, 1, 512, 16, 16, 256, dtype, True)
    kw = dict(causal=True, scale=256 ** -0.5)
    got = tfa.flash_bwd(q, k, v, o, lse, do, delta, **kw)
    again = tfa.flash_bwd(q, k, v, o, lse, do, delta, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = tfa.reference_flash_bwd(q, k, v, o, lse, do, delta, **kw)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert _entry_err(g, w) <= BWD_TOL[dtype], (name, _entry_err(g, w))


def test_flash_kernels_take_batch_times_heads_past_65535(cuda):
    """b*h = 65600 blocks on grid x, where CUDA's y would stop at 65535."""
    b, s, h, d = 4100, 40, 16, 16
    _check_fwd(cuda, b, s, h, 4, d, torch.float32, True)
    q, k, v, o, lse, do, delta = _bwd_inputs(cuda, b, s, h, 4, d, torch.float32, True)
    kw = dict(causal=True, scale=d ** -0.5)
    got = tfa.flash_bwd(q, k, v, o, lse, do, delta, **kw)
    torch.cuda.synchronize()
    want = tfa.reference_flash_bwd(q, k, v, o, lse, do, delta, **kw)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert _entry_err(g, w) <= BWD_TOL[torch.float32], (name, _entry_err(g, w))


def test_train_step_on_cuda_matches_cpu(cuda):
    """One fp32 AdamW step of the tiny model through the kernels against the
    same step on the CPU (the plain versions), from the same params. Each
    leaf's gradient: 1e-5 of its norm (fp32 sums in another order); Adam's
    update would hide a gradient off by a factor. Params: 1e-4 absolute at
    lr 1e-3, since Adam moves an entry whose gradient is near fp32 noise by a
    visible share of lr."""
    from ray_tpu_torch.models import transformer as tfm

    cfg = tfm.tiny(attn_impl="full", dtype=torch.float32)
    tokens = torch.randint(0, cfg.vocab_size, (2, 40), generator=torch.Generator().manual_seed(0))
    init, cpu_step = tfm.build_train_step(cfg, tfm.adamw(1e-3), device="cpu")
    _, gpu_step = tfm.build_train_step(cfg, tfm.adamw(1e-3), device="cuda")
    cpu_params, cpu_opt = init(torch.Generator().manual_seed(0))
    gpu_params = tfm.map_tree(lambda t: t.detach().cuda().requires_grad_(), cpu_params)
    gpu_opt = tfm.adamw(1e-3)(tfm.tree_leaves(gpu_params))
    cpu_loss = cpu_step(cpu_params, cpu_opt, tokens).item()
    before = _launch_counts()
    gpu_loss = gpu_step(gpu_params, gpu_opt, tokens).item()
    launched = tuple(a - b for a, b in zip(_launch_counts(), before))
    assert launched == (cfg.n_layers,) * 3  # tiny() has no remat: one forward per layer
    assert abs(gpu_loss - cpu_loss) < 1e-5
    for want, got in zip(tfm.tree_leaves(cpu_params), tfm.tree_leaves(gpu_params)):
        assert (got.grad.cpu() - want.grad).norm() <= 1e-5 * want.grad.norm()
    for want, got in zip(tfm.tree_leaves(cpu_params), tfm.tree_leaves(gpu_params)):
        torch.testing.assert_close(got.detach().cpu(), want.detach(), atol=1e-4, rtol=0)


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


def test_gptj_width_paged_prefill_and_decode_match_full_forward(cuda):
    """GPT-J at full width (16 heads of 256), 2 layers, fp32: paged prefill
    through the flash forward at head_dim 256, then decode, give the full
    forward's greedy tokens."""
    from ray_tpu_torch.models import transformer as tfm
    from ray_tpu_torch.serve.llm import PagedLM

    cfg = tfm.gpt_j_6b(n_layers=2, dtype=torch.float32)
    lm = PagedLM(cfg, seed=0, device="cuda", num_pages=8, page_tokens=16, max_slots=1,
                 max_pages_per_seq=4)
    prompt = torch.randint(0, cfg.vocab_size, (21,), generator=torch.Generator().manual_seed(0))
    prompt = prompt.tolist()
    pages = [1, 2]  # 21 prompt tokens and 4 decoded ones fit two pages of 16
    before = tfa.flash_fwd.launches
    got = [lm.prefill(prompt, pages, 0)]
    assert tfa.flash_fwd.launches == before + cfg.n_layers
    while len(got) < 5:
        got.append(lm.decode([got[-1]], [len(prompt) + len(got) - 1], [pages])[0])
    seq, gold = list(prompt), []
    with torch.inference_mode():
        for _ in range(5):
            logits = tfm.forward(lm.params, torch.tensor([seq], device="cuda"), cfg)
            gold.append(int(torch.argmax(logits[0, -1])))
            seq.append(gold[-1])
    assert got == gold
