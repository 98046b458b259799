"""Gradient parity of ray_tpu_torch.ops.flash_attention with the JAX package.

The same seeded numpy inputs and cotangents go through `jax.vjp` of the JAX
flash attention (its Pallas backward kernels in interpret mode on the CPU,
at `highest` matmul precision) and through the port's autograd on the CPU,
which runs the backward kernels' plain versions. float32; dq, dk and dv agree
within 2e-5 max-abs, the forward's tolerance. In bfloat16 the plain versions
are held against the Pallas kernels entry by entry, as the card holds the
CUDA kernels against the plain versions (tests/test_torch_cuda_kernels.py and
chip_smoke.py).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu_torch.ops import flash_attention as tfa

jfa = importlib.import_module("ray_tpu.ops.flash_attention")
TOL = 2e-5


@pytest.fixture(autouse=True)
def _exact_matmuls():
    old = jax.config.jax_default_matmul_precision
    jax.config.update("jax_default_matmul_precision", "highest")
    yield
    jax.config.update("jax_default_matmul_precision", old)


def _inputs(b=2, s=128, h=4, d=64, kv_heads=None, seed=0):
    """q, k, v and the cotangent do, as float32 numpy arrays."""
    rng = np.random.default_rng(seed)
    hk = kv_heads or h
    shapes = [(b, s, h, d), (b, s, hk, d), (b, s, hk, d), (b, s, h, d)]
    return [rng.standard_normal(sh, dtype=np.float32) for sh in shapes]


def _maxdiff(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


def _torch_grads(fn, arrays, cotangents):
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in arrays)
    out = fn(q, k, v)
    out = out if isinstance(out, tuple) else (out,)
    grads = torch.autograd.grad(out, (q, k, v), [torch.from_numpy(c) for c in cotangents])
    return [g.numpy() for g in grads]


def _jax_grads(fn, arrays, cotangents):
    out, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in arrays))
    ct = tuple(jnp.asarray(c) for c in cotangents)
    return vjp(ct if isinstance(out, tuple) else ct[0])


def _assert_grads_match(jgrads, tgrads):
    for name, jg, tg in zip("qkv", jgrads, tgrads):
        assert jg.shape == tg.shape, name
        assert _maxdiff(jg, tg) < TOL, f"d{name} differs by {_maxdiff(jg, tg)}"


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("kv_heads", [None, 2], ids=["mha", "gqa"])
def test_grads_match_jax(causal, kv_heads):
    *qkv, do = _inputs(kv_heads=kv_heads)
    jg = _jax_grads(lambda q, k, v: jfa.flash_attention(q, k, v, causal=causal, block_q=64,
                                                        block_k=64), qkv, [do])
    tg = _torch_grads(lambda q, k, v: tfa.flash_attention(q, k, v, causal=causal), qkv, [do])
    _assert_grads_match(jg, tg)


def test_multiblock_row_grads_match_jax():
    # The JAX q block spans two k blocks, and each k block two q blocks.
    *qkv, do = _inputs(b=1, s=256, h=2)
    jg = _jax_grads(lambda q, k, v: jfa.flash_attention(q, k, v, causal=True, block_q=128,
                                                        block_k=64), qkv, [do])
    tg = _torch_grads(lambda q, k, v: tfa.flash_attention(q, k, v, causal=True), qkv, [do])
    _assert_grads_match(jg, tg)


@pytest.mark.parametrize("causal,kv_heads", [(True, None), (False, None), (True, 2)])
def test_lse_variant_grads_match_jax(causal, kv_heads):
    *qkv, do = _inputs(kv_heads=kv_heads)
    b, s, h, _ = do.shape
    dlse = np.random.default_rng(7).standard_normal((b, h, s), dtype=np.float32)
    jg = _jax_grads(lambda q, k, v: jfa.flash_attention_with_lse(
        q, k, v, causal=causal, block_q=64, block_k=64), qkv, [do, dlse])
    tg = _torch_grads(lambda q, k, v: tfa.flash_attention_with_lse(q, k, v, causal=causal),
                      qkv, [do, dlse])
    _assert_grads_match(jg, tg)


def test_lse_variant_with_only_lse_used_matches_jax():
    # o unused: its cotangent is zero (None on the port's side).
    *qkv, do = _inputs(s=64, kv_heads=2)
    b, s, h, _ = do.shape
    dlse = np.random.default_rng(8).standard_normal((b, h, s), dtype=np.float32)
    jg = _jax_grads(lambda q, k, v: jfa.flash_attention_with_lse(
        q, k, v, causal=True, block_q=64, block_k=64)[1], qkv, [dlse])
    tg = _torch_grads(lambda q, k, v: tfa.flash_attention_with_lse(q, k, v, causal=True)[1],
                      qkv, [dlse])
    _assert_grads_match(jg, tg)


@pytest.mark.parametrize("s,d", [(12, 24), (40, 16)])
def test_odd_shape_grads_match_jax(s, d):
    # (12, 24): neither side has a kernel for it (plain autograd on both);
    # (40, 16): JAX tiles it by 8, the port's kernel path masks a ragged tile.
    *qkv, do = _inputs(b=1, s=s, h=4, d=d, kv_heads=2)
    jg = _jax_grads(lambda q, k, v: jfa.flash_attention(q, k, v, causal=True), qkv, [do])
    tg = _torch_grads(lambda q, k, v: tfa.flash_attention(q, k, v, causal=True), qkv, [do])
    _assert_grads_match(jg, tg)


def _bh(x):
    b, s, hh, d = x.shape
    return jnp.asarray(x).transpose(0, 2, 1, 3).reshape(b * hh, s, d)


@pytest.mark.parametrize("causal,kv_heads", [(True, 2), (False, None)])
def test_reference_flash_bwd_matches_jax_kernels(causal, kv_heads):
    """The plain version against the Pallas `_dq_kernel` / `_dkv_kernel`
    directly, with a delta that is not sum(do * o) (as after a dlse)."""
    q, k, v, do = _inputs(b=1, s=128, h=4, kv_heads=kv_heads, seed=3)
    b, s, h, d = q.shape
    h_kv = k.shape[2]
    scale = 0.2
    o, lse = jfa.flash_attention_with_lse(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                          causal=causal, scale=scale, block_q=64, block_k=64)
    delta = np.random.default_rng(4).standard_normal((b, h, s), dtype=np.float32)
    jdq, jdk, jdv = jfa._flash_bwd_impl(
        causal, scale, 64, 64, True, (h, h_kv), _bh(q), _bh(k), _bh(v), _bh(np.asarray(o)),
        jnp.asarray(lse).reshape(b * h, s, 1), _bh(do), jnp.asarray(delta).reshape(b * h, s, 1),
    )

    def from_bh(x, hh):
        return np.asarray(x).reshape(b, hh, s, d).transpose(0, 2, 1, 3)

    t = [torch.from_numpy(np.array(a)) for a in (q, k, v, o, lse, do, delta)]
    tdq, tdk, tdv = tfa.reference_flash_bwd(*t, causal=causal, scale=scale)
    assert _maxdiff(from_bh(jdq, h), tdq) < TOL
    assert _maxdiff(from_bh(jdk, h_kv), tdk) < TOL
    assert _maxdiff(from_bh(jdv, h_kv), tdv) < TOL


def _entry_err(got, want):
    """max over entries of |got - want| / (|want| + rms(want)): the measure
    the card's backward checks use (chip_smoke.py `bwd_err`)."""
    g, w = (np.asarray(x, dtype=np.float32) for x in (got, want))
    return float(np.max(np.abs(g - w) / (np.abs(w) + np.sqrt(np.mean(w * w)))))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("kv_heads", [None, 2], ids=["mha", "gqa"])
def test_reference_flash_bwd_matches_jax_kernels_in_bf16(causal, kv_heads):
    """bfloat16: the plain versions round where the Pallas kernels cast (dS to
    k's and q's dtype, P to dO's, the outputs to bf16), so the CUDA kernels,
    held against the plain versions on the card, compute what the TPU's do.
    Each entry within 2**-6 x (|ref| + rms(ref)), the card's bf16 tolerance:
    sums in another order put an output one bf16 ulp apart."""
    b, s, h, d = 1, 192, 4, 64
    q, k, v, do = (jnp.asarray(a, jnp.bfloat16)
                   for a in _inputs(b=b, s=s, h=h, d=d, kv_heads=kv_heads, seed=5))
    h_kv = k.shape[2]
    scale = d ** -0.5
    o, lse = jfa.flash_attention_with_lse(q, k, v, causal=causal, scale=scale, block_q=64,
                                          block_k=64)
    delta = (do.astype(jnp.float32) * o.astype(jnp.float32)).sum(-1).transpose(0, 2, 1)
    jdq, jdk, jdv = jfa._flash_bwd_impl(
        causal, scale, 64, 64, True, (h, h_kv), _bh(q), _bh(k), _bh(v), _bh(o),
        lse.reshape(b * h, s, 1), _bh(do), delta.reshape(b * h, s, 1),
    )

    def to_torch(x):
        x = torch.from_numpy(np.array(jnp.asarray(x, jnp.float32)))
        return x.to(torch.bfloat16) if x.dim() == 4 else x

    t = [to_torch(a) for a in (q, k, v, o, lse, do, delta)]
    got = tfa.reference_flash_bwd(*t, causal=causal, scale=scale)
    for name, jg, hh, tg in zip(("dq", "dk", "dv"), (jdq, jdk, jdv), (h, h_kv, h_kv), got):
        assert tg.dtype == torch.bfloat16, name
        want = np.asarray(jg.astype(jnp.float32)).reshape(b, hh, s, d).transpose(0, 2, 1, 3)
        err = _entry_err(tg.float().numpy(), want)
        assert err <= 2 ** -6, (name, err)


def test_non_contiguous_upstream_gradient_is_taken():
    *qkv, do = _inputs(b=1, s=32, h=2, d=16)
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in qkv)
    o = tfa.flash_attention(q, k, v)
    w = torch.from_numpy(do).transpose(1, 2).contiguous()  # [b, h, s, d]
    (o.transpose(1, 2) * w).sum().backward()  # do arrives as a transposed view
    want = torch.autograd.grad(tfa.flash_attention(q, k, v), (q, k, v), torch.from_numpy(do))
    for got, ref in zip((q.grad, k.grad, v.grad), want):
        assert torch.equal(got, ref)


def test_cpu_backward_launches_no_kernel():
    *qkv, do = _inputs(b=1, s=16, h=2, d=16)
    before = (tfa.flash_fwd.launches, tfa.flash_bwd_dq.launches, tfa.flash_bwd_dkv.launches)
    _torch_grads(lambda q, k, v: tfa.flash_attention(q, k, v), qkv, [do])
    after = (tfa.flash_fwd.launches, tfa.flash_bwd_dq.launches, tfa.flash_bwd_dkv.launches)
    assert after == before
