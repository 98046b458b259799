"""Parity of ray_tpu_torch.ops.flash_attention with the JAX package.

The same seeded numpy inputs go through the JAX flash attention (its Pallas
kernel in interpret mode on the CPU, as tests/test_ops.py runs it, at
`highest` matmul precision) and through the port's CPU path, in float32,
within 2e-5 max-abs; in bfloat16 entry by entry, within one bf16 ulp. The
CUDA kernel itself is checked against its plain version by
tests/test_torch_cuda_kernels.py and chip_smoke.py on the card.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu_torch.ops import flash_attention as tfa

# ray_tpu.ops re-exports the function under the module's name.
jfa = importlib.import_module("ray_tpu.ops.flash_attention")
TOL = 2e-5


@pytest.fixture(autouse=True)
def _exact_matmuls():
    old = jax.config.jax_default_matmul_precision
    jax.config.update("jax_default_matmul_precision", "highest")
    yield
    jax.config.update("jax_default_matmul_precision", old)


def _qkv(b=2, s=128, h=4, d=64, kv_heads=None, seed=0):
    rng = np.random.default_rng(seed)
    shapes = [(b, s, h, d), (b, s, kv_heads or h, d), (b, s, kv_heads or h, d)]
    return [rng.standard_normal(sh, dtype=np.float32) for sh in shapes]


def _maxdiff(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


def _both(arrays, *, causal, lse=False, **jax_blocks):
    jq, jk, jv = (jnp.asarray(a) for a in arrays)
    tq, tk, tv = (torch.from_numpy(a) for a in arrays)
    if lse:
        jo = jfa.flash_attention_with_lse(jq, jk, jv, causal=causal, **jax_blocks)
        to = tfa.flash_attention_with_lse(tq, tk, tv, causal=causal)
        return jo, to
    jo = jfa.flash_attention(jq, jk, jv, causal=causal, **jax_blocks)
    return jo, tfa.flash_attention(tq, tk, tv, causal=causal)


@pytest.mark.parametrize("causal", [True, False])
def test_forward_matches_jax(causal):
    jo, to = _both(_qkv(), causal=causal, block_q=64, block_k=64)
    diff = _maxdiff(jo, to)
    assert diff < TOL, f"max |JAX - port| {diff:.6g} against {TOL} (causal={causal})"


def test_multiblock_row_matches_jax():
    # The JAX q block spans several k blocks (online-softmax carry).
    jo, to = _both(_qkv(b=1, s=256, h=2), causal=True, block_q=128, block_k=64)
    assert _maxdiff(jo, to) < TOL


@pytest.mark.parametrize("causal", [True, False])
def test_gqa_matches_jax(causal):
    jo, to = _both(_qkv(h=4, kv_heads=2), causal=causal, block_q=64, block_k=64)
    assert _maxdiff(jo, to) < TOL


@pytest.mark.parametrize(
    "s,d",
    [
        (12, 24),  # no 8-aligned tile in JAX, head_dim the kernel does not take
        (40, 16),  # JAX tiles it by 8; the kernel takes it with a ragged edge
    ],
)
def test_odd_shapes_match_jax(s, d):
    jo, to = _both(_qkv(b=1, s=s, h=4, d=d, kv_heads=2), causal=True)
    assert _maxdiff(jo, to) < TOL


@pytest.mark.parametrize("causal,kv_heads", [(True, None), (False, None), (True, 2)])
def test_lse_matches_jax(causal, kv_heads):
    (jo, jl), (to, tl) = _both(
        _qkv(h=4, kv_heads=kv_heads), causal=causal, lse=True, block_q=64, block_k=64
    )
    assert tuple(tl.shape) == tuple(jl.shape) == (2, 4, 128)
    assert tl.dtype == torch.float32
    assert _maxdiff(jo, to) < TOL
    assert _maxdiff(jl, tl) < TOL


def _entry_err(got, want):
    """max over entries of |got - want| / (|want| + rms(want)): the measure
    the card's checks use (chip_smoke.py `entry_err`)."""
    g, w = (np.asarray(x, dtype=np.float32) for x in (got, want))
    return float(np.max(np.abs(g - w) / (np.abs(w) + np.sqrt(np.mean(w * w)))))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("kv_heads", [None, 2], ids=["mha", "gqa"])
def test_forward_matches_jax_kernel_in_bf16(causal, kv_heads):
    """bfloat16: the port's CPU forward (`reference_flash_fwd`, the plain
    version the card holds the CUDA kernel against) rounds the unnormalised
    P of each 64-key block to bf16 where the Pallas `_fwd_kernel` does, so
    it reads within one bf16 ulp of the kernel entry by entry (at most
    0.004 here): 2**-7 x (|ref| + rms(ref)). Rounding P/l instead, as the
    unfused fallback does, reads up to 0.0157. lse is fp32 on both sides."""
    b, s, h, d = 1, 192, 4, 64
    for seed in range(3):
        q, k, v = (np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
                   for a in _qkv(b=b, s=s, h=h, d=d, kv_heads=kv_heads, seed=seed))
        jo, jl = jfa.flash_attention_with_lse(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                                              causal=causal, block_q=64, block_k=64)
        to, tl = tfa.flash_attention_with_lse(*(torch.from_numpy(a).bfloat16() for a in (q, k, v)),
                                              causal=causal)
        assert to.dtype == torch.bfloat16 and tl.dtype == torch.float32
        err = _entry_err(to.float().numpy(), np.asarray(jo.astype(jnp.float32)))
        assert err <= 2 ** -7, (seed, err)
        assert _maxdiff(jl, tl) < 1e-5, seed


def test_blockwise_plain_forward_matches_unfused_in_fp32():
    """In float32 the blockwise plain version and the unfused one differ by
    fp32 rounding only: a ragged s (3 full 64-key blocks and 8 keys) and GQA."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(b=2, s=200, h=4, d=32, kv_heads=2, seed=4))
    for causal in (True, False):
        o, lse = tfa.reference_flash_fwd(q, k, v, causal=causal, scale=0.2)
        o_ref, lse_ref = tfa.reference_attention_with_lse(
            q, k.repeat_interleave(2, 2), v.repeat_interleave(2, 2), causal=causal, scale=0.2)
        assert o.shape == q.shape and lse.shape == (2, 4, 200)
        assert _maxdiff(o, o_ref) < TOL and _maxdiff(lse, lse_ref) < TOL


def test_reference_attention_with_lse_matches_jax():
    q, k, v = _qkv(s=32)
    jo, jl = jfa.reference_attention_with_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True, scale=0.3
    )
    to, tl = tfa.reference_attention_with_lse(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal=True, scale=0.3
    )
    assert _maxdiff(jo, to) < TOL and _maxdiff(jl, tl) < TOL


def test_attention_reference_matches_jax():
    from ray_tpu.parallel.ring_attention import attention_reference

    q, k, v = _qkv(s=48)
    for causal in (True, False):
        jo = attention_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal)
        to = tfa.attention_reference(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal=causal
        )
        assert _maxdiff(jo, to) < TOL


def test_cpu_path_launches_no_kernel_and_checks_heads():
    q, k, v = (torch.from_numpy(a) for a in _qkv(s=16, kv_heads=2))
    before = tfa.flash_fwd.launches
    tfa.flash_attention(q, k, v)
    assert tfa.flash_fwd.launches == before
    with pytest.raises(ValueError, match="not divisible"):
        tfa.flash_attention(q, k[:, :, :1].expand(-1, -1, 3, -1), v[:, :, :1].expand(-1, -1, 3, -1))


def test_kernel_takes_matches_the_kernels_instances():
    def qkv(d, dtype):
        x = torch.zeros((1, 8, 2, d), dtype=dtype)
        return x, x, x

    for d in tfa.KERNEL_HEAD_DIMS:
        assert tfa.kernel_takes(*qkv(d, torch.float32))
        assert tfa.kernel_takes(*qkv(d, torch.bfloat16))
    assert not tfa.kernel_takes(*qkv(24, torch.float32))
    assert not tfa.kernel_takes(*qkv(64, torch.float16))
