"""Parity of ray_tpu_torch.models with the JAX package's transformer.

One param tree, made by the JAX package's init_params and moved across as
numpy, goes through both forwards on the same seeded tokens, in float32 with
JAX at `highest` matmul precision; logits agree within atol/rtol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import transformer as jtfm
from ray_tpu_torch.models import transformer as ttfm
from ray_tpu_torch.models.convert import params_from_numpy, params_to_numpy


@pytest.fixture(autouse=True)
def _exact_matmuls():
    old = jax.config.jax_default_matmul_precision
    jax.config.update("jax_default_matmul_precision", "highest")
    yield
    jax.config.update("jax_default_matmul_precision", old)


# GPT-J's switches at tiny size: gelu MLP, parallel block, LayerNorm, RoPE on
# 8 of 16 head dims in interleaved pairs.
GPTJ_TINY = dict(mlp_act="gelu", parallel_block=True, rotary_dim=8, norm_type="layer",
                 rope_style="interleaved", n_kv_heads=4)
CONFIGS = {
    "full": dict(attn_impl="full"),
    "naive": dict(attn_impl="naive"),
    "gptj": dict(attn_impl="full", **GPTJ_TINY),
}


def _configs(name, dtype="float32"):
    kw = CONFIGS[name]
    jcfg = jtfm.tiny(dtype=getattr(jnp, dtype), **kw)
    tcfg = ttfm.tiny(dtype=getattr(torch, dtype), **kw)
    return jcfg, tcfg


def _np_tree(jparams):
    return jax.tree_util.tree_map(np.asarray, jparams)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_params_round_trip(name):
    jcfg, tcfg = _configs(name)
    np_params = _np_tree(jtfm.init_params(jax.random.PRNGKey(0), jcfg))
    back = params_to_numpy(params_from_numpy(np_params, tcfg, device="cpu"))
    a, b = _flat(np_params), _flat(back)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_params_from_numpy_bf16_is_exact():
    jcfg, tcfg = _configs("full", dtype="bfloat16")
    jparams = jtfm.init_params(jax.random.PRNGKey(1), jcfg)
    tparams = params_from_numpy(_np_tree(jparams), tcfg, device="cpu")
    assert tparams["blocks"]["attn"]["wq"].dtype == torch.bfloat16
    a = _flat(_np_tree(jax.tree_util.tree_map(lambda x: x.astype(jnp.float32), jparams)))
    b = _flat(params_to_numpy(tparams))
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_params_from_numpy_rejects_wrong_tree():
    jcfg, tcfg = _configs("full")
    np_params = _np_tree(jtfm.init_params(jax.random.PRNGKey(0), jcfg))
    np_params["blocks"]["attn"]["wq"] = np_params["blocks"]["attn"]["wq"][:, :, :8]
    with pytest.raises(ValueError, match="wq"):
        params_from_numpy(np_params, tcfg, device="cpu")
    del np_params["lm_head"]
    with pytest.raises(ValueError, match="keys"):
        params_from_numpy(np_params, tcfg, device="cpu")


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_init_params_tree_and_scale_match_jax(name):
    jcfg, tcfg = _configs(name)
    jflat = _flat(_np_tree(jtfm.init_params(jax.random.PRNGKey(0), jcfg)))
    gen = torch.Generator().manual_seed(0)
    tflat = _flat(ttfm.init_params(tcfg, gen, device="cpu"))
    assert jflat.keys() == tflat.keys()
    for k in jflat:
        assert tuple(tflat[k].shape) == jflat[k].shape, k
        assert tflat[k].dtype == torch.float32, k
        if k.endswith("scale"):
            assert torch.all(tflat[k] == 1), k
        else:  # normal / sqrt(fan_in): both stds agree within sampling noise
            assert abs(float(tflat[k].std()) / float(jflat[k].std()) - 1) < 0.1, k


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_forward_logits_match_jax(name):
    jcfg, tcfg = _configs(name)
    np_params = _np_tree(jtfm.init_params(jax.random.PRNGKey(0), jcfg))
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab_size, (2, 16), dtype=np.int32)
    jlogits = np.asarray(jtfm.forward(np_params, jnp.asarray(tokens), jcfg))
    tparams = params_from_numpy(np_params, tcfg, device="cpu")
    tlogits = ttfm.forward(tparams, torch.from_numpy(tokens), tcfg)
    assert tlogits.dtype == torch.float32 and tuple(tlogits.shape) == (2, 16, jcfg.vocab_size)
    np.testing.assert_allclose(tlogits.numpy(), jlogits, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("rope_style,rotary_dim", [("half", None), ("interleaved", 8), ("half", 8)])
def test_rope_matches_jax(rope_style, rotary_dim):
    jcfg = jtfm.tiny(rope_style=rope_style, rotary_dim=rotary_dim)
    tcfg = ttfm.tiny(rope_style=rope_style, rotary_dim=rotary_dim)
    x = np.random.default_rng(2).standard_normal((2, 12, 4, 16), dtype=np.float32)
    jc, js = jtfm.rope_tables(jcfg, 12)
    tc, ts = ttfm.rope_tables(tcfg, 12, "cpu")
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6)
    jout = jtfm.apply_rope(jnp.asarray(x), jc, js, jcfg)
    tout = ttfm.apply_rope(torch.from_numpy(x), tc, ts, tcfg)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=1e-5)
    # One position per row, as decode uses it.
    pos = np.array([3, 11], dtype=np.int32)
    jrow = jtfm._apply_rope_rows(jnp.asarray(x[:, 0]), jc[pos], js[pos], jcfg)
    trow = ttfm._apply_rope_rows(torch.from_numpy(x[:, 0]), tc[pos], ts[pos], tcfg)
    np.testing.assert_allclose(trow.numpy(), np.asarray(jrow), atol=1e-5)


@pytest.mark.parametrize("norm", ["rms_norm", "layer_norm"])
def test_norms_match_jax_in_bf16(norm):
    x = np.random.default_rng(3).standard_normal((3, 64), dtype=np.float32)
    scale = np.random.default_rng(4).standard_normal((64,), dtype=np.float32)
    jout = getattr(jtfm, norm)(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(scale, jnp.bfloat16), 1e-5
    )
    tout = getattr(ttfm, norm)(
        torch.from_numpy(x).bfloat16(), torch.from_numpy(scale).bfloat16(), 1e-5
    )
    assert tout.dtype == torch.bfloat16
    np.testing.assert_array_equal(tout.float().numpy(), np.asarray(jout.astype(jnp.float32)))


def test_presets_match_jax():
    for name in ("llama2_7b", "llama2_13b", "gpt_j_6b", "tiny"):
        j, t = getattr(jtfm, name)(), getattr(ttfm, name)()
        for field in ("vocab_size", "d_model", "n_layers", "n_heads", "n_kv_heads", "d_ff",
                      "rope_theta", "norm_eps", "mlp_act", "parallel_block", "rotary_dim",
                      "norm_type", "rope_style", "tie_embeddings", "head_dim", "remat",
                      "remat_policy"):
            assert getattr(j, field) == getattr(t, field), (name, field)


def test_unported_attention_raises():
    cfg = ttfm.tiny(attn_impl="ring", dtype=torch.float32)
    params = ttfm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(NotImplementedError, match="ring"):
        ttfm.forward(params, torch.zeros((1, 8), dtype=torch.long), cfg)
