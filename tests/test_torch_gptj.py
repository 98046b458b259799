"""Head dim 256 (GPT-J's): parity of the port with the JAX package.

The same seeded numpy inputs go through the JAX package (its Pallas flash
kernels in interpret mode on the CPU, at `highest` matmul precision) and
through the port's CPU path, which runs each CUDA kernel's plain version:

- attention at head_dim 256: `flash_attention` and
  `flash_attention_with_lse` forward and their gradients, MHA and GQA, in
  float32 within 2e-5 max-abs (the port's other attention tests' tolerance);
  the bfloat16 forward entry by entry within 2**-7 x (|ref| + rms(ref)) and
  lse within 1e-5, and the bfloat16 backward's plain versions against the
  Pallas backward kernels within 2**-6, as at the smaller head dims;
- a 2-layer GPT-J config at head_dim 256 (d_model 512, 2 heads; gelu,
  parallel block, LayerNorm, interleaved partial RoPE): logits within 1e-4,
  the loss within 1e-5 and its gradient leaf by leaf within 1e-5, and greedy
  paged decoding exactly, with the JAX package's params carried across by
  `models/convert.py`.

The CUDA kernels at head_dim 256 are held against these plain versions on
the card (tests/test_torch_cuda_kernels.py, chip_smoke.py).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import transformer as jtfm
from ray_tpu_torch.models import transformer as ttfm
from ray_tpu_torch.models.convert import params_from_numpy
from ray_tpu_torch.ops import flash_attention as tfa
from ray_tpu_torch.serve.llm import PagedKVAllocator, PagedLM

jfa = importlib.import_module("ray_tpu.ops.flash_attention")
TOL = 2e-5
D = 256


@pytest.fixture(autouse=True)
def _exact_matmuls():
    old = jax.config.jax_default_matmul_precision
    jax.config.update("jax_default_matmul_precision", "highest")
    yield
    jax.config.update("jax_default_matmul_precision", old)


def _inputs(b=1, s=128, h=2, kv_heads=None, seed=0):
    """q, k, v and a cotangent do at head_dim 256, float32 numpy."""
    rng = np.random.default_rng(seed)
    hk = kv_heads or h
    shapes = [(b, s, h, D), (b, s, hk, D), (b, s, hk, D), (b, s, h, D)]
    return [rng.standard_normal(sh, dtype=np.float32) for sh in shapes]


def _maxdiff(a, b):
    return float(np.max(np.abs(np.asarray(a, dtype=np.float32) - np.asarray(b, dtype=np.float32))))


def _entry_err(got, want):
    """max over entries of |got - want| / (|want| + rms(want)), the card's
    per-entry measure (chip_smoke.py `entry_err`)."""
    g, w = (np.asarray(x, dtype=np.float32) for x in (got, want))
    return float(np.max(np.abs(g - w) / (np.abs(w) + np.sqrt(np.mean(w * w)))))


def _bh(x):
    b, s, hh, d = x.shape
    return jnp.asarray(x).transpose(0, 2, 1, 3).reshape(b * hh, s, d)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("kv_heads", [None, 1], ids=["mha", "gqa"])
def test_forward_and_lse_match_jax_at_head_dim_256(causal, kv_heads):
    q, k, v, _ = _inputs(kv_heads=kv_heads)
    j = [jnp.asarray(a) for a in (q, k, v)]
    t = [torch.from_numpy(a) for a in (q, k, v)]
    jo = jfa.flash_attention(*j, causal=causal, block_q=64, block_k=64)
    to = tfa.flash_attention(*t, causal=causal)
    assert to.shape == (1, 128, 2, D)
    assert _maxdiff(jo, to) < TOL
    (jo, jl), (to, tl) = (jfa.flash_attention_with_lse(*j, causal=causal, block_q=64, block_k=64),
                          tfa.flash_attention_with_lse(*t, causal=causal))
    assert tuple(tl.shape) == (1, 2, 128) and tl.dtype == torch.float32
    assert _maxdiff(jo, to) < TOL and _maxdiff(jl, tl) < TOL


@pytest.mark.parametrize("causal,kv_heads,lse", [(True, None, False), (False, 1, False),
                                                 (True, 1, True)])
def test_grads_match_jax_at_head_dim_256(causal, kv_heads, lse):
    *qkv, do = _inputs(s=64, kv_heads=kv_heads, seed=1)
    b, s, h, _ = do.shape
    cts = [do]
    if lse:
        cts.append(np.random.default_rng(2).standard_normal((b, h, s), dtype=np.float32))
    jfn = jfa.flash_attention_with_lse if lse else jfa.flash_attention
    tfn = tfa.flash_attention_with_lse if lse else tfa.flash_attention
    out, vjp = jax.vjp(lambda q, k, v: jfn(q, k, v, causal=causal, block_q=64, block_k=64),
                       *(jnp.asarray(a) for a in qkv))
    jgrads = vjp(tuple(jnp.asarray(c) for c in cts) if lse else jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in qkv)
    tout = tfn(tq, tk, tv, causal=causal)
    tout = tout if isinstance(tout, tuple) else (tout,)
    tgrads = torch.autograd.grad(tout, (tq, tk, tv), [torch.from_numpy(c) for c in cts])
    for name, jg, tg in zip("qkv", jgrads, tgrads):
        assert tuple(jg.shape) == tuple(tg.shape), name
        assert _maxdiff(jg, tg.numpy()) < TOL, (name, _maxdiff(jg, tg.numpy()))


@pytest.mark.parametrize("kv_heads", [None, 1], ids=["mha", "gqa"])
def test_bf16_plain_versions_match_jax_kernels_at_head_dim_256(kv_heads):
    """bfloat16: the forward's plain version (`reference_flash_fwd`) and the
    backward's (`reference_flash_bwd`) against the Pallas `_fwd_kernel`,
    `_dq_kernel` and `_dkv_kernel` at head_dim 256, entry by entry."""
    q, k, v, do = (jnp.asarray(a, jnp.bfloat16) for a in _inputs(s=128, kv_heads=kv_heads, seed=3))
    b, s, h, _ = q.shape
    h_kv = k.shape[2]
    scale = D ** -0.5
    jo, jl = jfa.flash_attention_with_lse(q, k, v, causal=True, scale=scale, block_q=64,
                                          block_k=64)

    def to_torch(x):
        x = torch.from_numpy(np.array(jnp.asarray(x, jnp.float32)))
        return x.to(torch.bfloat16) if x.dim() == 4 else x

    to, tl = tfa.flash_attention_with_lse(*(to_torch(a) for a in (q, k, v)), causal=True,
                                          scale=scale)
    assert _entry_err(to.float(), np.asarray(jo.astype(jnp.float32))) <= 2 ** -7
    assert _maxdiff(jl, tl) < 1e-5
    delta = (do.astype(jnp.float32) * jo.astype(jnp.float32)).sum(-1).transpose(0, 2, 1)
    jgrads = jfa._flash_bwd_impl(
        True, scale, 64, 64, True, (h, h_kv), _bh(q), _bh(k), _bh(v), _bh(jo),
        jl.reshape(b * h, s, 1), _bh(do), delta.reshape(b * h, s, 1))
    got = tfa.reference_flash_bwd(*(to_torch(a) for a in (q, k, v, jo, jl, do, delta)),
                                  causal=True, scale=scale)
    for name, jg, hh, tg in zip(("dq", "dk", "dv"), jgrads, (h, h_kv, h_kv), got):
        assert tg.dtype == torch.bfloat16, name
        want = np.asarray(jg.astype(jnp.float32)).reshape(b, hh, s, D).transpose(0, 2, 1, 3)
        assert _entry_err(tg.float(), want) <= 2 ** -6, name


# GPT-J's block at head_dim 256, cut to 2 layers, 2 heads and a small vocab.
GPTJ_256 = dict(vocab_size=256, d_model=512, n_layers=2, n_heads=2, n_kv_heads=2, d_ff=1024,
                max_seq_len=128, remat=False)


def _gptj(seed=0):
    jcfg = jtfm.gpt_j_6b(dtype=jnp.float32, attn_impl="full", **GPTJ_256)
    tcfg = ttfm.gpt_j_6b(dtype=torch.float32, attn_impl="full", **GPTJ_256)
    assert tcfg.head_dim == D
    np_params = jax.tree_util.tree_map(np.asarray, jtfm.init_params(jax.random.PRNGKey(seed), jcfg))
    tokens = np.random.default_rng(seed).integers(0, 256, (2, 32), dtype=np.int32)
    return jcfg, tcfg, np_params, tokens


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _flat(sub, f"{prefix}/{key}").items()}
    return {prefix: np.asarray(tree)}


def test_gptj_head_dim_256_logits_loss_and_gradient_match_jax():
    jcfg, tcfg, np_params, tokens = _gptj()
    jlogits = jtfm.forward(np_params, jnp.asarray(tokens), jcfg)
    tparams = params_from_numpy(np_params, tcfg, device="cpu")
    tlogits = ttfm.forward(tparams, torch.from_numpy(tokens), tcfg)
    np.testing.assert_allclose(tlogits.detach().numpy(), np.asarray(jlogits), atol=1e-4, rtol=1e-4)

    jloss, jgrads = jax.value_and_grad(jtfm.next_token_loss)(np_params, jnp.asarray(tokens), jcfg)
    for t in ttfm.tree_leaves(tparams):
        t.requires_grad_(True)
    tloss = ttfm.next_token_loss(tparams, torch.from_numpy(tokens), tcfg)
    tloss.backward()
    assert abs(tloss.item() - float(jloss)) < 1e-5
    # The parallel block never reads ln2: JAX's gradient there is zero, torch's None.
    a, b = _flat(jgrads), _flat(ttfm.map_tree(
        lambda t: np.zeros(t.shape, np.float32) if t.grad is None else t.grad.numpy(), tparams))
    assert a.keys() == b.keys()
    for key in a:
        np.testing.assert_allclose(b[key], a[key], atol=1e-5, rtol=0, err_msg=key)


def _greedy_paged(lm, prompts, n_new, T):
    """Two sequences decoded side by side in slots 0 and 1."""
    alloc = PagedKVAllocator(lm.num_pages, T)
    seqs = [alloc.allocate(p) for p in prompts]
    out = [[lm.prefill(p, sp.pages, sp.cached_tokens)] for p, sp in zip(prompts, seqs)]
    for _ in range(n_new - 1):
        positions = []
        for p, sp, o in zip(prompts, seqs, out):
            pos = len(p) + len(o) - 1
            if pos >= sp.num_pages * T:
                alloc.extend(sp)
            positions.append(pos)
        step = lm.decode([o[-1] for o in out], positions, [sp.pages for sp in seqs])
        for o, t in zip(out, step):
            o.append(int(t))
    return out


def test_gptj_head_dim_256_greedy_paged_decode_matches_jax():
    from ray_tpu.serve.llm.model import PagedLM as JaxPagedLM

    jcfg, tcfg, np_params, _ = _gptj(seed=1)
    T = 8
    geo = dict(num_pages=16, page_tokens=T, max_slots=2, max_pages_per_seq=6)
    jlm = JaxPagedLM(jcfg, jax.tree_util.tree_map(jnp.asarray, np_params), **geo)
    tlm = PagedLM(tcfg, params_from_numpy(np_params, tcfg, device="cpu"), device="cpu", **geo)
    prompts = [[5, 17, 200, 3, 99, 42, 7, 7, 130, 12, 1], [250, 4, 4, 61]]
    got = _greedy_paged(tlm, prompts, 8, T)
    assert got == _greedy_paged(jlm, prompts, 8, T)
    assert all(len(o) == 8 and all(0 <= t < 256 for t in o) for o in got)
