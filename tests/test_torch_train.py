"""Parity of the port's training path with the JAX package's.

One param tree, made by the JAX package's init_params and moved across as
numpy, and the same seeded tokens go through both packages on the CPU in
float32, JAX at `highest` matmul precision (its flash kernels in interpret
mode). Tolerances, each with its reason:
  - loss: 1e-5 absolute (fp32 sums over a 256-word vocabulary, loss ~ 5.6);
  - gradients: 1e-5 absolute (largest entries ~ 0.1);
  - params after 3 AdamW steps at lr 1e-3: 3e-5 absolute, and the losses of
    steps 2 and 3: 1e-5 relative. Adam divides by sqrt(v), so an entry whose
    gradient is near fp32 noise moves by a visible share of lr either way
    (3.2e-6 measured after one step, in w_down); the next losses inherit
    that (2.4e-6 relative measured at step 3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ray_tpu.models import transformer as jtfm
from ray_tpu_torch.ops import flash_attention as tfa
from ray_tpu_torch.models import transformer as ttfm
from ray_tpu_torch.models.convert import params_from_numpy, params_to_numpy

LOSS_TOL = 1e-5
GRAD_TOL = 1e-5
LR = 1e-3
PARAM_TOL = 3e-5
TRAJECTORY_RTOL = 1e-5


@pytest.fixture(autouse=True)
def _exact_matmuls():
    old = jax.config.jax_default_matmul_precision
    jax.config.update("jax_default_matmul_precision", "highest")
    yield
    jax.config.update("jax_default_matmul_precision", old)


def _setup(seq=16, seed=0, **kw):
    jcfg = jtfm.tiny(dtype=jnp.float32, attn_impl="full", **kw)
    tcfg = ttfm.tiny(dtype=torch.float32, attn_impl="full", **kw)
    np_params = jax.tree_util.tree_map(np.asarray, jtfm.init_params(jax.random.PRNGKey(seed), jcfg))
    tokens = np.random.default_rng(seed).integers(0, jcfg.vocab_size, (2, seq), dtype=np.int32)
    return jcfg, tcfg, np_params, tokens


def _leaf_params(np_params, tcfg):
    params = params_from_numpy(np_params, tcfg, device="cpu")
    for t in ttfm.tree_leaves(params):
        t.requires_grad_(True)
    return params


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _flat(sub, f"{prefix}/{key}").items()}
    return {prefix: np.asarray(tree)}


def _assert_trees_close(jtree, ttree, atol):
    a, b = _flat(jtree), _flat(ttree)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_allclose(b[k], a[k], atol=atol, rtol=0, err_msg=k)


@pytest.mark.parametrize("with_mask", [False, True])
def test_next_token_loss_matches_jax(with_mask):
    jcfg, tcfg, np_params, tokens = _setup()
    mask = np.random.default_rng(5).integers(0, 2, tokens.shape).astype(np.int32)
    jmask = jnp.asarray(mask) if with_mask else None
    tmask = torch.from_numpy(mask) if with_mask else None
    jloss = jtfm.next_token_loss(np_params, jnp.asarray(tokens), jcfg, mask=jmask)
    tloss = ttfm.next_token_loss(params_from_numpy(np_params, tcfg, device="cpu"),
                                 torch.from_numpy(tokens), tcfg, mask=tmask)
    assert tloss.dim() == 0 and tloss.dtype == torch.float32
    assert abs(float(tloss) - float(jloss)) < LOSS_TOL


def test_loss_gradient_matches_jax():
    jcfg, tcfg, np_params, tokens = _setup()
    jloss, jgrads = jax.value_and_grad(jtfm.next_token_loss)(np_params, jnp.asarray(tokens), jcfg)
    params = _leaf_params(np_params, tcfg)
    tloss = ttfm.next_token_loss(params, torch.from_numpy(tokens), tcfg)
    tloss.backward()
    assert abs(tloss.item() - float(jloss)) < LOSS_TOL
    _assert_trees_close(jgrads, ttfm.map_tree(lambda t: t.grad.numpy(), params), GRAD_TOL)


def test_param_count_and_flops_per_token_match_jax():
    for kw in ({}, dict(mlp_act="gelu", parallel_block=True, tie_embeddings=True)):
        jcfg, tcfg, np_params, _ = _setup(**kw)
        tparams = params_from_numpy(np_params, tcfg, device="cpu")
        assert ttfm.param_count(tparams) == jtfm.param_count(np_params)
    for name in ("llama2_7b", "llama2_13b", "gpt_j_6b", "tiny"):
        for seq in (1, 256, 2048):
            jcfg, tcfg = getattr(jtfm, name)(), getattr(ttfm, name)()
            assert ttfm.flops_per_token(tcfg, seq) == jtfm.flops_per_token(jcfg, seq)


def test_three_step_adamw_trajectory_matches_jax():
    jcfg, tcfg, np_params, tokens = _setup()
    jinit, jstep = jtfm.build_train_step(jcfg, optax.adamw(LR), None, donate=False)
    jparams = jax.tree_util.tree_map(jnp.asarray, np_params)
    jopt = optax.adamw(LR).init(jparams)
    jlosses = []
    for _ in range(3):
        jparams, jopt, loss = jstep(jparams, jopt, jnp.asarray(tokens))
        jlosses.append(float(loss))

    _, tstep = ttfm.build_train_step(tcfg, ttfm.adamw(LR), device="cpu")
    tparams = _leaf_params(np_params, tcfg)
    topt = ttfm.adamw(LR)(ttfm.tree_leaves(tparams))
    tlosses = [float(tstep(tparams, topt, torch.from_numpy(tokens))) for _ in range(3)]

    assert jlosses[2] < jlosses[0]  # the steps did train
    assert abs(tlosses[0] - jlosses[0]) < LOSS_TOL  # same params: the first loss is tight
    np.testing.assert_allclose(tlosses, jlosses, rtol=TRAJECTORY_RTOL, atol=0)
    _assert_trees_close(jax.tree_util.tree_map(np.asarray, jparams), params_to_numpy(tparams),
                        PARAM_TOL)


def test_init_state_gives_leaf_params_and_optax_defaults():
    init, step = ttfm.build_train_step(ttfm.tiny(dtype=torch.float32), ttfm.adamw(1e-4),
                                       device="cpu")
    params, opt = init(torch.Generator().manual_seed(0))
    leaves = ttfm.tree_leaves(params)
    assert all(t.is_leaf and t.requires_grad for t in leaves)
    group = opt.param_groups[0]
    assert group["params"] == leaves
    assert (group["lr"], group["betas"], group["eps"], group["weight_decay"]) == (
        1e-4, (0.9, 0.999), 1e-8, 1e-4)
    before = [t.detach().clone() for t in leaves]
    loss = step(params, opt, torch.zeros((1, 8), dtype=torch.long))
    assert loss.dim() == 0 and not loss.requires_grad
    assert all(not torch.equal(a, b) for a, b in zip(before, leaves))  # updated in place
    assert opt.state[leaves[0]]["exp_avg"].dtype == leaves[0].dtype


class _CountMatmuls(TorchDispatchMode):
    """Counts the flash forward op and records each mm's weight shape."""

    def __init__(self):
        super().__init__()
        self.mm_weights = []
        self.flash = 0

    @property
    def n(self):
        return len(self.mm_weights)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.mm.default:
            self.mm_weights.append(tuple(args[1].shape))
        self.flash += func is torch.ops.ray_tpu_torch.flash_fwd.default
        return func(*args, **(kwargs or {}))


GPTJ_TINY = dict(mlp_act="gelu", parallel_block=True, norm_type="layer",
                 rope_style="interleaved", rotary_dim=8)


@pytest.mark.parametrize("policy", [None, "dots", "attn", "hot"])
def test_remat_gives_the_same_loss_and_grads(policy, monkeypatch):
    _check_remat(policy, {}, monkeypatch)


@pytest.mark.parametrize("policy", [None, "dots", "attn", "hot"])
def test_remat_under_the_gptj_block_gives_the_same_loss_and_grads(policy, monkeypatch):
    _check_remat(policy, GPTJ_TINY, monkeypatch)


def _check_remat(policy, arch, monkeypatch):
    """Each layer recomputes in the backward what its policy does not keep,
    and the result is the one without remat:
      None: the whole layer, the flash forward and the projections too (all
        but the last of each layer, whose output no backward reads);
      "dots": everything but the projections, the flash forward included;
      "attn": everything but the flash forward: every projection but w_down;
      "hot": exactly the gate/up products (2 per layer for swiglu, 1 for
        gelu), and no projection or flash forward."""
    calls = []
    real_fwd = tfa.flash_fwd
    monkeypatch.setattr(tfa, "flash_fwd", lambda *a, **kw: calls.append(1) or real_fwd(*a, **kw))
    _, tcfg, np_params, tokens = _setup(**arch)
    results = []
    for cfg in (tcfg, tcfg.replace(remat=True, remat_policy=policy)):
        del calls[:]
        params = _leaf_params(np_params, cfg)
        with _CountMatmuls() as mm:
            loss = ttfm.next_token_loss(params, torch.from_numpy(tokens), cfg)
            loss.backward()
        assert mm.flash == len(calls)  # every op call launched: none came from a cache
        results.append((loss.detach(), [t.grad for t in ttfm.tree_leaves(params)], len(calls),
                        mm.mm_weights))
    (plain_loss, plain_grads, plain_calls, plain_mm), (loss, grads, n_calls, n_mm) = results
    L = tcfg.n_layers
    assert plain_calls == L and n_calls == (2 * L if policy in (None, "dots") else L)
    d, f = tcfg.d_model, tcfg.d_ff
    gate_up = [(d, f)] * (2 if tcfg.mlp_act == "swiglu" else 1)
    projections = [(d, tcfg.n_heads * tcfg.head_dim)] + [(d, tcfg.n_kv_heads * tcfg.head_dim)] * 2
    extra = list(n_mm)
    for w in plain_mm:
        extra.remove(w)
    want = {None: None, "dots": [], "attn": (projections + [(d, d)] + gate_up) * L,
            "hot": gate_up * L}[policy]
    if policy is None:
        assert len(extra) > 0
    else:
        assert sorted(extra) == sorted(want)
    assert torch.equal(loss, plain_loss)
    for a, b in zip(grads, plain_grads):
        if b is None:  # mlp_norm under the parallel block: unused
            assert a is None
            continue
        torch.testing.assert_close(a, b, atol=1e-7, rtol=0)


def test_remat_is_off_without_grad():
    _, tcfg, np_params, tokens = _setup()
    cfg = tcfg.replace(remat=True, remat_policy="hot")
    with torch.no_grad():
        logits = ttfm.forward(params_from_numpy(np_params, cfg, device="cpu"),
                              torch.from_numpy(tokens), cfg)
    assert logits.shape == (2, 16, cfg.vocab_size)


@pytest.mark.parametrize("policy", ["attn", "hot"])
def test_unported_remat_policies_raise(policy):
    """"attn" and "hot" raised until the port had them; now the loss and
    gradients under each match JAX's value_and_grad under the same policy
    (the tolerances of test_loss_gradient_matches_jax), and only a policy
    the JAX package lacks raises."""
    assert ttfm.HOT_SAVE_NAMES == jtfm.HOT_SAVE_NAMES
    jcfg, tcfg, np_params, tokens = _setup()
    jcfg = jcfg.replace(remat=True, remat_policy=policy)
    cfg = tcfg.replace(remat=True, remat_policy=policy)
    jloss, jgrads = jax.value_and_grad(jtfm.next_token_loss)(np_params, jnp.asarray(tokens), jcfg)
    params = _leaf_params(np_params, cfg)
    tloss = ttfm.next_token_loss(params, torch.from_numpy(tokens), cfg)
    tloss.backward()
    assert abs(tloss.item() - float(jloss)) < LOSS_TOL
    _assert_trees_close(jgrads, ttfm.map_tree(lambda t: t.grad.numpy(), params), GRAD_TOL)
    with pytest.raises(ValueError, match="remat_policy"):
        bad = cfg.replace(remat_policy=policy + "_x")
        ttfm.next_token_loss(_leaf_params(np_params, bad), torch.from_numpy(tokens), bad)


def test_zero_axis_raises():
    """The ZeRO step needs a torch.distributed process group (its parity
    with the JAX package's is tests/test_torch_zero.py); without one,
    build_train_step(zero_axis=...) raises."""
    import torch.distributed as dist

    assert not dist.is_initialized()
    with pytest.raises((RuntimeError, ValueError), match="process group"):
        ttfm.build_train_step(ttfm.tiny(), ttfm.adamw(1e-4), device="cpu", zero_axis="data")
