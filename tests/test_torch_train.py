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
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += func is torch.ops.aten.mm.default
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("policy", [None, "dots"])
def test_remat_gives_the_same_loss_and_grads(policy, monkeypatch):
    """Each layer's forward (its flash call included) runs again in the
    backward, and the result is the one without remat; "dots" takes the
    projections' outputs from the forward instead of running them again."""
    calls = []
    real_fwd = tfa.flash_fwd
    monkeypatch.setattr(tfa, "flash_fwd", lambda *a, **kw: calls.append(1) or real_fwd(*a, **kw))
    _, tcfg, np_params, tokens = _setup()
    results = []
    for cfg in (tcfg, tcfg.replace(remat=True, remat_policy=policy)):
        del calls[:]
        params = _leaf_params(np_params, cfg)
        with _CountMatmuls() as mm:
            loss = ttfm.next_token_loss(params, torch.from_numpy(tokens), cfg)
            loss.backward()
        results.append((loss.detach(), [t.grad for t in ttfm.tree_leaves(params)], len(calls),
                        mm.n))
    (plain_loss, plain_grads, plain_calls, plain_mm), (loss, grads, n_calls, n_mm) = results
    assert plain_calls == tcfg.n_layers and n_calls == 2 * tcfg.n_layers
    # None runs the projections again (all but the last of each layer,
    # whose output no backward reads); "dots" runs none of them again.
    assert n_mm > plain_mm if policy is None else n_mm == plain_mm
    assert torch.equal(loss, plain_loss)
    for a, b in zip(grads, plain_grads):
        torch.testing.assert_close(a, b, atol=1e-7, rtol=0)


def test_remat_is_off_without_grad():
    _, tcfg, np_params, tokens = _setup()
    cfg = tcfg.replace(remat=True, remat_policy="hot")  # would raise under grad
    with torch.no_grad():
        logits = ttfm.forward(params_from_numpy(np_params, cfg, device="cpu"),
                              torch.from_numpy(tokens), cfg)
    assert logits.shape == (2, 16, cfg.vocab_size)


@pytest.mark.parametrize("policy", ["attn", "hot"])
def test_unported_remat_policies_raise(policy):
    _, tcfg, np_params, tokens = _setup()
    cfg = tcfg.replace(remat=True, remat_policy=policy)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ttfm.next_token_loss(_leaf_params(np_params, cfg), torch.from_numpy(tokens), cfg)


def test_zero_axis_raises():
    with pytest.raises(NotImplementedError, match="ZeRO"):
        ttfm.build_train_step(ttfm.tiny(), ttfm.adamw(1e-4), device="cpu", zero_axis="data")
