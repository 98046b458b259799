"""Parity of the port's transformer on a mesh (ring and Ulysses sequence
parallelism, the GPipe pipeline, the data-parallel train step) with the JAX
package's `forward(..., mesh)`, `next_token_loss` and
`next_token_loss_pipelined` and `jax.grad` of them.

The JAX side runs on 4 of the conftest's virtual CPU devices; the port's in
one 4-rank gloo world (tests/torch_world.py) serving the whole file, every
rank passing the global tokens. Each rank's logits are held against its part
of JAX's, and its loss and every leaf's gradient against JAX's (each rank
holds the whole params and gets the global gradient). tiny() widths in
float32; tolerances as ROADMAP Queue 3 states them: logits 1e-4, the loss
and each gradient 1e-5 (absolute), a 3-step loss trajectory 1e-5
relative.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from ray_tpu.models import transformer as jtfm
from ray_tpu.parallel import MeshSpec as JMeshSpec
from ray_tpu.parallel import build_mesh as jbuild_mesh
from torch_world import World

N = 4
LOGIT_TOL = 1e-4
LOSS_TOL = 1e-5
GRAD_TOL = 1e-5


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = World(N, tmp_path_factory.mktemp("parallel_model_world"))
    yield w
    w.close()


@pytest.fixture(autouse=True)
def _exact_matmuls():
    old = jax.config.jax_default_matmul_precision
    jax.config.update("jax_default_matmul_precision", "highest")
    yield
    jax.config.update("jax_default_matmul_precision", old)


def _jmesh(**axes):
    return jbuild_mesh(JMeshSpec(**{"data": 1, **axes}), devices=jax.devices("cpu")[:N])


def _jit(fn, cfg, mesh):
    """fn(params, tokens, cfg, mesh) jitted over (params, tokens): remat's
    closed_call inside shard_map runs only under jit."""
    return jax.jit(functools.partial(fn, cfg=cfg, mesh=mesh))


def _flat(tree, prefix):
    return {"/".join([prefix] + [str(getattr(k, "key", k)) for k in path]): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _inputs(cfg_kw, np_params, tokens, **axes):
    return {"cfg": np.array(json.dumps(cfg_kw)), "tokens": tokens,
            **{f"axes/{k}": np.int64(v) for k, v in axes.items()},
            **_flat(np_params, "params")}


def _setup(seed, n_layers=2, b=2, s=64, **cfg_kw):
    jcfg = jtfm.tiny(dtype=jnp.float32, n_layers=n_layers, **cfg_kw)
    np_params = jax.tree_util.tree_map(
        np.asarray, jtfm.init_params(jax.random.PRNGKey(seed), jcfg))
    tokens = np.random.default_rng(seed).integers(0, jcfg.vocab_size, (b, s), dtype=np.int32)
    return jcfg, np_params, tokens


def _check_loss_and_grads(outs, jloss, jgrads):
    want = _flat(jgrads, "grads")
    for r, out in enumerate(outs):
        assert abs(float(out["loss"]) - float(jloss)) < LOSS_TOL, (r, float(out["loss"]),
                                                                   float(jloss))
        assert sorted(k for k in out if k.startswith("grads/")) == sorted(want)
        for k, g in want.items():
            np.testing.assert_allclose(out[k], g, rtol=0, atol=GRAD_TOL, err_msg=f"rank {r} {k}")


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
@pytest.mark.parametrize("remat", [False, True], ids=["no_remat", "remat_dots"])
def test_sequence_parallel_model_matches_jax(world, impl, remat):
    """test_models.py's ring model case and its Ulysses twin: the logits of
    each rank's positions, the loss and every leaf's gradient. GQA (4 query
    heads over 2 kv heads) repeats k/v before the ring or the all-to-all."""
    cfg_kw = {"attn_impl": impl, "remat": remat}
    jcfg, np_params, tokens = _setup(0, **cfg_kw)
    mesh = _jmesh(seq=N)
    jparams = jax.tree_util.tree_map(jnp.asarray, np_params)
    jlogits = np.asarray(_jit(jtfm.forward, jcfg, mesh)(jparams, jnp.asarray(tokens)))
    full = np.asarray(jtfm.forward(jparams, jnp.asarray(tokens), jcfg.replace(attn_impl="full")))
    np.testing.assert_allclose(jlogits, full, atol=1e-3, rtol=1e-3)  # the JAX test's check
    jloss, jgrads = _jit(jax.value_and_grad(jtfm.next_token_loss), jcfg, mesh)(
        jparams, jnp.asarray(tokens))
    outs = world.run("model_loss", {**_inputs(cfg_kw, np_params, tokens, seq=N),
                                    "pipelined": np.bool_(False)})
    for out, block in zip(outs, np.split(jlogits, N, axis=1)):
        np.testing.assert_allclose(out["logits"], block, rtol=0, atol=LOGIT_TOL)
    _check_loss_and_grads(outs, jloss, jgrads)


@pytest.mark.parametrize("remat", [False, True], ids=["no_remat", "remat"])
def test_pipelined_loss_matches_jax(world, remat):
    """forward_pipelined's logits, next_token_loss_pipelined and every leaf's
    gradient over 4 stages of one layer each, 4 microbatches."""
    cfg_kw = {"remat": remat}
    jcfg, np_params, tokens = _setup(1, n_layers=4, b=4, s=32, **cfg_kw)
    mesh = _jmesh(stage=N)
    jparams = jax.tree_util.tree_map(jnp.asarray, np_params)
    jlogits = np.asarray(_jit(jtfm.forward_pipelined, jcfg, mesh)(jparams, jnp.asarray(tokens)))
    jloss, jgrads = _jit(jax.value_and_grad(jtfm.next_token_loss_pipelined), jcfg, mesh)(
        jparams, jnp.asarray(tokens))
    outs = world.run("model_loss", {**_inputs({**cfg_kw, "n_layers": 4}, np_params, tokens,
                                              stage=N), "pipelined": np.bool_(True)})
    for out in outs:
        np.testing.assert_allclose(out["logits"], jlogits, rtol=0, atol=LOGIT_TOL)
    _check_loss_and_grads(outs, jloss, jgrads)


def test_data_and_sequence_parallel_train_step_matches_jax(world):
    """build_train_step's plain step on data=2 x seq=2 with ring attention:
    3 AdamW steps' losses against the JAX step on the same mesh (1e-5
    relative, as tests/test_torch_zero.py holds a trajectory), the first
    step's gradient of every leaf against jax.grad, and every rank's params
    after the steps bitwise equal (the replicas stay in step). The params
    are not held to JAX's: Adam divides each gradient entry by its own
    magnitude, so where an entry is near zero a 1e-7 difference in its
    summation order moves the update by up to lr."""
    cfg_kw = {"attn_impl": "ring"}
    jcfg, np_params, tokens = _setup(2, b=4, s=32, **cfg_kw)
    lr = 1e-3
    tx = optax.adamw(lr)
    _, jstep = jtfm.build_train_step(jcfg, tx, _jmesh(data=2, seq=2), donate=False)
    jparams = jax.tree_util.tree_map(jnp.asarray, np_params)
    jopt = tx.init(jparams)
    jlosses = []
    for _ in range(3):
        jparams, jopt, loss = jstep(jparams, jopt, jnp.asarray(tokens))
        jlosses.append(float(loss))
    outs = world.run("train_steps", {**_inputs(cfg_kw, np_params, tokens, data=2, seq=2),
                                     "lr": np.float64(lr)})
    jgrads = _jit(jax.grad(jtfm.next_token_loss), jcfg, _jmesh(data=2, seq=2))(
        jax.tree_util.tree_map(jnp.asarray, np_params), jnp.asarray(tokens))
    for out in outs:
        assert abs(out["losses"][0] - jlosses[0]) < LOSS_TOL
        np.testing.assert_allclose(out["losses"], jlosses, rtol=LOSS_TOL, atol=0)
        for k, g in _flat(jgrads, "grads").items():
            np.testing.assert_allclose(out[k], g, rtol=0, atol=GRAD_TOL, err_msg=k)
        for k in (k for k in out if k.startswith("params/")):
            np.testing.assert_array_equal(out[k], outs[0][k], err_msg=k)


def test_tensor_dim_is_refused(world):
    """Once refused, now a parity case: on stage=2 x tensor=2, forward (the
    tensor split of plain params: every rank whole, rows and heads
    replicated) and forward_pipelined (the stages replicated over "tensor",
    as JAX's stage function runs with mesh=None under a shard_map over
    "stage" only): logits, loss and every leaf's gradient against JAX's."""
    jcfg, np_params, tokens = _setup(3, s=16, b=4)
    mesh = _jmesh(stage=2, tensor=2)
    jparams = jax.tree_util.tree_map(jnp.asarray, np_params)
    for pipelined, fwd, loss_fn in ((False, jtfm.forward, jtfm.next_token_loss),
                                    (True, jtfm.forward_pipelined,
                                     jtfm.next_token_loss_pipelined)):
        jlogits = np.asarray(_jit(fwd, jcfg, mesh)(jparams, jnp.asarray(tokens)))
        jloss, jgrads = _jit(jax.value_and_grad(loss_fn), jcfg, mesh)(jparams,
                                                                     jnp.asarray(tokens))
        outs = world.run("model_loss", {**_inputs({}, np_params, tokens, stage=2, tensor=2),
                                        "pipelined": np.bool_(pipelined)})
        for out in outs:
            np.testing.assert_allclose(out["logits"], jlogits, rtol=0, atol=LOGIT_TOL)
        _check_loss_and_grads(outs, jloss, jgrads)
