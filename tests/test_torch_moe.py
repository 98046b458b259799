"""Parity of the port's Switch MoE (ray_tpu_torch/models/moe.py) with the
JAX package's (ray_tpu/models/moe.py): tests/test_models.py::TestMoE's three
cases on both packages with the same weights (moe_params_from_numpy), then
expert parallelism in one 4-rank gloo world (tests/torch_world.py) against
JAX's unsharded moe_apply and jax.grad of sum(y * w) + aux.

Each rank passes its block of the tokens (TOKEN_AXES) and params laid out by
EXPERT_RULES composed with the transformer's rules; it is held to its rows
of JAX's y and of x's gradient, to JAX's aux loss, and to its shard of each
param's gradient (the index JAX's NamedSharding gives device r, rank r
sitting at the same mesh coordinate). Tolerances: JAX's own 2e-4 relative
and 2e-5 absolute; the aux loss 1e-6.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import moe as jmoe
from ray_tpu.parallel import MeshSpec as JMeshSpec
from ray_tpu.parallel import build_mesh as jbuild_mesh
from ray_tpu.parallel.sharding import TRANSFORMER_RULES as JTRANSFORMER_RULES
from ray_tpu.parallel.sharding import tree_shardings as jtree_shardings
from ray_tpu_torch.models import moe
from ray_tpu_torch.models.convert import moe_params_from_numpy
from torch_world import World

RTOL, ATOL, AUX_TOL = 2e-4, 2e-5, 1e-6


@pytest.fixture(autouse=True)
def _exact_matmuls():
    old = jax.config.jax_default_matmul_precision
    jax.config.update("jax_default_matmul_precision", "highest")
    yield
    jax.config.update("jax_default_matmul_precision", old)


def _both(d_model, d_ff, n_experts, seed=0, **kw):
    """(JAX config, port config, numpy params, port params) from one seed."""
    jcfg = jmoe.MoEConfig(d_model=d_model, d_ff=d_ff, n_experts=n_experts, **kw)
    cfg = moe.MoEConfig(d_model=d_model, d_ff=d_ff, n_experts=n_experts, **kw)
    np_params = {k: np.asarray(v) for k, v in
                 jmoe.init_moe_params(jax.random.PRNGKey(seed), jcfg).items()}
    return jcfg, cfg, np_params, moe_params_from_numpy(np_params, cfg, device="cpu")


def test_matches_per_token_expert_reference():
    """TestMoE's first case: capacity 12 >= all tokens, each token through
    its argmax expert times its gate, on both packages."""
    jcfg, cfg, np_params, params = _both(8, 16, 4)
    x = np.array(jax.random.normal(jax.random.PRNGKey(1), (2, 6, 8)))
    jy, jaux = jmoe.moe_apply(np_params, jnp.asarray(x), jcfg, capacity=12)
    y, aux = moe.moe_apply(params, torch.from_numpy(x), cfg, capacity=12)
    toks, router = x.reshape(-1, 8), np_params["router"]
    probs = np.asarray(jax.nn.softmax(jnp.asarray(toks @ router), axis=-1))
    ref = np.zeros_like(toks)
    for n in range(toks.shape[0]):
        e = int(np.argmax(probs[n]))
        h = np.asarray(jax.nn.gelu(jnp.asarray(toks[n] @ np_params["w_up"][e])))
        ref[n] = (h @ np_params["w_down"][e]) * probs[n, e]
    for got in (np.asarray(jy), y.numpy()):
        np.testing.assert_allclose(got.reshape(-1, 8), ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=RTOL, atol=ATOL)
    assert np.isfinite(float(aux)) and float(aux) > 0
    assert abs(float(aux) - float(jaux)) < AUX_TOL


def test_overflow_tokens_pass_through():
    """TestMoE's second case: identical tokens all route to one expert, and
    capacity 1 passes the rest through unchanged, on both packages."""
    jcfg, cfg, np_params, params = _both(4, 8, 2)
    jy, jaux = jmoe.moe_apply(np_params, jnp.ones((1, 5, 4)), jcfg, capacity=1)
    y, aux = moe.moe_apply(params, torch.ones((1, 5, 4)), cfg, capacity=1)
    np.testing.assert_allclose(y[0, -1].numpy(), np.ones(4), rtol=1e-5)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=RTOL, atol=ATOL)
    assert abs(float(aux) - float(jaux)) < AUX_TOL


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = World(4, tmp_path_factory.mktemp("moe_world"))
    yield w
    w.close()


def _jax_grads(jcfg, np_params, x, w, capacity=None):
    """JAX's unsharded (y, aux) and the gradient of sum(y * w) + aux for the
    params and x."""

    def loss(p, xx):
        y, aux = jmoe.moe_apply(p, xx, jcfg, capacity=capacity)
        return jnp.sum(y * w) + aux, (y, aux)

    (_, (y, aux)), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, np_params), jnp.asarray(x))
    return np.asarray(y), float(aux), {k: np.asarray(v) for k, v in gp.items()}, np.asarray(gx)


def _dropped(np_params, x, n_experts, capacity):
    """Tokens past their expert's capacity, in JAX's routing."""
    idx = np.argmax(x.reshape(-1, x.shape[-1]) @ np_params["router"], axis=-1)
    counts = np.bincount(idx, minlength=n_experts)
    return int(np.maximum(counts - capacity, 0).sum())


def _run_world(world, axes, capacity_factor, seed, capacity=None):
    """The sharded port in the world against unsharded JAX; returns the
    number of dropped tokens."""
    jcfg, cfg, np_params, _ = _both(16, 32, 8, seed=seed, capacity_factor=capacity_factor)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((8, 8, 16)).astype(np.float32)
    w = rng.standard_normal((8, 8, 16)).astype(np.float32)
    jy, jaux, jgp, jgx = _jax_grads(jcfg, np_params, x, w, capacity)
    inputs = {"cfg": np.array(json.dumps({"d_model": 16, "d_ff": 32, "n_experts": 8,
                                          "capacity_factor": capacity_factor})),
              "x": x, "w": w, **{f"axes/{k}": np.int64(v) for k, v in axes.items()},
              **{f"params/{k}": v for k, v in np_params.items()}}
    if capacity is not None:
        inputs["capacity"] = np.int64(capacity)
    outs = world.run("moe_case", inputs)
    jmesh = jbuild_mesh(JMeshSpec(**{"data": 1, **axes}), devices=jax.devices("cpu")[:4])
    shardings = jtree_shardings({"moe": np_params}, jmesh,
                                tuple(jmoe.EXPERT_RULES) + tuple(JTRANSFORMER_RULES))["moe"]
    for r, (out, dev) in enumerate(zip(outs, jmesh.devices.flat)):
        rows = slice(*out["rows"])
        np.testing.assert_allclose(out["y"], jy[rows], rtol=RTOL, atol=ATOL, err_msg=f"rank {r}")
        assert abs(float(out["aux"]) - jaux) < AUX_TOL, (r, float(out["aux"]), jaux)
        np.testing.assert_allclose(out["dx"], jgx[rows], rtol=RTOL, atol=ATOL,
                                   err_msg=f"rank {r} dx")
        assert bool(out["same_placements"]), r
        for k, g in jgp.items():
            idx = shardings[k].devices_indices_map(g.shape)[dev]
            np.testing.assert_allclose(out[f"grads/{k}"], g[idx], rtol=RTOL, atol=ATOL,
                                       err_msg=f"rank {r} grads/{k}")
    n = x.shape[0] * x.shape[1]
    C = capacity if capacity is not None else max(1, int(capacity_factor * n / 8))
    return _dropped(np_params, x, 8, C)


def test_expert_sharded_execution(world):
    """TestMoE's third case in the port: experts over "expert", the tokens
    over data x expert (data=2 x expert=2), against unsharded JAX; with
    capacity factor 0.5 the global capacity positions decide which tokens
    drop."""
    assert _run_world(world, {"data": 2, "expert": 2}, 0.5, seed=1) > 0


@pytest.mark.parametrize("axes,capacity_factor", [
    ({"expert": 4}, 1.25),
    ({"expert": 4}, 0.5),
    ({"expert": 2, "tensor": 2}, 1.0),
], ids=["expert4", "expert4_drops", "expert2_tensor2"])
def test_sharded_moe_matches_jax(world, axes, capacity_factor):
    """y, the aux loss and every gradient shard at expert=4 (64 tokens, 16
    and 2 of the 8 experts per rank) and expert=2 x tensor=2 (each expert's
    d_ff split over "tensor")."""
    dropped = _run_world(world, axes, capacity_factor, seed=2)
    if capacity_factor < 1:
        assert dropped > 0


def test_explicit_capacity_over_a_mesh(world):
    """An explicit capacity (not from the factor) over data=2 x expert=2."""
    assert _run_world(world, {"data": 2, "expert": 2}, 1.25, seed=3, capacity=3) > 0
