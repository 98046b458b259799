"""Parity of the port's parallel layer (ray_tpu_torch/parallel) with the JAX
package's (ray_tpu/parallel): every case of tests/test_parallel.py, and the
collectives' gradients.

The JAX function runs on the conftest's virtual CPU devices (4 of them here;
the Pallas kernels in interpret mode, as the JAX package's tests run them);
the port runs in one 4-rank gloo world of subprocesses
(tests/torch_world.py, tests/torch_parallel_worker.py) that serves the whole
file, on the kernels' plain versions. Both take the same numpy inputs from
a seed; where JAX takes the global array, each rank passes its shard, and
each rank's output is held against its slice of JAX's. Tolerances: 2e-5
for attention and its gradients (ROADMAP Queue 3), and the pipeline's; the
collectives 1e-6 (sums of a few fp32 values, in another order at most).
"""

import ast
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh as JMesh
from jax.sharding import PartitionSpec as JP

from ray_tpu.parallel import MeshSpec as JMeshSpec
from ray_tpu.parallel import build_mesh as jbuild_mesh
from ray_tpu.parallel import collectives as jcol
from ray_tpu.parallel import mesh_shape as jmesh_shape
from ray_tpu.parallel import pipeline as jpipe
from ray_tpu.parallel import (ring_attention as jring, shard_batch as jshard_batch,
                              shard_tree as jshard_tree, single_device_mesh as jsingle,
                              spec_for_path as jspec_for_path, ulysses_attention as julysses)
from ray_tpu.parallel.sharding import TRANSFORMER_RULES as JRULES
from ray_tpu_torch import parallel as par
from ray_tpu_torch.parallel.mesh import AXIS_ORDER, PartitionSpec, placements
from torch_world import World

N = 4
ATTN_TOL = 2e-5
COLL_TOL = 1e-6


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = World(N, tmp_path_factory.mktemp("parallel_world"))
    yield w
    w.close()


@pytest.fixture(autouse=True)
def _exact_matmuls():
    old = jax.config.jax_default_matmul_precision
    jax.config.update("jax_default_matmul_precision", "highest")
    yield
    jax.config.update("jax_default_matmul_precision", old)


def _devices(n=N):
    return jax.devices("cpu")[:n]


def _jmesh(n=N, **axes):
    return jbuild_mesh(JMeshSpec(**{"data": 1, **axes}), devices=_devices(n))


def _axes(**axes):
    return {f"axes/{k}": np.int64(v) for k, v in axes.items()}


def _by_rank(global_out, n=N):
    """A global [n * k, ...] array as each rank's block [n, k, ...]."""
    a = np.asarray(global_out)
    return a.reshape((n, a.shape[0] // n) + a.shape[1:])


def _seq_blocks(a, n=N):
    """Each rank's sequence shard (dim 1) of a global [b, s, ...] array."""
    return np.split(np.asarray(a), n, axis=1)


# ------------------------------------------------------------------ mesh


@pytest.fixture(scope="module")
def mesh_outs(world):
    return world.run("mesh_cases", {"unused": np.zeros(1)})


def test_mesh_resolution_wildcard(mesh_outs):
    jm = jbuild_mesh(JMeshSpec(data=-1, tensor=2), devices=_devices())
    want = jmesh_shape(jm)
    assert want["data"] == 2 and want["tensor"] == 2
    for r, out in enumerate(mesh_outs):
        assert {k: int(out[f"shape/{k}"]) for k in AXIS_ORDER} == want
        coords = dict(zip(jm.axis_names, np.argwhere(jm.devices == _devices()[r])[0]))
        assert int(out["data_parallel_rank"]) == coords["data"] * want["fsdp"] + coords["fsdp"]
        assert int(out["host_local_device_count"]) == 1


def test_mesh_axis_order_canonical(mesh_outs):
    jm = jbuild_mesh(JMeshSpec(data=2, fsdp=2), devices=_devices())
    for out in mesh_outs:
        assert tuple(out["axis_names"]) == tuple(jm.axis_names) == AXIS_ORDER


def test_mesh_bad_sizes(mesh_outs):
    with pytest.raises(ValueError):
        jbuild_mesh(JMeshSpec(data=3, tensor=2), devices=_devices())  # 6 does not divide 4
    with pytest.raises(ValueError):
        jbuild_mesh(JMeshSpec(data=-1, seq=-1), devices=_devices())
    with pytest.raises(ValueError):
        jsingle()  # a one-device mesh over the conftest's 8 devices
    for out in mesh_outs:
        assert all(bool(out[f"raised/{k}"]) for k in ("bad_sizes", "two_wild", "single"))


# ----------------------------------------------------------- collectives

# op -> (JAX per-shard body, output block shape per rank from x's [2, 4])
_JAX_OPS = {
    "psum": lambda x: jcol.psum(x, "seq"),
    "pmean": lambda x: jcol.pmean(x, "seq"),
    "ring": lambda x: jcol.ring_permute(x, "seq", shift=1),
    "ring_back": lambda x: jcol.ring_permute(x, "seq", shift=-1),
    "pbroadcast": lambda x: jcol.pbroadcast(x, "seq", root=1),
    "all_gather": lambda x: jcol.all_gather(x, "seq", gather_dim=1),
    "reduce_scatter": lambda x: jcol.reduce_scatter(x, "seq", scatter_dim=1),
    "all_to_all": lambda x: jcol.all_to_all(x, "seq", split_dim=1, concat_dim=0),
}
_OUT_SHAPES = {"all_gather": (8, 16), "reduce_scatter": (8, 1), "all_to_all": (32, 1)}


def _collective_inputs():
    rng = np.random.default_rng(11)
    x = rng.standard_normal((8, 4)).astype(np.float32)
    ws = {name: rng.standard_normal(_OUT_SHAPES.get(name, (8, 4))).astype(np.float32)
          for name in _JAX_OPS}
    return x, ws


@pytest.fixture(scope="module")
def collective_outs(world):
    x, ws = _collective_inputs()
    inputs = {"x": _by_rank(x), "w": _by_rank(ws["psum"])}
    inputs.update({f"w_{k}": _by_rank(ws[k]) for k in ("all_gather", "reduce_scatter",
                                                         "all_to_all")})
    # the ops sharing "w" read the same weights
    for k in ("pmean", "ring", "ring_back", "pbroadcast"):
        ws[k] = ws["psum"]
    return world.run("collective_grads", inputs), x, ws


@pytest.mark.parametrize("op", list(_JAX_OPS))
def test_collective_and_its_gradient_match_jax(collective_outs, op):
    """Each rank's output and x's gradient under loss sum(op(x) * w) against
    jax.grad through shard_map(check_vma=False), outputs mapped over "seq"."""
    outs, x, ws = collective_outs
    mesh = JMesh(np.array(_devices()), ("seq",))
    f = jcol.shard_map(_JAX_OPS[op], mesh, in_specs=(JP("seq"),), out_specs=JP("seq"))
    y = f(jnp.asarray(x))
    g = jax.grad(lambda x: jnp.sum(f(x) * ws[op]))(jnp.asarray(x))
    for r, out in enumerate(outs):
        np.testing.assert_allclose(out[f"y/{op}"], _by_rank(y)[r], rtol=0, atol=COLL_TOL)
        np.testing.assert_allclose(out[f"g/{op}"], _by_rank(g)[r], rtol=0, atol=COLL_TOL)


def test_pmax_and_axis_queries_match_jax(collective_outs):
    """pmax's value, and no gradient (lax.pmax has no differentiation rule);
    one_hot_rank, axis_index and axis_size."""
    outs, x, _ = collective_outs
    mesh = JMesh(np.array(_devices()), ("seq",))
    f = jcol.shard_map(lambda x: jcol.pmax(x, "seq"), mesh, in_specs=(JP("seq"),),
                       out_specs=JP("seq"))
    with pytest.raises(NotImplementedError):
        jax.grad(lambda x: jnp.sum(f(x)))(jnp.asarray(x))
    one_hot = jcol.shard_map(lambda x: jcol.one_hot_rank("seq")[None], mesh,
                             in_specs=(JP("seq"),), out_specs=JP("seq"))(jnp.zeros((N, 1)))
    for r, out in enumerate(outs):
        np.testing.assert_array_equal(out["y/pmax"], _by_rank(f(jnp.asarray(x)))[r])
        np.testing.assert_array_equal(out["one_hot"], np.asarray(one_hot)[r])
        assert bool(out["pmax_grad_raised"])
        assert (int(out["axis_index"]), int(out["axis_size"])) == (r, N)


# -------------------------------------------------------------- sharding


def _canon(spec):
    """A spec as a tuple with one-axis tuples as the axis name: JAX (0.9)
    reads PartitionSpec(("fsdp",), "tensor") as ("fsdp", "tensor")."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in spec)


def test_sharding_rules_match():
    paths = ["layers.0.attn.wq", "layers.5.mlp.w_down", "layers.2.attn_norm.scale",
             "blocks.attn.wo", "blocks.mlp.w_gate", "embed.embedding", "lm_head",
             "final_norm.scale", "something.else"]
    for path in paths:
        assert _canon(par.spec_for_path(path, par.TRANSFORMER_RULES)) == _canon(
            jspec_for_path(path, JRULES)), path
    assert par.spec_for_path("layers.0.attn.wq", par.TRANSFORMER_RULES) == PartitionSpec(
        ("fsdp",), "tensor")


def _sharding_params():
    rng = np.random.default_rng(5)
    return {
        "layers": {"0": {"attn": {"wq": rng.standard_normal((64, 32)).astype(np.float32),
                                  "wo": rng.standard_normal((32, 64)).astype(np.float32)}}},
        "norm": {"scale": rng.standard_normal((64,)).astype(np.float32)},
        "attn": {"wq": rng.standard_normal((6, 5)).astype(np.float32)},  # 5 % tensor=2 != 0
        # a stacked [n_layers, in, out] leaf: the rule applies right-aligned
        "blocks": {"attn": {"wq": rng.standard_normal((2, 8, 12)).astype(np.float32)}},
    }


@pytest.fixture(scope="module")
def shard_outs(world):
    params = _sharding_params()
    inputs = {f"params/{'/'.join(p)}": v for p, v in _flat_np(params)}
    inputs.update(_axes(data=1, fsdp=2, tensor=2))
    return world.run("shard_params", inputs), params


def _flat_np(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat_np(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _dim_names():
    return types.SimpleNamespace(mesh_dim_names=AXIS_ORDER)


def _check_placed(outs, jtree, path):
    """Each rank's spec, placements and local shard of leaf `path` against
    the JAX leaf's spec and that rank's device's shard."""
    leaf = jtree
    for k in path:
        leaf = leaf[k]
    key = "/".join(path)
    jspec = _canon(leaf.sharding.spec)
    for r, out in enumerate(outs):
        assert _canon(ast.literal_eval(str(out[f"spec/{key}"]))) == jspec, key
        assert str(out[f"placements/{key}"]) == repr(placements(_dim_names(),
                                                                 PartitionSpec(*jspec)))
        shard = [s for s in leaf.addressable_shards if s.device == _devices()[r]][0]
        np.testing.assert_array_equal(out[f"local/{key}"], np.asarray(shard.data), err_msg=key)
    return jspec


def test_shard_tree_places_params(shard_outs):
    outs, params = shard_outs
    jtree = jshard_tree(jax.tree_util.tree_map(jnp.asarray, params),
                        _jmesh(fsdp=2, tensor=2))
    assert _check_placed(outs, jtree, ("layers", "0", "attn", "wq")) == ("fsdp", "tensor")
    assert _check_placed(outs, jtree, ("layers", "0", "attn", "wo")) == ("tensor", "fsdp")
    assert _check_placed(outs, jtree, ("norm", "scale")) == ()


def test_shard_tree_clamps_indivisible(shard_outs):
    outs, params = shard_outs
    jtree = jshard_tree(jax.tree_util.tree_map(jnp.asarray, params),
                        _jmesh(fsdp=2, tensor=2))
    assert _check_placed(outs, jtree, ("attn", "wq")) == ("fsdp",)


def test_stacked_param_sharding_right_aligned(shard_outs):
    outs, params = shard_outs
    jtree = jshard_tree(jax.tree_util.tree_map(jnp.asarray, params),
                        _jmesh(fsdp=2, tensor=2))
    assert _check_placed(outs, jtree, ("blocks", "attn", "wq")) == (None, "fsdp", "tensor")


def test_replicate_tree(shard_outs):
    from ray_tpu.parallel.sharding import replicate_tree as jreplicate_tree

    outs, params = shard_outs
    jtree = jreplicate_tree(jax.tree_util.tree_map(jnp.asarray, params), _jmesh(fsdp=2, tensor=2))
    want = repr(placements(_dim_names(), PartitionSpec()))
    for path, leaf in _flat_np(params):
        key = "/".join(path)
        jleaf = jtree
        for k in path:
            jleaf = jleaf[k]
        assert _canon(jleaf.sharding.spec) == ()
        for out in outs:
            assert str(out[f"replicated_placements/{key}"]) == want
            np.testing.assert_array_equal(out[f"replicated/{key}"], leaf)


def test_batch_seq_spec_matches_jax():
    from ray_tpu.parallel.ring_attention import batch_seq_spec as jbatch_seq_spec

    for axes in ({"seq": 4}, {"data": 2, "seq": 2}, {"seq": 2, "tensor": 2}):
        sizes = {a: axes.get(a, 1) for a in AXIS_ORDER}
        mesh = par.Mesh(AXIS_ORDER, sizes, np.empty(tuple(sizes.values()), dtype=object))
        assert _canon(par.batch_seq_spec(mesh, "seq")) == _canon(
            jbatch_seq_spec(_jmesh(**axes), "seq")), axes
    with pytest.raises(ValueError):
        jbatch_seq_spec(_jmesh(seq=4), "ring")
    with pytest.raises(ValueError):
        par.batch_seq_spec(mesh, "ring")


def test_shard_batch(world):
    x = np.random.default_rng(6).standard_normal((16, 3)).astype(np.float32)
    outs = world.run("shard_batch_case", {"x": x, **_axes(data=2, fsdp=2)})
    jx = jshard_batch({"x": jnp.asarray(x)}, _jmesh(data=2, fsdp=2))["x"]
    assert tuple(jx.sharding.spec) == (("data", "fsdp"),)
    want = repr(placements(_dim_names(), PartitionSpec(("data", "fsdp"))))
    for r, out in enumerate(outs):
        assert str(out["placements"]) == want
        np.testing.assert_array_equal(out["full"], x)
        shard = [s for s in jx.addressable_shards if s.device == _devices()[r]][0]
        np.testing.assert_array_equal(out["local"], np.asarray(shard.data))
        # a 4-rank world whose batch axes are all 1: each rank's different
        # rows cannot be one replicated batch
        assert bool(out["indivisible_raised"])


# -------------------------------------------------- sequence parallelism


def _qkv(seed, b, s, h, d, h_kv=None):
    rng = np.random.default_rng(seed)
    shapes = ((b, s, h, d), (b, s, h_kv or h, d), (b, s, h_kv or h, d))
    return [rng.standard_normal(sh).astype(np.float32) for sh in shapes]


def _seq_run(world, impl, causal, q, k, v, target=None):
    inputs = {"q": q, "k": k, "v": v, "impl": np.array(impl), "causal": np.bool_(causal)}
    if target is not None:
        inputs["target"] = target
    return world.run("seq_attention", inputs)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_matches_full(world, causal):
    q, k, v = _qkv(0, 2, 32, 4, 16)
    want = jring(*map(jnp.asarray, (q, k, v)), _jmesh(seq=4), causal=causal)
    for out, block in zip(_seq_run(world, "ring", causal, q, k, v), _seq_blocks(want)):
        np.testing.assert_allclose(out["o"], block, atol=ATTN_TOL, rtol=ATTN_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_ulysses_matches_full(world, causal):
    q, k, v = _qkv(1, 2, 32, 8, 16)
    want = julysses(*map(jnp.asarray, (q, k, v)), _jmesh(seq=4), causal=causal)
    for out, block in zip(_seq_run(world, "ulysses", causal, q, k, v), _seq_blocks(want)):
        np.testing.assert_allclose(out["o"], block, atol=ATTN_TOL, rtol=ATTN_TOL)


def _ring_grads(q, k, v, t, causal):
    mesh = _jmesh(seq=4)

    def loss(q, k, v):
        return jnp.sum((jring(q, k, v, mesh, causal=causal) - t) ** 2)

    return jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(*map(jnp.asarray, (q, k, v)))


def _check_grads(outs, grads):
    for name, g in zip(("dq", "dk", "dv"), grads):
        for out, block in zip(outs, _seq_blocks(g)):
            np.testing.assert_allclose(out[name], block, atol=ATTN_TOL, rtol=ATTN_TOL,
                                       err_msg=name)


def test_ring_attention_grad(world):
    """The JAX test's jit(grad) case: q = k = v = 0.1, loss sum(o^2)."""
    q = k = v = np.full((1, 16, 2, 8), 0.1, np.float32)
    t = np.zeros_like(q)
    grads = _ring_grads(q, k, v, t, True)
    assert all(bool(jnp.all(jnp.isfinite(g))) for g in grads)
    _check_grads(_seq_run(world, "ring", True, q, k, v, t), grads)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_grads_match_full_kernel_path(world, causal):
    """Through each block's flash forward and backward: the lse merge hands
    the backward a non-zero dlse."""
    q, k, v, t = _qkv(7, 1, 32, 2, 8) + [np.random.default_rng(8).standard_normal(
        (1, 32, 2, 8)).astype(np.float32)]
    _check_grads(_seq_run(world, "ring", causal, q, k, v, t), _ring_grads(q, k, v, t, causal))


def test_ring_attention_gqa(world):
    q, k, v = _qkv(3, 1, 32, 4, 8, h_kv=2)
    want = jring(*map(jnp.asarray, (q, k, v)), _jmesh(seq=4), causal=True)
    for out, block in zip(_seq_run(world, "ring", True, q, k, v), _seq_blocks(want)):
        np.testing.assert_allclose(out["o"], block, atol=ATTN_TOL, rtol=ATTN_TOL)


# -------------------------------------------------------------- pipeline


def test_pipeline_forward_matches_sequential(world):
    S, M, mb, d = 4, 8, 2, 16
    rng = np.random.default_rng(0)
    stages = {"w": (rng.standard_normal((S, d, d)) * 0.3).astype(np.float32),
              "b": np.zeros((S, d), np.float32)}
    x = rng.standard_normal((M, mb, d)).astype(np.float32)
    ref = x
    for s in range(S):
        ref = np.tanh(ref @ stages["w"][s] + stages["b"][s])
    mesh = _jmesh(stage=S)
    jparams = jpipe.shard_stage_params(jax.tree_util.tree_map(jnp.asarray, stages), mesh)
    want = jpipe.pipeline_apply(lambda p, x: jnp.tanh(x @ p["w"] + p["b"]), jparams,
                                jnp.asarray(x), mesh)
    np.testing.assert_allclose(np.asarray(want), ref, rtol=2e-5, atol=2e-5)
    outs = world.run("pipeline_forward", {"stages/w": stages["w"], "stages/b": stages["b"],
                                          "x": x, **_axes(stage=S)})
    for out in outs:
        np.testing.assert_allclose(out["y"], np.asarray(want), rtol=2e-5, atol=2e-5)


def test_pipeline_backward_grad_parity(world):
    """jax.grad through pipeline_apply over 2 stages against the port's
    backward pipeline, with remat and without; the port's world runs two
    data replicas of the 2-stage pipeline."""
    S, M, mb, d = 2, 4, 2, 8
    rng = np.random.default_rng(2)
    w = (rng.standard_normal((S, d, d)) * 0.3).astype(np.float32)
    x = rng.standard_normal((M, mb, d)).astype(np.float32)
    mesh = _jmesh(n=S, stage=S)

    def loss_pp(params):
        return jnp.mean(jpipe.pipeline_apply(lambda p, xb: jnp.tanh(xb @ p["w"]), params,
                                             jnp.asarray(x), mesh) ** 2)

    want = np.asarray(jax.grad(loss_pp)({"w": jnp.asarray(w)})["w"])
    outs = world.run("pipeline_grad", {"stages/w": w, "x": x, **_axes(data=2, stage=S)})
    for out in outs:
        for remat in (True, False):
            np.testing.assert_allclose(out[f"g/{remat}/w"], want, rtol=ATTN_TOL, atol=ATTN_TOL)


def test_transformer_layers_split_into_stages():
    stacked = {"w": np.arange(8 * 4 * 4, dtype=np.float32).reshape(8, 4, 4),
               "b": np.arange(8 * 4, dtype=np.float32).reshape(8, 4)}
    import torch

    got = par.split_stacked_layers({k: torch.from_numpy(v) for k, v in stacked.items()}, 4)
    want = jpipe.split_stacked_layers(jax.tree_util.tree_map(jnp.asarray, stacked), 4)
    assert got["w"].shape == (4, 2, 4, 4) and got["b"].shape == (4, 2, 4)
    for k in stacked:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    with pytest.raises(ValueError):
        par.split_stacked_layers({"w": torch.zeros(6, 2)}, 4)


def test_stage_param_sharding_matches_jax():
    stacked = {"w": np.zeros((4, 3, 3), np.float32), "b": np.zeros((4, 3), np.float32)}
    want = jpipe.stage_param_sharding(_jmesh(stage=4), stacked)
    got = par.pipeline.stage_param_sharding(_dim_names(), stacked)
    for k in stacked:
        assert got[k] == placements(_dim_names(), PartitionSpec(*want[k].spec))
