"""The port's checkpoints against the JAX package's: the elastic format
(ray_tpu/train/elastic_checkpoint.py), HF safetensors
(ray_tpu/train/hf_checkpoint.py), pytree and optimizer-state files and the
keep-K manager (ray_tpu/train/checkpoint.py), and the JAX leaf order they
all number leaves by.

Files cross between the packages in both directions and must come back bit
for bit (bfloat16 included: the port reads it without ml_dtypes). Two
numeric checks carry a tolerance: the port's forward on HF weights that JAX
exported matches JAX's logits to 1e-4 (tests/test_torch_transformer.py's
bound for the fp32 forward), and one AdamW step from optax state loaded
into torch matches optax's next step to 1e-6 (the same elementwise update in
another order).
"""

import itertools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.models import transformer as jtfm
from ray_tpu.train import checkpoint as jckpt
from ray_tpu.train import elastic_checkpoint as jec
from ray_tpu.train import hf_checkpoint as jhf
from ray_tpu_torch.models import convert
from ray_tpu_torch.models import transformer as ttfm
from ray_tpu_torch.train import checkpoint as tckpt
from ray_tpu_torch.train import elastic_checkpoint as tec
from ray_tpu_torch.train import hf_checkpoint as thf

LOGITS_TOL = 1e-4
ADAM_STEP_ATOL = 1e-6
GPTJ = dict(mlp_act="gelu", parallel_block=True, norm_type="layer", rope_style="interleaved",
            rotary_dim=8, n_kv_heads=4)


def _bits(x) -> bytes:
    """The raw bytes of a numpy array, a jax array or a torch tensor."""
    if isinstance(x, torch.Tensor):
        return convert.tensor_to_numpy(x).tobytes()
    return np.ascontiguousarray(np.asarray(x)).tobytes()


def _tensor(x) -> torch.Tensor:
    """A numpy or jax leaf as a CPU tensor with the same bits and dtype."""
    arr = np.array(x)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _dtype_name(x) -> str:
    if isinstance(x, torch.Tensor):
        return str(x.dtype).replace("torch.", "")
    return str(np.asarray(x).dtype)


def _assert_bitwise(jax_leaves, port_leaves):
    assert len(jax_leaves) == len(port_leaves)
    for i, (a, b) in enumerate(zip(jax_leaves, port_leaves)):
        assert tuple(np.shape(a)) == tuple(b.shape), i
        assert _dtype_name(a) == _dtype_name(b), (i, _dtype_name(a), _dtype_name(b))
        assert _bits(a) == _bits(b), f"leaf {i} differs"


def _jax_state(kw=None, dtype=jnp.bfloat16, seed=0):
    """A JAX param tree and its optax adamw state after one update, numpy."""
    cfg = jtfm.tiny(dtype=dtype, **(kw or {}))
    params = jtfm.init_params(jax.random.PRNGKey(seed), cfg)
    tx = optax.adamw(1e-3)
    grads = jax.tree_util.tree_map(lambda p: jnp.full_like(p, 0.01) * p, params)
    _, opt = tx.update(grads, tx.init(params), params)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return cfg, to_np(params), to_np(opt)


def _port_twin(np_params, np_opt, kw=None, dtype=torch.bfloat16):
    """The port's params and AdamW holding the same values."""
    cfg = ttfm.tiny(dtype=dtype, **(kw or {}))
    params = convert.params_from_numpy(np_params, cfg, device="cpu")
    opt = ttfm.adamw(1e-3)(ttfm.tree_leaves(params))
    convert.opt_state_from_numpy(np_opt[0], opt, params)
    return cfg, params, opt


# ------------------------------------------------------------ leaf order


@pytest.mark.parametrize("kw", [{}, GPTJ, dict(tie_embeddings=True)],
                         ids=["llama", "gptj", "tied"])
def test_flatten_matches_jax_leaf_order(kw):
    _, np_params, np_opt = _jax_state(kw)
    zero_keyed = {str(i): np.float32(i) for i in range(13)}
    for jtree, ttree in ((np_params, np_params), (zero_keyed, zero_keyed),
                         (np_opt[0], {"count": np_opt[0].count, "mu": np_opt[0].mu,
                                      "nu": np_opt[0].nu})):
        jpaths = [tuple(str(getattr(k, "key", getattr(k, "name", k))) for k in path)
                  for path, _ in jax.tree_util.tree_flatten_with_path(jtree)[0]]
        tpaths, tleaves = convert.flatten(ttree)
        assert tpaths == jpaths
        _assert_bitwise(jax.tree_util.tree_leaves(jtree), [_tensor(x) for x in tleaves])
        assert convert.unflatten(tpaths, tleaves).keys() == ttree.keys()
    # the port's own order is insertion order, which is not JAX's
    assert [p[-1] for p in convert.flatten(np_params["blocks"]["attn"])[0]] == [
        "wk", "wo", "wq", "wv"]


def test_opt_state_crosses_bit_for_bit_and_steps_like_optax():
    jcfg, np_params, np_opt = _jax_state(dtype=jnp.float32)
    _, params, opt = _port_twin(np_params, np_opt, dtype=torch.float32)
    back = convert.opt_state_to_numpy(opt, params)
    assert int(back["count"]) == int(np_opt[0].count) == 1
    _assert_bitwise(jax.tree_util.tree_leaves(np_opt[0]),
                    [_tensor(x) for x in convert.flatten(back)[1]])
    # one more step from the loaded state: torch's AdamW against optax's
    tx = optax.adamw(1e-3)
    grads = jax.tree_util.tree_map(lambda p: np.full_like(p, 0.02) * p, np_params)
    updates, _ = tx.update(grads, np_opt, np_params)
    want = optax.apply_updates(np_params, updates)
    for t, g in zip(convert.flatten(params)[1], convert.flatten(grads)[1]):
        t.grad = torch.from_numpy(np.array(g))
    opt.step()
    for (path, w), t in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                            convert.flatten(params)[1]):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(w), rtol=0,
                                   atol=ADAM_STEP_ATOL, err_msg=str(path))


def test_bf16_opt_state_round_trips_through_numpy_bits():
    _, np_params, np_opt = _jax_state()
    _, params, opt = _port_twin(np_params, np_opt)
    back = convert.opt_state_to_numpy(opt, params)
    leaves = convert.flatten(back)[1]
    assert leaves[1].dtype == np.uint16  # bfloat16 bits; numpy has no bfloat16
    _assert_bitwise(jax.tree_util.tree_leaves(np_opt[0]),
                    [torch.from_numpy(x.view(np.int16)).view(torch.bfloat16)
                     if x.dtype == np.uint16 else torch.from_numpy(x) for x in leaves])
    fresh = ttfm.adamw(1e-3)(ttfm.tree_leaves(params))
    convert.opt_state_from_numpy(back, fresh, params)  # uint16 bits load back
    assert all(torch.equal(opt.state[t]["exp_avg"], fresh.state[t]["exp_avg"])
               for t in ttfm.tree_leaves(params))


# ---------------------------------------------------------- elastic format


def _like(cfg):
    spec = ttfm.param_spec(cfg)
    return spec, {"count": 0, "mu": spec, "nu": spec}


@pytest.mark.parametrize("kw", [{}, GPTJ], ids=["llama", "gptj"])
def test_jax_elastic_save_restores_in_the_port(tmp_path, kw):
    cfg, np_params, np_opt = _jax_state(kw)
    d = str(tmp_path / "jax_ck")
    for r in (1, 0):
        jec.save_state(d, np_params, np_opt, step=5, world_size=2, rank=r, meta={"by": "jax"})
    tcfg = ttfm.tiny(dtype=torch.bfloat16, **kw)
    params_like, opt_like = _like(tcfg)
    state = tec.load_state(d, params_like=params_like, opt_like=opt_like)
    assert (state["step"], state["saved_world_size"], state["meta"]) == (5, 2, {"by": "jax"})
    _assert_bitwise(jax.tree_util.tree_leaves(np_params), convert.flatten(state["params"])[1])
    _assert_bitwise(jax.tree_util.tree_leaves(np_opt), convert.flatten(state["opt_state"])[1])
    # the restored state loads into the port's optimizer
    params = ttfm.map_tree(lambda t: t.clone(), state["params"])
    opt = ttfm.adamw(1e-3)(ttfm.tree_leaves(params))
    convert.opt_state_from_numpy(state["opt_state"], opt, params)
    assert opt.state[params["lm_head"]]["step"].item() == 1.0
    with pytest.raises(FileNotFoundError, match="like="):
        tec.load_state(d)


def test_port_elastic_save_reads_in_jax(tmp_path):
    _, np_params, np_opt = _jax_state()
    _, params, opt = _port_twin(np_params, np_opt)
    d = str(tmp_path / "port_ck")
    for r in range(2):
        tec.save_state(d, params, convert.opt_state_to_torch(opt, params), step=9,
                       world_size=2, rank=r)
    for kind, jtree in (("params", np_params), ("opt", np_opt)):
        jleaves = [np.ascontiguousarray(np.asarray(x)).reshape(-1)
                   for x in jax.tree_util.tree_leaves(jtree)]
        for world in (1, 3):
            for r in range(world):
                slices, manifest = jec.load_shard(d, world_size=world, rank=r, kind=kind)
                assert manifest["step"] == 9 and manifest["world_size"] == 2
                assert len(slices) == len(jleaves)
                for s, full in zip(slices, jleaves):
                    lo, hi = jec.shard_bounds(full.size, world, r)
                    assert s.dtype == full.dtype and s.tobytes() == full[lo:hi].tobytes()
    # what the JAX package's manifest says of each leaf, the port's says too
    jd = str(tmp_path / "jax_ck")
    jec.save_state(jd, np_params, np_opt, step=9, world_size=2, rank=0)
    for kind in ("params", "opt"):
        assert tec.read_manifest(d, kind)["leaves"] == jec.read_manifest(jd, kind)["leaves"]


def test_port_reshard_chain_is_bitwise(tmp_path):
    _, np_params, np_opt = _jax_state()
    _, params, opt = _port_twin(np_params, np_opt)
    opt_state = convert.opt_state_to_torch(opt, params)
    src = str(tmp_path / "w1")
    tec.save_state(src, params, opt_state, step=3, world_size=1, rank=0)
    want = convert.flatten(params)[1] + convert.flatten(opt_state)[1]
    for world in (2, 4, 1):
        dst = str(tmp_path / f"w{world}_{len(os.listdir(tmp_path))}")
        for kind in ("params", "opt"):
            tec.reshard(src, dst, world, kind=kind)
        state = tec.load_state(dst)
        assert state["saved_world_size"] == world and state["step"] == 3
        got = convert.flatten(state["params"])[1] + convert.flatten(state["opt_state"])[1]
        _assert_bitwise([t.detach() for t in want], got)
        for r in range(world):  # each new rank's slice reads back from the files
            slices, _ = tec.load_shard(dst, world_size=world, rank=r)
            for s, t in zip(slices, convert.flatten(params)[1]):
                lo, hi = tec.shard_bounds(t.numel(), world, r)
                assert torch.equal(s, t.detach().reshape(-1)[lo:hi])
        src = dst


def test_port_reshard_keeps_a_jax_checkpoint_readable_in_jax(tmp_path):
    _, np_params, np_opt = _jax_state()
    src, dst = str(tmp_path / "a"), str(tmp_path / "b")
    jec.save_state(src, np_params, np_opt, step=2, world_size=1, rank=0)
    for kind in ("params", "opt"):
        tec.reshard(src, dst, 3, kind=kind)
    state = jec.load_state(dst)
    assert state["saved_world_size"] == 3
    _assert_bitwise(jax.tree_util.tree_leaves(np_params),
                    [_tensor(x) for x in jax.tree_util.tree_leaves(state["params"])])


def test_shard_bounds_match_jax():
    for size, world in itertools.product((0, 1, 5, 16, 17), (1, 2, 3, 4, 7)):
        for r in range(world):
            assert tec.shard_bounds(size, world, r) == jec.shard_bounds(size, world, r)
    with pytest.raises(ValueError):
        tec.shard_bounds(8, 2, 2)


# ---------------------------------------------------------------- HF files


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("family", ["llama", "gptj"])
def test_hf_checkpoint_crosses_bit_for_bit(tmp_path, family, dtype):
    kw = GPTJ if family == "gptj" else {}
    jcfg = jtfm.tiny(dtype=getattr(jnp, dtype), **kw)
    tcfg = ttfm.tiny(dtype=getattr(torch, dtype), **kw)
    jparams = jtfm.init_params(jax.random.PRNGKey(7), jcfg)
    jpath, tpath = str(tmp_path / "jax.safetensors"), str(tmp_path / "port.safetensors")
    jhf.export_hf_checkpoint(jparams, jcfg, jpath, family=family)
    loaded = thf.load_hf_checkpoint(jpath, tcfg, family=family, device="cpu")
    assert list(loaded) == list(ttfm.param_spec(tcfg))  # param_spec's order
    _assert_bitwise(jax.tree_util.tree_leaves(jparams), convert.flatten(loaded)[1])
    thf.export_hf_checkpoint(loaded, tcfg, tpath, family=family)
    with open(jpath, "rb") as a, open(tpath, "rb") as b:
        assert a.read() == b.read()  # the same file, header and all
    back = jhf.load_hf_checkpoint(tpath, jcfg, family=family)
    _assert_bitwise(jax.tree_util.tree_leaves(jparams),
                    [_tensor(x) for x in jax.tree_util.tree_leaves(back)])


@pytest.mark.parametrize("family", ["llama", "gptj"])
def test_forward_on_hf_weights_matches_jax(tmp_path, family):
    kw = GPTJ if family == "gptj" else {}
    jcfg = jtfm.tiny(dtype=jnp.float32, attn_impl="full", **kw)
    tcfg = ttfm.tiny(dtype=torch.float32, attn_impl="full", **kw)
    path = str(tmp_path / "m.safetensors")
    jhf.export_hf_checkpoint(jtfm.init_params(jax.random.PRNGKey(3), jcfg), jcfg, path,
                             family=family)
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab_size, (2, 16), dtype=np.int32)
    old = jax.config.jax_default_matmul_precision
    jax.config.update("jax_default_matmul_precision", "highest")
    try:
        want = np.asarray(jtfm.forward(jhf.load_hf_checkpoint(path, jcfg, family=family),
                                       jnp.asarray(tokens), jcfg))
    finally:
        jax.config.update("jax_default_matmul_precision", old)
    with torch.no_grad():
        got = ttfm.forward(thf.load_hf_checkpoint(path, tcfg, family=family, device="cpu"),
                           torch.from_numpy(tokens), tcfg).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGITS_TOL)


def test_hf_missing_tensor_raises_naming_it(tmp_path):
    cfg = ttfm.tiny(dtype=torch.float32)
    p = str(tmp_path / "partial.safetensors")
    thf.write_safetensors(p, {"model.embed_tokens.weight": torch.zeros(cfg.vocab_size,
                                                                        cfg.d_model)})
    with pytest.raises(KeyError, match=r"blocks\.attn\.wq \(model\.layers\.0\.self_attn"):
        thf.load_hf_checkpoint(p, cfg, family="llama", device="cpu")


def test_hf_sharded_index_layout_loads(tmp_path):
    jcfg = jtfm.tiny(dtype=jnp.bfloat16)
    tcfg = ttfm.tiny(dtype=torch.bfloat16)
    jparams = jtfm.init_params(jax.random.PRNGKey(1), jcfg)
    single = str(tmp_path / "one.safetensors")
    jhf.export_hf_checkpoint(jparams, jcfg, single, family="llama")
    f = thf.SafetensorsFile(single)
    names = f.keys()
    shards = {"model-00001-of-00002.safetensors": names[: len(names) // 2],
              "model-00002-of-00002.safetensors": names[len(names) // 2:]}
    d = tmp_path / "sharded"
    d.mkdir()
    weight_map = {}
    for fname, keys in shards.items():
        thf.write_safetensors(str(d / fname), {k: f.get(k).clone() for k in keys})
        weight_map.update({k: fname for k in keys})
    with open(d / "model.safetensors.index.json", "w") as fh:
        json.dump({"metadata": {}, "weight_map": weight_map}, fh)
    loaded = thf.load_hf_checkpoint(str(d), tcfg, family="llama", device="cpu")
    _assert_bitwise(jax.tree_util.tree_leaves(jparams), convert.flatten(loaded)[1])
    # the JAX package reads the same directory
    jloaded = jhf.load_hf_checkpoint(str(d), jcfg, family="llama")
    assert all(_bits(a) == _bits(b) for a, b in zip(jax.tree_util.tree_leaves(jloaded),
                                                    jax.tree_util.tree_leaves(jparams)))


def test_safetensors_raw_round_trip(tmp_path):
    tensors = {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
               "b": torch.ones((2, 2), dtype=torch.float16),
               "c": torch.randn(5, 3).to(torch.bfloat16), "e": torch.zeros((0, 4))}
    p = str(tmp_path / "t.safetensors")
    thf.write_safetensors(p, tensors)
    f = thf.SafetensorsFile(p)
    assert f.keys() == ["a", "b", "c", "e"]
    for k, t in tensors.items():
        assert f.get(k).dtype == t.dtype and torch.equal(f.get(k), t)
    jf = jhf.SafetensorsFile(p)  # the JAX reader agrees (bfloat16 via ml_dtypes)
    assert np.asarray(jf.get("c")).view(np.uint16).tobytes() == _bits(tensors["c"])
    jf.close()


# ------------------------------------------------- pytree, aux, the manager


def test_pytree_and_aux_state_round_trip_bit_for_bit(tmp_path):
    tree = {"w": torch.randn(4, 3).to(torch.bfloat16), "n": {"b": torch.randn(5),
            "count": torch.tensor(7, dtype=torch.int32), "empty": torch.zeros(0, 2)},
            "np": np.arange(6, dtype=np.int64).reshape(2, 3)}
    d = str(tmp_path / "pt")
    tckpt.save_pytree(tree, d)
    back = tckpt.load_pytree(d)
    want_paths, want = convert.flatten(tree)
    got_paths, got = convert.flatten(back)
    assert got_paths == want_paths
    for a, b in zip(want, got):
        a = a if isinstance(a, torch.Tensor) else torch.from_numpy(a)
        assert b.device.type == "cpu" and a.dtype == b.dtype and torch.equal(a, b)
    like = tckpt.load_pytree(d, like=tree)
    assert torch.equal(like["w"], tree["w"])
    with pytest.raises(ValueError, match="key paths"):
        tckpt.load_pytree(d, like={"w": tree["w"]})

    params = {"w": torch.randn(3, requires_grad=True)}
    opt = ttfm.adamw(1e-3)(ttfm.tree_leaves(params))
    params["w"].grad = torch.ones(3)
    opt.step()
    tckpt.save_aux_state(d, opt.state_dict())
    sd = tckpt.load_aux_state(d)
    assert torch.equal(sd["state"][0]["exp_avg"], opt.state[params["w"]]["exp_avg"])
    assert not os.path.exists(os.path.join(d, "opt_state.pkl.tmp"))
    with open(os.path.join(d, "opt_state.pkl"), "wb") as f:
        f.write(b"\x80truncated")
    assert tckpt.load_aux_state(d) is None
    assert tckpt.load_aux_state(str(tmp_path / "none")) is None


def test_load_pytree_refuses_a_jax_directory(tmp_path):
    d = str(tmp_path / "jax_pt")
    jckpt.save_pytree({"w": np.ones(3, np.float32)}, d)
    with pytest.raises(FileNotFoundError, match="not the JAX package's"):
        tckpt.load_pytree(d)


@pytest.mark.parametrize("num_to_keep,score_attribute,score_order", [
    (2, "loss", "min"), (2, "acc", "max"), (1, None, "max"), (None, "loss", "min"),
    (3, "missing", "max")])
def test_checkpoint_manager_keeps_and_evicts_as_jax(tmp_path, num_to_keep, score_attribute,
                                                    score_order):
    metrics = [{"loss": 3.0, "acc": 0.1}, {"loss": 1.0, "acc": 0.7}, {"loss": 2.0, "acc": 0.4},
               {"loss": 0.5, "acc": 0.2}, {"loss": 4.0, "acc": 0.9}]
    kept = {}
    for name, mod in (("jax", jckpt), ("port", tckpt)):
        mgr = mod.CheckpointManager(num_to_keep, score_attribute, score_order)
        for i, m in enumerate(metrics):
            path = tmp_path / name / f"c{i}"
            path.mkdir(parents=True)
            mgr.register(mod.Checkpoint.from_directory(str(path)), m)
        kept[name] = ([os.path.basename(c.path) for c in mgr.checkpoints],
                      os.path.basename(mgr.best_checkpoint.path),
                      os.path.basename(mgr.latest_checkpoint.path),
                      sorted(os.listdir(tmp_path / name)))
    assert kept["port"] == kept["jax"]
    with pytest.raises(ValueError):
        tckpt.CheckpointManager(num_to_keep=0)


def test_storage_context_and_checkpoint_dict(tmp_path):
    ctx = tckpt.StorageContext(str(tmp_path), "exp", "trial")
    assert ctx.trial_dir == str(tmp_path / "exp" / "trial")
    src = tckpt.Checkpoint.from_dict({"step": 4})
    persisted = ctx.persist_checkpoint(src, 4)
    assert persisted.path == str(tmp_path / "exp" / "trial" / "checkpoint_000004")
    assert persisted.to_dict() == {"step": 4}
    ctx.write_json("result.json", {"loss": 1.5})
    with open(os.path.join(ctx.trial_dir, "result.json")) as f:
        assert json.load(f) == {"loss": 1.5}
