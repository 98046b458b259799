"""The vocab split of the port's tensor-parallel transformer against the JAX
package: the embedding looked up by its d/T columns on each rank, an untied
head whose logits each rank holds vocab/T columns of, the vocab-parallel
cross-entropy (`ray_tpu_torch/parallel/cross_entropy.py`), and the tied
head as a row-parallel product.

The JAX side is `next_token_loss` / `forward` with mesh= on params placed by
its `shard_tree` (GSPMD splits the embedding and the head over "tensor"
there), jitted on 4 of the conftest's virtual CPU devices; the port's runs
in one 4-rank gloo world (tests/torch_world.py, scenario `tp_model`), every
rank passing the global tokens, the mask and the whole params. tiny() widths
(vocab 256, d 64) in float32, matmul precision "highest". Tolerances: the
loss 1e-5 relative to JAX's, the logits 1e-4, each rank's gradient shard of
every leaf within 1e-5 of that shard's norm (max absolute error). With an
untied head on tensor > 1 no tensor autograd saves for the loss's backward
may have a whole-vocab last dim or be the whole [vocab, d] table.
"""

import jax
import numpy as np
import pytest

from test_torch_tensor_parallel import _flat, _inputs, _jmesh, _rank_part, _setup, _shard_index
from torch_world import World

LOGIT_TOL = 1e-4
LOSS_RTOL = 1e-5
GRAD_NORM_TOL = 1e-5

CASES = {
    # (mesh axes, config overrides)
    "data2_tensor2_untied": ({"data": 2, "tensor": 2}, {}),
    "data2_tensor2_tied": ({"data": 2, "tensor": 2}, {"tie_embeddings": True}),
    "tensor4_untied": ({"tensor": 4}, {"n_kv_heads": 4}),
    "tensor4_tied": ({"tensor": 4}, {"n_kv_heads": 4, "tie_embeddings": True}),
    "fsdp2_tensor2_untied": ({"fsdp": 2, "tensor": 2}, {}),
    "fsdp2_tensor2_tied": ({"fsdp": 2, "tensor": 2}, {"tie_embeddings": True}),
    # 250 does not split over 4: the clamp leaves the head whole, and the
    # port takes the gathered path (the embedding's d stays split)
    "tensor4_vocab250_untied": ({"tensor": 4}, {"n_kv_heads": 4, "vocab_size": 250}),
}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = World(4, tmp_path_factory.mktemp("vocab_parallel_world"))
    yield w
    w.close()


@pytest.fixture(autouse=True)
def _exact_matmuls():
    old = jax.config.jax_default_matmul_precision
    jax.config.update("jax_default_matmul_precision", "highest")
    yield
    jax.config.update("jax_default_matmul_precision", old)


def _boundary_tokens(tokens, vocab, tensor):
    """Tokens whose targets (the next position's token) include the first
    and last vocab id of every "tensor" rank's columns, in every row."""
    out = tokens.copy()
    part = vocab // tensor
    ids = sorted({i for t in range(tensor) for i in (t * part, t * part + part - 1)}
                 | {0, vocab - 1})
    for row in range(out.shape[0]):
        at = 1 + row  # each row puts them at other positions
        out[row, at:at + len(ids)] = ids
    return out


def _mask(shape, seed):
    return (np.random.default_rng(seed).random(shape) > 0.3).astype(np.float32)


def _jax_masked_reference(jcfg, np_params, tokens, mask, jmesh):
    """JAX's logits, and its loss and gradient with mask=."""
    import functools

    import jax.numpy as jnp

    from ray_tpu.models import transformer as jtfm
    from ray_tpu.parallel.sharding import shard_tree as jshard_tree

    jparams = jshard_tree(jax.tree_util.tree_map(jnp.asarray, np_params), jmesh)
    tok = jnp.asarray(tokens)
    logits = jax.jit(functools.partial(jtfm.forward, cfg=jcfg, mesh=jmesh))(jparams, tok)
    loss_fn = functools.partial(jtfm.next_token_loss, cfg=jcfg, mesh=jmesh,
                                mask=jnp.asarray(mask))
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(jparams, tok)
    return np.asarray(logits), float(loss), jax.tree_util.tree_map(np.asarray, grads)


@pytest.mark.parametrize("case", list(CASES))
def test_vocab_split_matches_jax(world, case):
    """Logits, the masked loss, every rank's gradient shard and the saved
    tensors, with targets on every rank's vocab boundary."""
    axes, cfg_kw = CASES[case]
    jcfg, np_params, tokens = _setup(3, **cfg_kw)
    tokens = _boundary_tokens(tokens, jcfg.vocab_size, axes["tensor"])
    mask = _mask(tokens.shape, 3)
    jmesh = _jmesh(4, **axes)
    jlogits, jloss, jgrads = _jax_masked_reference(jcfg, np_params, tokens, mask, jmesh)
    outs = world.run("tp_model", {**_inputs(cfg_kw, np_params, tokens, axes), "mask": mask})
    index = _shard_index(jmesh, np_params)
    want_grads = {k.split("/", 1)[1]: v for k, v in _flat(jgrads, "grads").items()}
    assert {"embed/embedding", "final_norm/scale"} <= set(want_grads)
    assert ("lm_head" in want_grads) != bool(cfg_kw.get("tie_embeddings"))
    b, s = tokens.shape
    vocab_split = not cfg_kw.get("tie_embeddings") and jcfg.vocab_size % axes["tensor"] == 0
    for r, out in enumerate(outs):
        rows, seq = _rank_part(jmesh, r, b, s)
        np.testing.assert_allclose(out["logits"], jlogits[rows, seq], rtol=0, atol=LOGIT_TOL,
                                   err_msg=f"rank {r}")
        assert abs(float(out["loss"]) - jloss) <= LOSS_RTOL * abs(jloss), (r, out["loss"], jloss)
        assert bool(out["same_placements"]), r
        for key, g in want_grads.items():
            want = g[index[key][r]]
            err = float(np.abs(out[f"grads/{key}"] - want).max())
            assert err <= GRAD_NORM_TOL * float(np.linalg.norm(want)), (r, key, err)
        assert int(out["saved_count"]) > 0, r
        if vocab_split:
            assert int(out["saved_whole_vocab"]) == 0, (r, int(out["saved_whole_vocab"]))
            assert int(out["saved_whole_table"]) == 0, r
        elif not cfg_kw.get("tie_embeddings"):
            # the gathered path: the whole head's logits are saved
            assert int(out["saved_whole_vocab"]) > 0, r
