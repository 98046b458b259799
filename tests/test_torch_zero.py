"""Parity of the port's ZeRO-1 (ray_tpu_torch/train/zero.py) with the JAX
package's (ray_tpu/train/zero.py), and of its torch.distributed backend.

The JAX side runs on a 2-device CPU mesh (conftest's virtual devices); the
port's side is a 2-rank gloo world of two processes
(tests/torch_dist_worker.py), joined through a file:// rendezvous in
tmp_path, each process with a join timeout of its own so that a hang fails
one test. Both start from the same numpy params, grads and tokens, in
float32. Tolerances, each with its reason:
  - params after 3 ZeRO updates: 5e-7 absolute, as
    tests/test_elastic.py holds JAX's sharded update to its unsharded one
    (a few fp32 ulps of XLA's fusion against torch's foreach AdamW);
  - the logical optimizer state (mu, nu): 1e-6 relative + 1e-9 absolute
    (the same elementwise arithmetic in another order); count exactly;
  - losses of 3 ZeRO train steps on tiny(): 1e-5 relative, as
    tests/test_torch_train.py holds the single-device trajectory.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ray_tpu.models import transformer as jtfm
from ray_tpu.train import zero as jzero
from ray_tpu_torch.train import backend

ROOT = Path(__file__).resolve().parent.parent
WORKER = Path(__file__).resolve().parent / "torch_dist_worker.py"
PARAM_ATOL = 5e-7
STATE_RTOL, STATE_ATOL = 1e-6, 1e-9
TRAJECTORY_RTOL = 1e-5
JOIN_TIMEOUT_S = 120


@pytest.fixture(autouse=True)
def _exact_matmuls():
    old = jax.config.jax_default_matmul_precision
    jax.config.update("jax_default_matmul_precision", "highest")
    yield
    jax.config.update("jax_default_matmul_precision", old)


def _mesh(n):
    return Mesh(np.array(jax.devices("cpu")[:n]), ("data",))


def _flat(tree, prefix):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out["/".join([prefix] + [str(getattr(k, "key", k)) for k in path])] = np.asarray(leaf)
    return out


def _run_world(tmp_path, scenario, inputs, world=2):
    """Runs `scenario` of the worker script on `world` gloo ranks; returns
    each rank's outputs."""
    in_path = tmp_path / "in.npz"
    np.savez(in_path, **inputs)
    url = f"file://{tmp_path / 'rendezvous'}"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT), *filter(None, [os.environ.get("PYTHONPATH")])]))
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), scenario, str(r), str(world), url, str(in_path),
         str(tmp_path / f"out{r}.npz")],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=JOIN_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{logs[r][-4000:]}"
    return [dict(np.load(tmp_path / f"out{r}.npz")) for r in range(world)]


def _toy_params():
    rng = np.random.default_rng(0)
    # odd sizes, so the world-2 shards carry a zero pad; "s" is a scalar leaf
    return {"w": rng.standard_normal((13, 7)).astype(np.float32),
            "b": rng.standard_normal((5,)).astype(np.float32),
            "s": np.float32(2.0)}


@pytest.mark.parametrize("use_mesh", [False, True], ids=["default_group", "device_mesh"])
def test_zero_update_and_logical_state_match_jax(tmp_path, use_mesh):
    params = _toy_params()
    rng = np.random.default_rng(1)
    grads = [{k: rng.standard_normal(np.shape(v)).astype(np.float32) for k, v in params.items()}
             for _ in range(3)]
    lr = 1e-2
    tx = optax.adamw(lr)
    mesh = _mesh(2)
    update, sharder = jzero.build_zero_update(tx, params, mesh, axis="data")
    jopt = jzero.init_opt_state(tx, params, mesh, axis="data")
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    for g in grads:
        jparams, jopt = update(jparams, jopt, jax.tree_util.tree_map(jnp.asarray, g))
    jlogical = sharder.to_logical(jopt)

    inputs = {"lr": np.float64(lr), "use_mesh": np.int64(use_mesh), **_flat(params, "params")}
    for k, g in enumerate(grads):
        inputs.update(_flat(g, f"grads{k}"))
    outs = _run_world(tmp_path, "zero_update", inputs)
    for out in outs:
        for k, v in _flat(jparams, "params").items():
            np.testing.assert_allclose(out[k], v, rtol=0, atol=PARAM_ATOL, err_msg=k)
        # JAX's logical state is (ScaleByAdamState(count, mu, nu), EmptyState,
        # EmptyState), mu/nu keyed by leaf index; the port's is the dict
        # {"count", "mu", "nu"}: the same leaves in the same order.
        jleaves = jax.tree_util.tree_leaves(jlogical)
        tkeys = sorted(k for k in out if k.startswith("logical/"))
        assert [k.split("/", 1)[1] for k in tkeys] == (
            ["count"] + [f"mu/{i}" for i in sorted(map(str, range(3)))]
            + [f"nu/{i}" for i in sorted(map(str, range(3)))])
        assert len(jleaves) == len(tkeys)
        assert int(out["logical/count"]) == int(jleaves[0]) == 3
        for key, jleaf in zip(tkeys[1:], jleaves[1:]):
            np.testing.assert_allclose(out[key], np.asarray(jleaf), rtol=STATE_RTOL,
                                       atol=STATE_ATOL, err_msg=key)
        # from_logical into a fresh optimizer continues the run bit for bit
        assert bool(out["resumed_equal"])
        # moments of 91 + 5 + 1 floats; each leaf padded to even for world 2,
        # so each rank holds 46 + 3 + 1 of each; plus one 4-byte step count per
        # leaf, as the plain AdamW keeps
        steps = 3 * 4
        assert int(out["bytes_plain"]) == 2 * 97 * 4 + steps
        assert int(out["bytes_sharded"]) == 2 * 50 * 4 + steps


def test_zero_train_step_matches_jax_zero_trajectory(tmp_path):
    jcfg = jtfm.tiny(dtype=jnp.float32, attn_impl="full")
    np_params = jax.tree_util.tree_map(np.asarray, jtfm.init_params(jax.random.PRNGKey(0), jcfg))
    tokens = np.random.default_rng(2).integers(0, jcfg.vocab_size, (4, 16), dtype=np.int32)
    lr, steps = 1e-3, 3
    mesh = _mesh(2)
    tx = optax.adamw(lr)
    _, jstep = jtfm.build_train_step(jcfg, tx, mesh, zero_axis="data", donate=False)
    jparams = jax.tree_util.tree_map(jnp.asarray, np_params)
    jopt = jzero.init_opt_state(tx, jparams, mesh, "data")
    jtokens = jax.device_put(tokens, NamedSharding(mesh, P("data")))
    jlosses = []
    for _ in range(steps):
        jparams, jopt, loss = jstep(jparams, jopt, jtokens)
        jlosses.append(float(loss))
    assert jlosses[-1] < jlosses[0]

    outs = _run_world(tmp_path, "zero_train", {
        "lr": np.float64(lr), "steps": np.int64(steps), "tokens": tokens,
        **_flat(np_params, "params")})
    for out in outs:
        np.testing.assert_allclose(out["losses"], jlosses, rtol=TRAJECTORY_RTOL, atol=0)
        # tiny()'s leaves all have an even size: the moments halve exactly at
        # world 2; each param keeps its own step count (4 bytes each)
        steps_bytes = 4 * len(jax.tree_util.tree_leaves(np_params))
        moments = int(out["bytes_plain"]) - steps_bytes
        assert (int(out["bytes_sharded"]) - steps_bytes) * 2 == moments
    jmu_bytes = sum(np.asarray(x).nbytes for x in jax.tree_util.tree_leaves(
        tx.init(np_params)[0].mu))
    assert moments == 2 * jmu_bytes  # mu and nu, as optax keeps them
    np.testing.assert_array_equal(outs[0]["losses"], outs[1]["losses"])


def test_backend_config_and_addresses():
    cfg = backend.TorchBackendConfig()
    assert (cfg.backend, cfg.coordinator_host, cfg.init_timeout_s) == (None, None, 60.0)
    host, port = backend.coordinator_address(cfg).rsplit(":", 1)
    assert host == "127.0.0.1" and 0 < int(port) < 65536
    fixed = backend.TorchBackendConfig(coordinator_host="10.0.0.1", coordinator_port=29500)
    assert backend.coordinator_address(fixed) == "10.0.0.1:29500"
