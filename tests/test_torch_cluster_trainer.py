"""TorchTrainer on the port's cluster runtime: its workers are actor
processes. With a backend config (or more than one worker) they join one
torch.distributed group (gloo on the CPU) and build the DeviceMesh of
ScalingConfig.mesh over the world (train/trainer.py `_use_distributed`).

Two CPU worker processes over gloo (MeshSpec(data=2), one row of the batch
per rank) train a tiny transformer for 3 SGD steps; their losses match the
JAX package's single-process next_token_loss trajectory on the same numpy
tokens and params. This is tests/test_distributed.py:88's parity without
its 75 s jax.distributed rendezvous.
"""

import sys

import numpy as np
import pytest

from ray_tpu_torch.core import serialization

import torch_modes

serialization.register_pickle_by_value(sys.modules[__name__])

N_STEPS, LR = 3, 0.05


@pytest.fixture(scope="module")
def cluster():
    import ray_tpu_torch as rt

    rt.shutdown()
    torch_modes.bounded_init(rt, num_cpus=4, num_gpus=0)
    try:
        yield rt
    finally:
        torch_modes.shutdown_init(rt)


@pytest.fixture(scope="module")
def inputs():
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import transformer as jtfm

    jcfg = jtfm.tiny(dtype=jnp.float32, attn_impl="full")
    params = jax.tree_util.tree_map(np.asarray, jtfm.init_params(jax.random.PRNGKey(0), jcfg))
    batches = [np.random.default_rng(10 + i).integers(0, jcfg.vocab_size, (2, 16),
                                                      dtype=np.int32) for i in range(N_STEPS)]
    return {"params": params, "batches": batches, "lr": LR}


@pytest.fixture(scope="module")
def jax_losses(inputs):
    """The single-process reference: jax.grad of next_token_loss, plain SGD."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import transformer as jtfm

    old = jax.config.jax_default_matmul_precision
    jax.config.update("jax_default_matmul_precision", "highest")
    try:
        jcfg = jtfm.tiny(dtype=jnp.float32, attn_impl="full")
        params = jax.tree_util.tree_map(jnp.asarray, inputs["params"])
        grad_fn = jax.jit(jax.value_and_grad(lambda p, t: jtfm.next_token_loss(p, t, jcfg)))
        losses = []
        for tokens in inputs["batches"]:
            loss, grads = grad_fn(params, jnp.asarray(tokens))
            params = jax.tree_util.tree_map(lambda p, g: p - LR * g, params, grads)
            losses.append(float(loss))
        return losses
    finally:
        jax.config.update("jax_default_matmul_precision", old)


def _sgd_loop(config):
    """The same params and batches, plain SGD, through build_train_step on
    this worker's mesh (a DeviceMesh over the world when distributed)."""
    import os

    import torch
    import torch.distributed as dist

    from ray_tpu_torch import train
    from ray_tpu_torch.models import convert
    from ray_tpu_torch.models import transformer as ttfm
    from ray_tpu_torch.parallel.sharding import shard_tree

    mesh = train.get_mesh()
    distributed = dist.is_initialized()
    tcfg = ttfm.tiny(dtype=torch.float32, attn_impl="full")
    params = convert.params_from_numpy(config["params"], tcfg, device="cpu")
    if distributed:
        params = shard_tree(params, mesh)
    init, step = ttfm.build_train_step(tcfg, lambda ps: torch.optim.SGD(ps, lr=config["lr"]),
                                       device="cpu", mesh=mesh if distributed else None)
    params, opt = init(None, params=params)
    losses = [float(step(params, opt, torch.from_numpy(t))) for t in config["batches"]]
    train.report({"losses": losses, "pid": os.getpid(),
                  "rank": train.get_context().get_world_rank(),
                  "world": dist.get_world_size() if distributed else 1,
                  "backend": dist.get_backend() if distributed else None,
                  "mesh": dict(zip(mesh.mesh_dim_names, mesh.mesh.shape)) if distributed
                  else None})


def _fit(inputs, tmp_path, scaling):
    from ray_tpu_torch.train import RunConfig, TorchTrainer

    result = TorchTrainer(_sgd_loop, train_loop_config=inputs, scaling_config=scaling,
                          run_config=RunConfig(storage_path=str(tmp_path))).fit()
    assert result.error is None, result.error
    return result.metrics


def test_two_gloo_worker_processes_match_jax_single_process(cluster, inputs, jax_losses,
                                                            tmp_path):
    import os

    from ray_tpu_torch.parallel.mesh import MeshSpec
    from ray_tpu_torch.train import ScalingConfig, TorchBackendConfig

    m = _fit(inputs, tmp_path, ScalingConfig(
        num_workers=2, use_gpu=False, mesh=MeshSpec(data=2),
        backend=TorchBackendConfig(backend="gloo")))
    assert m["world"] == 2 and m["backend"] == "gloo" and m["pid"] != os.getpid()
    assert m["mesh"]["data"] == 2
    np.testing.assert_allclose(m["losses"], jax_losses, rtol=1e-5, atol=1e-5)


def test_one_worker_process_without_a_backend_keeps_the_local_mesh(cluster, inputs,
                                                                   jax_losses, tmp_path):
    """One worker and no backend config: the worker is still a process, and
    builds its mesh over its own devices, as the JAX trainer's single-host
    path does; the whole batch, the same trajectory."""
    import os

    from ray_tpu_torch.train import ScalingConfig

    m = _fit(inputs, tmp_path, ScalingConfig(num_workers=1, use_gpu=False))
    assert m["world"] == 1 and m["backend"] is None and m["pid"] != os.getpid()
    np.testing.assert_allclose(m["losses"], jax_losses, rtol=1e-5, atol=1e-5)
