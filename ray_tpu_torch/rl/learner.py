"""TorchLearner and LearnerGroup: the gradient-update side of the RL stack
(the counterpart of ray_tpu/rl/learner.py, whose JaxLearner this is).

A learner owns its module's params on its device (CUDA unless the caller
passes device="cpu"; no card raises) and a torch Adam (eps 1e-8, no weight
decay). An update computes the algorithm's loss, takes the gradients' global
norm (reported as grad_norm, unclipped), scales the gradients by
`grad_clip / norm` only when `norm >= grad_clip` (optax's
clip_by_global_norm; torch's clip_grad_norm_ adds 1e-6 to the norm), and
steps Adam. Gradients of params the loss does not reach are zeros, so every
param's Adam state advances as optax's does.

With num_learners > 1 the learners are actor processes in one
torch.distributed group (gloo on the CPU, NCCL with a card each): each
takes an equal shard of the batch (the ragged tail is trimmed) and averages
its gradients, with its loss metrics, over the group in ONE all-reduce a
step. One blocking collective per step, the same size on every rank, keeps
a rank from meeting another's next collective on one gloo slot (the trap
the JAX package's learner serialises against at ray_tpu/rl/learner.py:84).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from .module import RLModule

PyTree = Any


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of every gradient's squares (optax.global_norm)."""
    return torch.sqrt(sum(torch.sum(g * g) for g in grads))


def clip_by_global_norm_(grads, max_norm: float, norm: torch.Tensor) -> None:
    """optax's clip_by_global_norm in place: g / norm * max_norm where
    norm >= max_norm, else unchanged; no host sync."""
    trigger = norm < max_norm
    for g in grads:
        g.copy_(torch.where(trigger, g, (g / norm) * max_norm))


def batch_to_device(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


class TorchLearner:
    """One learner: params + Adam on its device and the update.

    `loss_fn(module, params, batch) -> (loss, metrics)` comes from the
    algorithm; `optimizer(parameters) -> torch.optim.Optimizer` replaces
    Adam(lr) when given."""

    def __init__(
        self,
        module: RLModule,
        loss_fn: Callable,
        *,
        lr: float = 3e-4,
        optimizer: Optional[Callable] = None,
        grad_clip: Optional[float] = 0.5,
        seed: int = 0,
        device=None,
        average_over_group: bool = False,
    ):
        from .._device import resolve_device

        self.module = module
        self.loss_fn = loss_fn
        self.grad_clip = grad_clip
        self.device = resolve_device(device)
        self.params = module.init_params(torch.Generator().manual_seed(seed), device=self.device)
        self._trainable = [p for p in self.params.parameters() if p.requires_grad]
        self.opt = (optimizer(self._trainable) if optimizer is not None
                    else torch.optim.Adam(self._trainable, lr=lr, eps=1e-8))
        self._average = average_over_group

    def update(self, batch: Dict[str, Any]) -> Dict[str, float]:
        """One gradient step on a [B, ...] batch (numpy or tensors)."""
        batch = batch_to_device(batch, self.device)
        loss, metrics = self.loss_fn(self.module, self.params, batch)
        grads = torch.autograd.grad(loss, self._trainable, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(self._trainable, grads)]
        names = list(metrics)
        values = torch.stack([loss.detach()] + [torch.as_tensor(metrics[k]).detach()
                                                for k in names]).float()
        if self._average:
            values = self._all_reduce_mean(grads, values)
        norm = global_norm(grads)
        if self.grad_clip is not None:
            clip_by_global_norm_(grads, self.grad_clip, norm)
        for p, g in zip(self._trainable, grads):
            p.grad = g
        self.opt.step()
        self.opt.zero_grad(set_to_none=True)
        out = torch.cat([values, norm.reshape(1).float()]).tolist()
        return {**dict(zip(names, out[1:-1])), "total_loss": out[0], "grad_norm": out[-1]}

    @staticmethod
    def _all_reduce_mean(grads, values):
        """Averages the gradients (in place) and the metric values over the
        default group, in one all-reduce of one flat buffer."""
        import torch.distributed as dist

        flat = torch.cat([g.reshape(-1) for g in grads] + [values.to(grads[0].dtype)])
        dist.all_reduce(flat)
        flat /= dist.get_world_size()
        i = 0
        for g in grads:
            g.copy_(flat[i:i + g.numel()].view_as(g))
            i += g.numel()
        return flat[i:]

    def get_weights(self) -> PyTree:
        """The params as the JAX package's tree of host numpy arrays."""
        from ..models.convert import rl_params_to_numpy

        return rl_params_to_numpy(self.params)

    def set_weights(self, params: PyTree) -> bool:
        from ..models.convert import rl_params_from_numpy

        self.params.load_state_dict(rl_params_from_numpy(params, device="cpu").state_dict())
        return True

    # Checkpointable
    def save_state(self, directory: str) -> None:
        """The params (save_pytree, JAX layout) and Adam's state as optax's
        {"count", "mu", "nu"} in that layout (save_aux_state)."""
        from ..models.convert import rl_opt_state_to_numpy
        from ..train.checkpoint import save_aux_state, save_pytree

        save_pytree({"params": self.get_weights()}, directory)
        save_aux_state(directory, rl_opt_state_to_numpy(self.opt, self.params))

    def load_state(self, directory: str) -> None:
        from ..models.convert import rl_opt_state_from_numpy
        from ..train.checkpoint import load_aux_state, load_pytree

        self.set_weights(load_pytree(directory)["params"])
        opt_state = load_aux_state(directory)
        self.opt.state.clear()  # an old checkpoint without one: fresh moments
        if opt_state is not None:
            rl_opt_state_from_numpy(opt_state, self.opt, self.params)


class _DistributedLearner:
    """Actor body: one process of a learner gang. Each joins the default
    torch.distributed group and runs the same update on its shard,
    averaging gradients over the group (the reference's DDP learners)."""

    def __init__(self, rank: int, world_size: int):
        self.rank = rank
        self.world_size = world_size
        self._learner: Optional[TorchLearner] = None

    def setup(self, coordinator: str, backend: str, module: RLModule, loss_fn: Callable,
              lr: float, grad_clip: Optional[float], seed: int, device,
              init_timeout_s: float = 60.0):
        from ..train.backend import setup_torch_distributed

        info = setup_torch_distributed(self.rank, self.world_size, coordinator,
                                       backend=backend, init_timeout_s=init_timeout_s)
        self._learner = TorchLearner(module, loss_fn, lr=lr, grad_clip=grad_clip, seed=seed,
                                     device=device, average_over_group=True)
        return info

    def update(self, shard: Dict[str, np.ndarray]) -> Dict[str, float]:
        return self._learner.update(shard)

    def get_weights(self) -> PyTree:
        return self._learner.get_weights()

    def set_weights(self, params: PyTree) -> bool:
        return self._learner.set_weights(params)

    def save_state(self, directory: str) -> bool:
        self._learner.save_state(directory)
        return True

    def load_state(self, directory: str) -> bool:
        self._learner.load_state(directory)
        return True


class LearnerGroup:
    """Learners behind one update() call. num_learners=1: one learner in
    this process on `device`. num_learners>1: one actor process per learner
    (a GPU each on the card, none with device="cpu"), one torch.distributed
    group, each update split evenly across them."""

    def __init__(
        self,
        module: RLModule,
        loss_fn: Callable,
        *,
        num_learners: int = 1,
        lr: float = 3e-4,
        grad_clip: Optional[float] = 0.5,
        seed: int = 0,
        device=None,
        coordinator_host: Optional[str] = None,
    ):
        from .._device import resolve_device

        self.num_learners = num_learners
        self.device = resolve_device(device)
        self._actors = None
        self._learner = None
        if num_learners <= 1:
            self._learner = TorchLearner(module, loss_fn, lr=lr, grad_clip=grad_clip, seed=seed,
                                         device=self.device)
            return

        from .. import api
        from ..core import runtime_base
        from ..core.local_runtime import LocalRuntime
        from ..train.backend import free_port

        if isinstance(runtime_base.current_runtime(), LocalRuntime):
            raise RuntimeError(
                "num_learners>1 needs process-isolated learner actors; initialize the "
                "cluster runtime (ray_tpu_torch.init()) instead of local_mode=True")
        on_cpu = self.device.type == "cpu"
        coord = f"{coordinator_host or '127.0.0.1'}:{free_port()}"
        actor_cls = api.remote(num_cpus=1, num_gpus=0 if on_cpu else 1)(_DistributedLearner)
        self._actors = [actor_cls.remote(i, num_learners) for i in range(num_learners)]
        api.get([a.setup.remote(coord, "gloo" if on_cpu else "nccl", module, loss_fn, lr,
                                grad_clip, seed, "cpu" if on_cpu else None)
                 for a in self._actors])

    def update(self, batch: Dict[str, np.ndarray]) -> Dict[str, float]:
        if self._actors is None:
            return self._learner.update(batch)
        from .. import api

        n = self.num_learners
        B = len(next(iter(batch.values())))
        # Every learner takes an equal shard (the all-reduce is gang-wide);
        # the ragged tail is trimmed.
        per = B // n
        if per == 0:
            raise ValueError(f"batch of {B} rows is smaller than the {n}-learner gang; "
                             "enlarge the batch or reduce learners")
        refs = [a.update.remote({k: v[i * per:(i + 1) * per] for k, v in batch.items()})
                for i, a in enumerate(self._actors)]
        return api.get(refs)[0]

    def get_weights(self) -> PyTree:
        if self._actors is None:
            return self._learner.get_weights()
        from .. import api

        return api.get(self._actors[0].get_weights.remote())

    def set_weights(self, params: PyTree) -> None:
        if self._actors is None:
            self._learner.set_weights(params)
            return
        from .. import api

        api.get([a.set_weights.remote(params) for a in self._actors])

    def save_state(self, directory: str) -> None:
        if self._actors is None:
            self._learner.save_state(directory)
        else:
            from .. import api

            api.get(self._actors[0].save_state.remote(directory))

    def load_state(self, directory: str) -> None:
        if self._actors is None:
            self._learner.load_state(directory)
        else:
            from .. import api

            api.get([a.load_state.remote(directory) for a in self._actors])

    def shutdown(self) -> None:
        if self._actors:
            from .. import api

            for a in self._actors:
                try:
                    api.kill(a)
                except Exception:  # lint: swallow-ok(learner actor may already be dead)
                    pass
            self._actors = None
