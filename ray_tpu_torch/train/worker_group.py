"""WorkerGroup: N training-worker actors, gang-placed (copy of
ray_tpu/train/worker_group.py for the PyTorch port).

Mirrors the reference's WorkerGroup (reference:
python/ray/train/_internal/worker_group.py:102, execute at :260): a generic
"run this function on every worker" pool of actors, each hosting one
training thread. On the in-process runtime the callable is passed as itself;
on the cluster runtime each worker is an actor process and the callable
travels through core/serialization.py.
"""

from __future__ import annotations

import threading
import traceback
from typing import Any, Callable, Dict, List, Optional

from .. import api
from ..core.placement_group import PlacementGroupSchedulingStrategy
from .session import init_session, shutdown_session


class _TrainWorker:
    """Actor body hosting one training worker."""

    def __init__(self, rank: int, world_size: int, target_world_size: int = 0):
        self.rank = rank
        self.world_size = world_size
        self.target_world_size = target_world_size or world_size
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._mesh = None
        self._device = None
        self._session = None
        self._drain_flag = False

    def setup_distributed(self, coordinator: str, mesh_spec, use_gpu: bool, backend=None,
                          init_timeout_s: float = 60.0):
        """The cluster backend's setup (the counterpart of the JAX worker's
        jax.distributed rendezvous, ray_tpu/train/worker_group.py:48-74;
        reference: train/torch/config.py:66 _setup_torch_process_group):
        joins the torch.distributed group as this rank, then builds the
        DeviceMesh of `mesh_spec` over the whole world. With use_gpu the
        mesh is on this rank's CUDA device (under gloo too: ranks may share
        a card), and a worker that finds no CUDA device raises instead of
        training on the CPU; without it the mesh is on the CPU."""
        import torch

        from ..parallel.mesh import build_device_mesh, default_devices
        from .backend import setup_torch_distributed

        if use_gpu:
            default_devices(True)  # raises without a CUDA device
        info = setup_torch_distributed(self.rank, self.world_size, coordinator,
                                       backend=backend, init_timeout_s=init_timeout_s)
        if use_gpu:  # NCCL set it already; gloo ranks pick theirs alike
            torch.cuda.set_device(self.rank % torch.cuda.device_count())
        self._mesh = build_device_mesh(mesh_spec, device_type="cuda" if use_gpu else "cpu")
        self._device = (torch.device("cuda", torch.cuda.current_device()) if use_gpu
                        else torch.device("cpu"))
        info["mesh_devices"] = int(self._mesh.mesh.numel())
        info["device"] = str(self._device)
        return info

    # generic execute (reference: worker_group.py execute)
    def execute(self, fn: Callable, *args, **kwargs):
        return fn(*args, **kwargs)

    def start_training(
        self,
        fn: Callable,
        config: Dict[str, Any],
        trial_name: str,
        checkpoint_path: Optional[str],
        mesh_axes,
        use_gpu: bool,
    ):
        """Builds this worker's mesh (the process's CUDA devices, or the CPU
        with use_gpu=False; `mesh_axes` is axis sizes, or a MeshSpec resolved
        against those devices) and starts `fn` in the training thread. The
        mesh is built here rather than in a method of its own: a concurrent
        actor (max_concurrency>1) gives no cross-method ordering, and Tune
        launches fire-and-forget. After setup_distributed the world's
        DeviceMesh is kept instead."""
        from ..parallel.mesh import MeshSpec, build_mesh, default_devices
        from .checkpoint import Checkpoint

        try:
            if self._device is None:
                if isinstance(mesh_axes, MeshSpec):
                    mesh_axes = mesh_axes.resolve(len(default_devices(use_gpu)))
                self._mesh = build_mesh(axis_sizes=mesh_axes, use_gpu=use_gpu)
                self._device = self._mesh.devices.flat[0]
            ckpt = Checkpoint(checkpoint_path) if checkpoint_path else None
            session = init_session(
                world_rank=self.rank,
                world_size=self.world_size,
                trial_name=trial_name,
                checkpoint=ckpt,
                target_world_size=self.target_world_size,
            )
        except BaseException as e:  # noqa: BLE001
            # Fire-and-forget launches discard this call's ref: record the
            # failure where next_result() re-raises it.
            self._error = e
            raise
        session.mesh = self._mesh
        session.device = self._device
        # Resolve this rank's dataset shards: a ChannelFeed handle becomes a
        # live ChannelDataIterator HERE (the consuming process hosts the
        # reader's ring); plain split iterators pass through. Copy, never
        # pop: on the in-process runtime every worker receives the SAME
        # config dict object.
        shard_lists = config.get("__dataset_shards__") or {}
        for ds_name, shards in shard_lists.items():
            shard = shards[self.rank]
            session.dataset_shards[ds_name] = (
                shard.iterator() if hasattr(shard, "iterator") else shard
            )
        if shard_lists:
            config = {k: v for k, v in config.items() if k != "__dataset_shards__"}
        if self._drain_flag:
            # A drain notice landed before the session existed (a restart
            # racing the notice): the new session starts drained.
            session.request_drain()
        self._session = session
        device = self._device

        def run():
            import torch

            from .session import TrialAborted

            session.attach_to_current_thread()
            try:
                # The current CUDA device is per thread: the loop's default
                # device is this worker's (its mesh's first device).
                if device.type == "cuda":
                    torch.cuda.set_device(device)
                # Every worker of the in-process runtime receives the SAME
                # config dict object: nothing on this side may pop from it.
                if _takes_config(fn):
                    fn(config)
                else:
                    fn()
            except TrialAborted:
                pass  # controller-initiated stop; not an error
            except BaseException as e:  # noqa: BLE001 - re-raised by next_result/join
                self._error = e
                # The error outlives the attempt (here and in fit's
                # last_error): drop the finished frames' locals, which hold
                # the failed loop's tensors. The traceback's lines remain.
                traceback.clear_frames(e.__traceback__)
            finally:
                session.detach_from_current_thread()
                session.mark_finished()

        self._thread = threading.Thread(target=run, name=f"train-rank{self.rank}", daemon=True)
        self._thread.start()
        return True

    def next_result(self, timeout_s=None):
        """One reported result, None once training finished, or the
        `{"__pending__": True}` sentinel when `timeout_s` elapsed with
        nothing reported: the bounded form keeps the trainer's supervision
        loop responsive (it must see a drain notice while every worker is
        mid-step). The actor serves other calls meanwhile (max_concurrency
        4), so a request_drain is never queued behind this wait."""
        import time as _time

        # The launch is fire-and-forget and this actor runs methods on a
        # thread pool: next_result can land before start_training has
        # initialized the session — wait for it (bounded) instead of
        # reporting a phantom end-of-training.
        deadline = _time.monotonic() + 600.0
        while self._session is None:
            if self._error is not None:
                raise self._error
            if _time.monotonic() > deadline:
                return None
            _time.sleep(0.02)
        try:
            out = self._session.next_result(timeout=timeout_s)
        except TimeoutError:
            return {"__pending__": True}
        if out is None and self._error is not None:
            raise self._error
        if out is not None and out.get("checkpoint") is not None:
            out = dict(out)
            out["checkpoint"] = out["checkpoint"].path
        return out

    def stop_training(self):
        """Cancels the running training thread: the next report() inside the
        user function raises TrialAborted and the thread unwinds (no zombie
        threads blocked on the size-1 queue)."""
        if self._session is not None:
            self._session.cancel()
        return True

    def request_drain(self):
        """Relays a preemption notice into the session: the loop's next
        `train.drain_requested()` returns True, asking for a final
        checkpoint and a clean return before the node dies."""
        self._drain_flag = True
        if self._session is not None:
            self._session.request_drain()
        return True

    def join(self):
        if self._thread is not None:
            self._thread.join()
        shutdown_session(self._session)
        if self._error is not None:
            raise self._error
        return True

    def ping(self):
        return self.rank


def _takes_config(fn) -> bool:
    import inspect

    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return True
    return len(sig.parameters) >= 1


class WorkerGroup:
    """Driver-side handle to the gang of training workers."""

    def __init__(
        self,
        num_workers: int,
        resources_per_worker: Optional[Dict[str, float]] = None,
        placement_group=None,
        target_world_size: int = 0,
    ):
        self.num_workers = num_workers
        self.target_world_size = target_world_size or num_workers
        opts: Dict[str, Any] = {"max_concurrency": 4}
        res = dict(resources_per_worker or {})
        if "CPU" in res:
            opts["num_cpus"] = res.pop("CPU")
        if "GPU" in res:
            opts["num_gpus"] = res.pop("GPU")
        if res:
            opts["resources"] = res
        worker_cls = api.remote(**opts)(_TrainWorker)
        self._workers = []
        for rank in range(num_workers):
            w_opts = {}
            if placement_group is not None:
                w_opts["scheduling_strategy"] = PlacementGroupSchedulingStrategy(
                    placement_group=placement_group, placement_group_bundle_index=rank
                )
            self._workers.append(
                worker_cls.options(**w_opts).remote(
                    rank, num_workers, self.target_world_size
                )
                if w_opts
                else worker_cls.remote(rank, num_workers, self.target_world_size)
            )
        # Barrier on construction.
        api.get([w.ping.remote() for w in self._workers])

    @property
    def workers(self) -> List[Any]:
        return list(self._workers)

    def execute(self, fn: Callable, *args, **kwargs) -> List[Any]:
        """Runs fn on every worker, returns all results
        (reference: worker_group.py:260)."""
        return api.get([w.execute.remote(fn, *args, **kwargs) for w in self._workers])

    def execute_single(self, rank: int, fn: Callable, *args, **kwargs) -> Any:
        return api.get(self._workers[rank].execute.remote(fn, *args, **kwargs))

    def shutdown(self):
        for w in self._workers:
            try:
                api.kill(w)
            except Exception:  # lint: swallow-ok(worker may already be dead)
                pass
        self._workers = []
