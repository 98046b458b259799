"""TorchTrainer: the DataParallelTrainer equivalent on the port's runtime
(the counterpart of ray_tpu/train/trainer.py's JaxTrainer).

Reference call stack being re-designed:
BaseTrainer.fit (python/ray/train/base_trainer.py:567) ->
DataParallelTrainer.training_loop (data_parallel_trainer.py:428) ->
BackendExecutor.start (train/_internal/backend_executor.py:135) ->
WorkerGroup actors.

The trainer creates a gang of worker actors, each builds its mesh of the
process's CUDA devices (or the CPU with ScalingConfig(use_gpu=False)), and
the user's `train_loop_per_worker` runs in each worker's training thread.
Results flow back through the size-1 session queue exactly as in the
reference (TrainingIterator, train/trainer.py:124).

On the cluster runtime (`init()`), with a backend config or more than one
worker, each worker is an actor process that joins one torch.distributed
group (NCCL on the card, gloo on the CPU) and builds its DeviceMesh over the
world (`_use_distributed`; the JAX trainer's multi-host branch,
ray_tpu/train/trainer.py:347-358 and :433-455). The trainer's preemption,
elastic-grow, capacity-wait and node-drain arms are not ported yet (ROADMAP
Queue 1 item 3).
"""

from __future__ import annotations

import dataclasses
import uuid
from typing import Any, Callable, Dict, Optional

from .. import api
from ..core.placement_group import placement_group as create_pg
from ..core.placement_group import remove_placement_group
from ..observability import goodput as _goodput
from ..observability.flight_recorder import record as _flight_record
from ..parallel.mesh import default_devices
from ..utils import internal_metrics as imet
from .checkpoint import Checkpoint, CheckpointManager, StorageContext
from .config import CheckpointConfig, RunConfig, ScalingConfig
from .worker_group import WorkerGroup


@dataclasses.dataclass
class Result:
    """(reference: python/ray/air/result.py Result)"""

    metrics: Dict[str, Any]
    checkpoint: Optional[Checkpoint]
    path: str
    error: Optional[BaseException] = None


class TorchTrainer:
    """Data-parallel training over a worker gang.

    Usage (the JaxTrainer's surface, which mirrors the reference's
    TorchTrainer, so call sites port mechanically):

        def train_loop(config):
            device = train.get_mesh().devices.flat[0]
            ... build the model and optimizer on device, step ...
            train.report({"loss": ...}, checkpoint=...)

        trainer = TorchTrainer(
            train_loop,
            train_loop_config={"lr": 1e-3},
            scaling_config=ScalingConfig(num_workers=1),
            run_config=RunConfig(name="exp"),
        )
        result = trainer.fit()
    """

    def __init__(
        self,
        train_loop_per_worker: Callable,
        *,
        train_loop_config: Optional[Dict[str, Any]] = None,
        scaling_config: Optional[ScalingConfig] = None,
        run_config: Optional[RunConfig] = None,
        datasets: Optional[Dict[str, Any]] = None,
        dataset_config: str = "object_store",
        resume_from_checkpoint: Optional[Checkpoint] = None,
    ):
        self._train_loop = train_loop_per_worker
        self._config = dict(train_loop_config or {})
        self.scaling_config = scaling_config or ScalingConfig()
        self.run_config = run_config or RunConfig()
        if dataset_config not in ("object_store", "channel"):
            raise ValueError(
                f"dataset_config must be 'object_store' or 'channel', got {dataset_config!r}"
            )
        if datasets:
            raise NotImplementedError(
                "TorchTrainer(datasets=...) waits for the port of Data (ROADMAP Queue 1 "
                "item 6); read the data inside the training loop until then"
            )
        self._resume_from = resume_from_checkpoint

    # ------------------------------------------------------------------ fit
    def fit(self) -> Result:
        # Raises without a CUDA device unless use_gpu=False: never train on
        # the CPU in place of the GPU.
        default_devices(self.scaling_config.use_gpu)
        if self.scaling_config.backend is not None and _in_process():
            raise NotImplementedError(
                "ScalingConfig(backend=...) is read only on the cluster runtime "
                "(init() without local_mode); the in-process runtime keeps each worker's "
                "local mesh and would ignore it")
        name = self.run_config.name or f"TorchTrainer_{uuid.uuid4().hex[:8]}"
        storage = StorageContext(self.run_config.resolved_storage_path(), name)
        ckpt_cfg: CheckpointConfig = self.run_config.checkpoint_config
        manager = CheckpointManager(
            num_to_keep=ckpt_cfg.num_to_keep,
            score_attribute=ckpt_cfg.checkpoint_score_attribute,
            score_order=ckpt_cfg.checkpoint_score_order,
        )
        max_failures = self.run_config.failure_config.max_failures
        attempt = 0
        resume_ckpt = self._resume_from
        last_error: Optional[BaseException] = None
        metrics: Dict[str, Any] = {}
        # Goodput ledger: fit() is the one supervisor that sees every
        # lifecycle transition, so it owns the category switches
        # (observability/goodput.py). Public for inspection/tests.
        self.goodput = _goodput.GoodputAccountant()
        restored = False  # next attempt recomputes lost steps first
        # Persisted checkpoints are numbered across attempts: a restarted
        # attempt numbering from 0 again would copy over a kept checkpoint's
        # directory, which keep-K then deletes as the older entry (the JAX
        # package's trainer does; ROADMAP Queue 3).
        self._ckpt_index = 0

        while True:
            try:
                metrics = self._run_attempt(storage, manager, resume_ckpt, rework=restored)
                last_error = None
                break
            except (KeyboardInterrupt, SystemExit):
                raise  # user abort is not a training failure
            except Exception as e:  # noqa: BLE001 - recorded in the Result
                last_error = e
                metrics = getattr(self, "_last_metrics", {})
                attempt += 1
                # Restart from the latest checkpoint (reference:
                # FailureConfig via Tune, base_trainer.py:577 resume path).
                resume_ckpt = manager.latest_checkpoint or resume_ckpt
                if max_failures >= 0 and attempt > max_failures:
                    break
                if resume_ckpt is not None:
                    imet.CHECKPOINTS_RESTORED.inc()
                    restored = True
                    _flight_record("train.restore", (resume_ckpt.path, attempt))

        self.goodput.finish()
        snap = self.goodput.snapshot()
        metrics = dict(metrics)
        metrics["goodput"] = snap["goodput"]
        metrics["goodput_seconds"] = snap["seconds"]
        imet.TRAIN_GOODPUT.set(snap["goodput"], trial=name)
        storage.write_json(
            "result.json",
            {"metrics": metrics, "error": repr(last_error) if last_error else None},
        )
        return Result(
            metrics=metrics,
            checkpoint=manager.best_checkpoint or manager.latest_checkpoint,
            path=storage.trial_dir,
            error=last_error,
        )

    def _use_distributed(self) -> bool:
        """Workers rendezvous in one torch.distributed group when they are
        processes (the cluster runtime) and there is a backend config or more
        than one of them; the in-process runtime keeps the local mesh."""
        sc = self.scaling_config
        if sc.backend is None and sc.num_workers <= 1:
            return False
        return not _in_process()

    def _resources_per_worker(self) -> Optional[Dict[str, float]]:
        """On the cluster runtime a GPU worker asks for a whole GPU unless
        resources_per_worker names its share: the raylet then starts it with
        CUDA_VISIBLE_DEVICES naming its device."""
        sc = self.scaling_config
        res = dict(sc.resources_per_worker or {})
        if sc.use_gpu and "GPU" not in res and not _in_process():
            res["GPU"] = 1.0
        return res or None

    # ---------------------------------------------------------------- inner
    def _run_attempt(
        self,
        storage: StorageContext,
        manager: CheckpointManager,
        resume_ckpt: Optional[Checkpoint],
        rework: bool = False,
    ) -> Dict[str, Any]:
        # Until the first fresh result lands, this attempt's wall time is
        # either setup (first attempt) or restart-rework (re-reaching the
        # restored step after a failure — work already done once).
        acct = self.goodput
        acct.begin(_goodput.RESTART_REWORK if rework else _goodput.SETUP)

        sc = self.scaling_config
        ws = sc.num_workers
        trial = storage.trial_name or storage.experiment_name
        imet.TRAIN_WORLD_SIZE.set(float(ws), trial=trial)
        res = self._resources_per_worker()
        pg = None
        if ws > 1:
            bundles = [dict(res or {"CPU": 1}) for _ in range(ws)]
            pg = create_pg(bundles, strategy=sc.placement_strategy)
            if not pg.ready(timeout=60.0):
                raise RuntimeError(
                    f"placement group for {ws}-worker gang not ready in 60s"
                )

        group = WorkerGroup(
            ws,
            resources_per_worker=res,
            placement_group=pg,
            target_world_size=sc.num_workers,
        )
        self._last_metrics: Dict[str, Any] = {}
        try:
            # Backend setup (reference: train/_internal/backend_executor.py:135
            # -> Backend.on_start, torch/config.py:66). Distributed: every
            # worker process joins the group and builds the world's
            # DeviceMesh. Otherwise each worker builds its mesh over its own
            # devices as it starts.
            mesh_axes = sc.mesh
            if self._use_distributed():
                from .backend import TorchBackendConfig, coordinator_address

                cfg = sc.backend or TorchBackendConfig()
                coord = coordinator_address(cfg)
                api.get([w.setup_distributed.remote(coord, sc.mesh, sc.use_gpu, cfg.backend,
                                                    cfg.init_timeout_s)
                         for w in group.workers])
            api.get(
                [
                    w.start_training.remote(
                        self._train_loop,
                        dict(self._config),
                        trial,
                        resume_ckpt.path if resume_ckpt else None,
                        mesh_axes,
                        sc.use_gpu,
                    )
                    for w in group.workers
                ]
            )

            while True:
                results = api.get([w.next_result.remote() for w in group.workers])
                if all(r is None for r in results):
                    break
                live = [r for r in results if r is not None]
                if acct.category != _goodput.PRODUCTIVE:
                    # First fresh result of this attempt: steps are
                    # advancing — setup/rework ends here.
                    acct.begin(_goodput.PRODUCTIVE)
                rank0 = results[0] if results[0] is not None else live[0]
                self._last_metrics = dict(rank0["metrics"])
                ckpt_path = rank0.get("checkpoint")
                if ckpt_path:
                    acct.begin(_goodput.CHECKPOINT)
                    persisted = storage.persist_checkpoint(Checkpoint(ckpt_path),
                                                           self._ckpt_index)
                    manager.register(persisted, self._last_metrics)
                    self._ckpt_index += 1
                    acct.begin(_goodput.PRODUCTIVE)
                    imet.TRAIN_GOODPUT.set(acct.fraction(), trial=trial)

            api.get([w.join.remote() for w in group.workers])
            return self._last_metrics
        finally:
            group.shutdown()
            if pg is not None:
                remove_placement_group(pg)


def _in_process() -> bool:
    """Whether the current runtime is the in-process one (init(local_mode=True))."""
    from ..core import runtime_base
    from ..core.local_runtime import LocalRuntime

    return isinstance(runtime_base.current_runtime(), LocalRuntime)
