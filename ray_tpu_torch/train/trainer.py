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
ray_tpu/train/trainer.py:347-358 and :433-455).

Datasets (`datasets={"train": ds}`): each attempt splits every dataset once
over its world (`streaming_split(world, equal=True)`), as plain shard
iterators sharing one SplitCoordinator actor (`dataset_config=
"object_store"`) or as ChannelFeed handles of one BlockFeeder actor
(`"channel"`); each worker resolves its rank's shard, and the loop reads it
through `train.get_dataset_shard(name).iter_device_batches(...)`.

Preemption (the cluster runtime only; the in-process runtime has no nodes to
lose). A node_events watcher (utils/node_events.py) maps a `node_draining`
notice to the gang's nodes; the trainer then asks every worker to drain
(`train.drain_requested()` turns True: a cooperative loop reports a final
checkpoint and returns), keeps taking results until the gang stops, and
raises PreemptionError. fit() restores from the latest checkpoint on a
budget of its own (MAX_PREEMPTION_RETRIES), not FailureConfig.max_failures,
after waiting for capacity; with ScalingConfig(elastic=True) a wait that
runs out re-forms the gang smaller, and a later checkpoint with capacity
back for num_workers grows it back (_ElasticGrow). A node that dies without
a notice stays a failure and spends max_failures.
"""

from __future__ import annotations

import dataclasses
import time
import uuid
from typing import Any, Callable, Dict, List, Optional, Set

from .. import api
from .. import exceptions as exc
from ..core import runtime_base
from ..core.placement_group import placement_group as create_pg
from ..core.placement_group import remove_placement_group
from ..observability import goodput as _goodput
from ..observability.flight_recorder import record as _flight_record
from ..parallel.mesh import default_devices
from ..utils import internal_metrics as imet
from ..utils import node_events
from ..utils.node_events import NodeEventWatcher
from .checkpoint import Checkpoint, CheckpointManager, StorageContext
from .config import CheckpointConfig, RunConfig, ScalingConfig
from .worker_group import WorkerGroup

# Preemptions are capacity events, not training failures: they retry on
# their own (bounded) budget instead of spending FailureConfig.max_failures.
MAX_PREEMPTION_RETRIES = 16
# How long fit() waits for replacement capacity after a preemption before
# downsizing (elastic) or failing fast with CapacityTimeoutError
# (ScalingConfig.capacity_wait_s overrides).
CAPACITY_WAIT_S = 120.0
# A bounded result round on the cluster runtime: a worker mid-step answers
# "pending" after this long, so the drain check runs again.
RESULT_ROUND_S = 2.0


class _ElasticGrow(Exception):
    """Internal control flow: capacity for the full target gang returned
    and a checkpoint just landed; re-form the gang at target size."""


@dataclasses.dataclass
class Result:
    """(reference: python/ray/air/result.py Result)"""

    metrics: Dict[str, Any]
    checkpoint: Optional[Checkpoint]
    path: str
    error: Optional[BaseException] = None

    @property
    def best_checkpoints(self) -> List[Checkpoint]:
        return [self.checkpoint] if self.checkpoint else []


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
        self._datasets = dict(datasets or {})
        if dataset_config not in ("object_store", "channel"):
            raise ValueError(
                f"dataset_config must be 'object_store' or 'channel', got {dataset_config!r}"
            )
        self._dataset_config = dataset_config
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
        preemptions = 0
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
        # package's trainer does; ROADMAP Queue 3). A grow-back or a restore
        # after a preemption keeps counting up too.
        self._ckpt_index = 0
        sc = self.scaling_config
        # The gang the NEXT attempt launches with: the target, moved down
        # by _renegotiate_capacity when capacity misses the wait, and back
        # to the target by _ElasticGrow at a checkpoint boundary.
        self._world_size = sc.num_workers
        wait_budget = sc.capacity_wait_s if sc.capacity_wait_s is not None else CAPACITY_WAIT_S

        while True:
            try:
                metrics = self._run_attempt(storage, manager, resume_ckpt, rework=restored,
                                            world_size=self._world_size)
                last_error = None
                break
            except (KeyboardInterrupt, SystemExit):
                raise  # user abort is not a training failure
            except _ElasticGrow:
                # Capacity for the full gang returned and a checkpoint just
                # landed: re-form at target size and resume at that step.
                # Neither a failure nor a preemption: no budget is spent.
                metrics = getattr(self, "_last_metrics", {})
                resume_ckpt = manager.latest_checkpoint or resume_ckpt
                self._world_size = sc.num_workers
                restored = True
                imet.TRAIN_ELASTIC_RESIZES.inc(direction="growback")
                _flight_record("train.elastic_growback", (sc.num_workers,))
                if resume_ckpt is not None:
                    imet.CHECKPOINTS_RESTORED.inc()
            except (exc.PreemptionError, exc.SchedulingError, exc.RpcUnavailableError) as e:
                # A notice drained the gang, or the gang could not be placed
                # or reached (its nodes died or are cut off): a capacity
                # event, not a training failure. Restore on replacement
                # capacity on the preemption budget (bounded, so a flapping
                # cluster still ends); a gang no node can host fails with
                # CapacityTimeoutError once the wait runs out.
                last_error = e
                metrics = getattr(self, "_last_metrics", {})
                preemptions += 1
                resume_ckpt = manager.latest_checkpoint or resume_ckpt
                if preemptions > MAX_PREEMPTION_RETRIES:
                    break
                if resume_ckpt is not None:
                    imet.CHECKPOINTS_RESTORED.inc()
                restored = True
                _flight_record("train.restore",
                               (resume_ckpt.path if resume_ckpt else None, preemptions))
                # Waiting out replacement capacity is drain-wait time.
                self.goodput.begin(_goodput.DRAIN_WAIT)
                if not self._renegotiate_capacity(wait_budget):
                    # No feasible gang within the budget: fail with the typed
                    # error instead of launching a doomed attempt.
                    err = self._capacity_error
                    if err is not None:
                        err.__cause__ = e
                        last_error = err
                    break
                if not isinstance(e, exc.PreemptionError):
                    # A node whose raylet is cut off looks alive until the
                    # GCS declares it dead, so the wait above can return at
                    # once: pause 0.5 s, doubling up to 8 s, before relaunching.
                    time.sleep(min(0.5 * 2 ** (preemptions - 1), 8.0))
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
        # once=True: the terminal value ships on one flush and then stops,
        # so the goodput_floor watchdog rule can clear after a run ends.
        imet.TRAIN_GOODPUT.set(snap["goodput"], once=True, trial=name)
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

    def _feasible_workers(self) -> int:
        """How many gang workers the cluster could ever host now: over alive
        nodes that are not draining, how many workers fit each node's total
        (not its available) resources, since the restored attempt frees its
        own. The in-process runtime reports the target (nothing to
        negotiate)."""
        sc = self.scaling_config
        need = self._resources_per_worker() or {"CPU": 1.0}
        gcs = getattr(runtime_base.current_runtime(), "_gcs", None)
        if gcs is None:
            return sc.num_workers
        try:
            nodes = gcs.call("list_nodes")
        except Exception:  # noqa: BLE001 - an unreachable GCS offers no capacity
            return 0
        # STRICT_SPREAD places at most one bundle per node: count fitting
        # nodes, or a world the placement group can never form would pass.
        one_per_node = sc.placement_strategy == "STRICT_SPREAD"
        total = 0
        for n in nodes:
            if not n.get("Alive") or n.get("Draining"):
                continue
            res = n.get("Resources") or {}
            fits = [int(res.get(k, 0.0) // v) for k, v in need.items() if v > 0]
            per_node = max(0, min(fits)) if fits else 1
            total += min(per_node, 1) if one_per_node else per_node
        return total

    def _wait_for_capacity(self, n_workers: Optional[int] = None,
                           timeout_s: float = CAPACITY_WAIT_S) -> bool:
        """Blocks until the cluster can host an `n_workers` gang. Wakes on
        node events (node_added / node_draining / node_dead) with a 1 s
        re-check as fallback. True at once on the in-process runtime."""
        need = n_workers if n_workers is not None else self.scaling_config.num_workers
        gcs = getattr(runtime_base.current_runtime(), "_gcs", None)
        if gcs is None:
            return True
        watcher: Optional[NodeEventWatcher] = None
        try:
            try:
                watcher = NodeEventWatcher(gcs)
            except Exception:  # noqa: BLE001 - fall back to polling
                watcher = None
            deadline = time.monotonic() + timeout_s
            while True:
                if self._feasible_workers() >= need:
                    return True
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                if watcher is not None:
                    watcher.wait_for_event(min(1.0, remaining))
                else:
                    time.sleep(min(0.5, remaining))
        finally:
            if watcher is not None:
                watcher.stop()

    def _renegotiate_capacity(self, timeout_s: float) -> bool:
        """After a preemption: waits for capacity for the full target; when
        the wait runs out, an elastic run takes the largest feasible world
        >= min_workers, and any other run records a CapacityTimeoutError.
        True when fit() should launch the next attempt (self._world_size is
        set), False to fail (self._capacity_error is set)."""
        sc = self.scaling_config
        target = sc.num_workers
        self._capacity_error: Optional[exc.CapacityTimeoutError] = None
        if self._wait_for_capacity(target, timeout_s=timeout_s):
            self._world_size = target
            return True
        feasible = self._feasible_workers()
        if sc.elastic and feasible >= sc.elastic_floor:
            new_world = min(feasible, target)
            _flight_record("train.elastic_downsize", (self._world_size, new_world, target))
            imet.TRAIN_ELASTIC_RESIZES.inc(direction="downsize")
            self._world_size = new_world
            return True
        self._capacity_error = exc.CapacityTimeoutError(
            target, feasible, timeout_s, sc.elastic_floor if sc.elastic else 0)
        _flight_record("train.capacity_timeout", (target, feasible, timeout_s))
        return False

    @staticmethod
    def _gang_nodes(gcs, group: WorkerGroup) -> Set[str]:
        """The node ids that host the gang's worker actors."""
        ids = {w._actor_id.hex() for w in group.workers}
        return {nid for aid, nid in node_events.actor_locations(gcs).items()
                if aid in ids and nid}

    def _split_shards(self, ds: Any, ws: int) -> List[Any]:
        """One coordinated equal split of `ds` into ws per-rank handles:
        ChannelFeed handles (dataset_config="channel") or plain shard
        iterators (the coordinator made before they ship, so every rank
        shares ONE SplitCoordinator actor)."""
        split = ds.streaming_split(ws)
        if self._dataset_config == "channel":
            return split.to_channel()
        split.prepare_shipping()
        return list(split)

    def _use_distributed(self, world_size: Optional[int] = None) -> bool:
        """Workers rendezvous in one torch.distributed group when they are
        processes (the cluster runtime) and there is a backend config or more
        than one of them; the in-process runtime keeps the local mesh."""
        sc = self.scaling_config
        n = world_size if world_size is not None else sc.num_workers
        if sc.backend is None and n <= 1:
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
        world_size: Optional[int] = None,
    ) -> Dict[str, Any]:
        # Until the first fresh result lands, this attempt's wall time is
        # either setup (first attempt) or restart-rework (re-reaching the
        # restored step after a failure or preemption: work already done).
        acct = self.goodput
        acct.begin(_goodput.RESTART_REWORK if rework else _goodput.SETUP)

        sc = self.scaling_config
        ws = world_size if world_size is not None else sc.num_workers
        trial = storage.trial_name or storage.experiment_name
        # An attempt below target runs in the DEGRADED goodput category,
        # credited at world / target.
        imet.TRAIN_WORLD_SIZE.set(float(ws), trial=trial)
        productive_cat = _goodput.PRODUCTIVE
        if ws < sc.num_workers:
            productive_cat = _goodput.DEGRADED
            acct.set_weight(_goodput.DEGRADED, ws / max(1, sc.num_workers))
        res = self._resources_per_worker()
        pg = None
        if ws > 1:
            bundles = [dict(res or {"CPU": 1}) for _ in range(ws)]
            pg = create_pg(bundles, strategy=sc.placement_strategy)
            # A re-formed gang (restore, grow-back) races the previous
            # gang's teardown: wait for the bundles.
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
        # Preemption awareness (cluster runtime only): node_draining notices
        # and the nodes that host this gang.
        watcher: Optional[NodeEventWatcher] = None
        gang_nodes: Set[str] = set()
        gcs = getattr(runtime_base.current_runtime(), "_gcs", None)
        if gcs is not None:
            try:
                watcher = NodeEventWatcher(gcs)
                gang_nodes = self._gang_nodes(gcs, group)
            except Exception:  # noqa: BLE001 - no watcher: a lost node is a failure
                watcher = None
        try:
            # Backend setup (reference: train/_internal/backend_executor.py:135
            # -> Backend.on_start, torch/config.py:66). Distributed: every
            # worker process joins the group and builds the world's
            # DeviceMesh. Otherwise each worker builds its mesh over its own
            # devices as it starts.
            if self._use_distributed(ws):
                from .backend import TorchBackendConfig, coordinator_address

                cfg = sc.backend or TorchBackendConfig()
                coord = coordinator_address(cfg)
                api.get([w.setup_distributed.remote(coord, sc.mesh, sc.use_gpu, cfg.backend,
                                                    cfg.init_timeout_s)
                         for w in group.workers])
            config = dict(self._config)
            if self._datasets:
                config["__datasets__"] = self._datasets
                # Per-rank shards (train.get_dataset_shard resolves them in
                # the worker): one coordinated streaming_split per dataset
                # per attempt, so an elastic restart re-splits at the new
                # world size.
                config["__dataset_shards__"] = {
                    ds_name: self._split_shards(ds, ws)
                    for ds_name, ds in self._datasets.items()
                }
            api.get(
                [
                    w.start_training.remote(
                        self._train_loop,
                        config,
                        trial,
                        resume_ckpt.path if resume_ckpt else None,
                        sc.mesh,
                        sc.use_gpu,
                    )
                    for w in group.workers
                ]
            )

            drained: Set[str] = set()
            while True:
                if watcher is not None and not drained:
                    # A notice, not just a death: only a real preemption
                    # notice earns the preemption budget; a node that died
                    # unannounced takes the max_failures path.
                    drained = watcher.drain_noticed(gang_nodes)
                    if drained:
                        # Ask every worker for a final checkpoint and a clean
                        # return; results keep flowing below, so that
                        # checkpoint is persisted before the raise.
                        _flight_record("train.drain", tuple(sorted(drained)))
                        acct.begin(_goodput.DRAIN_WAIT)
                        for w in group.workers:
                            try:
                                w.request_drain.remote()
                            except Exception:  # lint: swallow-ok(worker already dead; drain moot)
                                pass
                # Bounded rounds on the cluster runtime: a worker mid-step
                # answers "pending", so the drain check above runs again
                # before the notice's grace runs out.
                round_timeout = RESULT_ROUND_S if watcher is not None else None
                try:
                    results = api.get([w.next_result.remote(round_timeout)
                                       for w in group.workers])
                except Exception:
                    if drained:
                        # A worker died inside the drain grace (the deadline
                        # beat its final checkpoint): still the preemption.
                        raise exc.PreemptionError(sorted(drained))
                    raise
                if all(r is None for r in results):
                    break
                live = [r for r in results if r is not None and not r.get("__pending__")]
                if not live:
                    continue  # every worker is mid-step: poll again
                if not drained and acct.category != productive_cat:
                    # First fresh result of this attempt: steps are
                    # advancing (DEGRADED below target).
                    acct.begin(productive_cat)
                rank0 = (results[0] if results[0] is not None
                         and not results[0].get("__pending__") else live[0])
                self._last_metrics = dict(rank0["metrics"])
                ckpt_path = rank0.get("checkpoint")
                if ckpt_path:
                    if not drained:
                        acct.begin(_goodput.CHECKPOINT)
                    persisted = storage.persist_checkpoint(Checkpoint(ckpt_path),
                                                           self._ckpt_index)
                    manager.register(persisted, self._last_metrics)
                    self._ckpt_index += 1
                    if not drained:
                        acct.begin(productive_cat)
                    imet.TRAIN_GOODPUT.set(acct.fraction(), trial=trial)
                    if (ws < sc.num_workers and not drained
                            and self._feasible_workers() >= sc.num_workers):
                        # Grow-back at the checkpoint boundary: capacity for
                        # the full gang is back, and the checkpoint just
                        # persisted is its resume point.
                        raise _ElasticGrow()

            try:
                api.get([w.join.remote() for w in group.workers])
            except Exception:
                if drained:
                    raise exc.PreemptionError(sorted(drained))
                raise
            if drained:
                # The gang stopped because its node is going away, not
                # because training finished: restore from the final
                # checkpoint on replacement capacity.
                raise exc.PreemptionError(sorted(drained))
            return self._last_metrics
        finally:
            if watcher is not None:
                watcher.stop()
            group.shutdown()
            if pg is not None:
                remove_placement_group(pg)


def _in_process() -> bool:
    """Whether the current runtime is the in-process one (init(local_mode=True))."""
    from ..core import runtime_base
    from ..core.local_runtime import LocalRuntime

    return isinstance(runtime_base.current_runtime(), LocalRuntime)
