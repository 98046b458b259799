"""Tuner + trial controller: the experiment execution engine (copy of
ray_tpu/tune/tuner.py for the PyTorch port).

Re-design of the reference's Tune stack (reference:
python/ray/tune/tuner.py:44 -> impl/tuner_internal.py:51 -> tune.py:267
tune.run -> execution/tune_controller.py:68 TuneController.step:666).
Trials run as worker actors reusing the train session machinery
(_TrainWorker): each trial's function, passed as itself (nothing is
pickled), reports through the size-1 session queue; the controller
multiplexes over trials with `wait`, consults the
scheduler per result (ASHA stop / PBT exploit), and persists checkpoints
and experiment state for resume.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
import uuid
from typing import Any, Callable, Dict, List, Optional, Union

from .. import api
from ..train.checkpoint import Checkpoint, StorageContext
from ..train.config import RunConfig
from ..train.session import get_checkpoint as _session_get_checkpoint
from ..train.session import report as _session_report
from ..train.trainer import Result, TorchTrainer
from ..train.worker_group import _TrainWorker
from .schedulers import STOP, ExploitDirective, FIFOScheduler, TrialScheduler
from .search import BasicVariantGenerator, Searcher

# Worker-side API: tune.report / tune.get_checkpoint are the same session
# functions train uses (reference: ray.tune.report == ray.train.report in
# the unified AIR session).
report = _session_report
get_checkpoint = _session_get_checkpoint


@dataclasses.dataclass
class TuneConfig:
    """(reference: python/ray/tune/tune_config.py)

    `use_gpu` decides a function trial's mesh as ScalingConfig.use_gpu
    decides a trainer's: the process's CUDA devices, or the CPU with
    use_gpu=False; without a CUDA device the default makes the trial fail
    rather than train on the CPU. A TorchTrainer trainable uses its own
    ScalingConfig's."""

    metric: Optional[str] = None
    mode: str = "max"
    num_samples: int = 1
    max_concurrent_trials: Optional[int] = None
    search_alg: Optional[Searcher] = None
    scheduler: Optional[TrialScheduler] = None
    seed: Optional[int] = None
    use_gpu: bool = True


@dataclasses.dataclass
class Trial:
    """(reference: python/ray/tune/experiment/trial.py:248)"""

    trial_id: str
    config: Dict[str, Any]
    status: str = "PENDING"  # PENDING | RUNNING | TERMINATED | ERROR
    last_result: Dict[str, Any] = dataclasses.field(default_factory=dict)
    iterations: int = 0
    error: Optional[str] = None
    checkpoint_index: int = 0
    latest_checkpoint: Optional[str] = None


class ResultGrid:
    """(reference: python/ray/tune/result_grid.py)"""

    def __init__(self, results: List[Result], metric: Optional[str], mode: str):
        self._results = results
        self._metric = metric
        self._mode = mode

    def __len__(self):
        return len(self._results)

    def __getitem__(self, i):
        return self._results[i]

    @property
    def errors(self) -> List[BaseException]:
        return [r.error for r in self._results if r.error is not None]

    def get_best_result(self, metric: Optional[str] = None, mode: Optional[str] = None) -> Result:
        metric = metric or self._metric
        mode = mode or self._mode
        if metric is None:
            raise ValueError("metric required (set TuneConfig.metric or pass one)")
        ok = [r for r in self._results if metric in r.metrics]
        if not ok:
            raise ValueError(f"no trial reported metric {metric!r}")
        key = lambda r: r.metrics[metric]  # noqa: E731
        return max(ok, key=key) if mode == "max" else min(ok, key=key)


class Tuner:
    """(reference: python/ray/tune/tuner.py:44)"""

    def __init__(
        self,
        trainable: Union[Callable, TorchTrainer],
        *,
        param_space: Optional[Dict[str, Any]] = None,
        tune_config: Optional[TuneConfig] = None,
        run_config: Optional[RunConfig] = None,
    ):
        self._trainable = trainable
        self._param_space = dict(param_space or {})
        self._tune_config = tune_config or TuneConfig()
        self._run_config = run_config or RunConfig()

    # ---------------------------------------------------------------- fit
    def fit(self) -> ResultGrid:
        controller = _TuneController(
            self._trainable,
            self._param_space,
            self._tune_config,
            self._run_config,
            restore_state=getattr(self, "_restore_state", None),
        )
        return controller.run()

    @classmethod
    def restore(
        cls, path: str, trainable: Union[Callable, TorchTrainer], *, use_gpu: bool = True
    ) -> "Tuner":
        """Resume an interrupted experiment from its state file
        (reference: Tuner.restore, tune/impl/tuner_internal.py). `use_gpu`
        as in TuneConfig."""
        with open(os.path.join(path, "experiment_state.json")) as f:
            state = json.load(f)
        tuner = cls(
            trainable,
            param_space={},
            tune_config=TuneConfig(
                metric=state.get("metric"), mode=state.get("mode", "max"), use_gpu=use_gpu
            ),
            run_config=RunConfig(
                name=state["name"], storage_path=os.path.dirname(path.rstrip("/"))
            ),
        )
        tuner._restore_state = state
        return tuner


class _NullSearcher(Searcher):
    def suggest(self, trial_id: str):
        return None


class _TuneController:
    """(reference: tune/execution/tune_controller.py:68)"""

    def __init__(
        self,
        trainable,
        param_space,
        tune_config: TuneConfig,
        run_config: RunConfig,
        restore_state: Optional[Dict[str, Any]] = None,
    ):
        self._restore_state = restore_state
        self._tune_config = tune_config
        self._run_config = run_config
        self._name = run_config.name or f"tune_{uuid.uuid4().hex[:8]}"
        self._storage = StorageContext(run_config.resolved_storage_path(), self._name)
        self._scheduler = tune_config.scheduler or FIFOScheduler()
        self._fn, self._base_config, self._use_gpu = self._resolve_trainable(
            trainable, tune_config.use_gpu
        )

        searcher = tune_config.search_alg
        if searcher is None:
            if restore_state is not None:
                # Resuming: the trial set comes from the saved state, not a
                # fresh sweep of the (empty) param space.
                searcher = _NullSearcher()
            else:
                searcher = BasicVariantGenerator(
                    param_space, num_samples=tune_config.num_samples, seed=tune_config.seed
                )
        self._searcher = searcher

        self._trials: Dict[str, Trial] = {}
        # Shared event-driven execution layer (reference:
        # air/execution/_internal/actor_manager.py:22 RayActorManager —
        # the controller declares actors + callbacks; the manager owns
        # the wait loop and in-flight bookkeeping).
        from ..air import ActorManager

        self._mgr = ActorManager()
        self._trial_actor: Dict[str, Any] = {}  # trial_id -> TrackedActor

    @staticmethod
    def _resolve_trainable(trainable, use_gpu: bool):
        if isinstance(trainable, TorchTrainer):
            # BaseTrainer-as-trainable (reference: base_trainer.py:701-715):
            # each trial runs trainer.fit with the trial config merged into
            # train_loop_config, inside the trial worker.
            base_trainer = trainable

            def fn(config):
                t = TorchTrainer(
                    base_trainer._train_loop,
                    train_loop_config={**base_trainer._config, **config},
                    scaling_config=base_trainer.scaling_config,
                    run_config=dataclasses.replace(
                        base_trainer.run_config, name=f"inner_{uuid.uuid4().hex[:6]}"
                    ),
                )
                result = t.fit()
                if result.error is not None:
                    raise result.error
                report(result.metrics)

            return fn, dict(base_trainer._config), base_trainer.scaling_config.use_gpu
        return trainable, {}, use_gpu

    # ------------------------------------------------------------ lifecycle
    def _launch_trial(self, trial: Trial, checkpoint_path: Optional[str] = None) -> None:
        worker_cls = api.remote(max_concurrency=4)(_TrainWorker)
        tracked = self._mgr.add_actor(worker_cls, 0, 1)
        actor = tracked.handle
        # Fire-and-forget launch: blocking on a setup ack here deadlocks a
        # full cluster — this actor may be QUEUED behind running trials
        # whose results only this loop can consume. Mesh setup rides
        # inside start_training (concurrent actors don't order methods).
        actor.start_training.remote(
            self._fn,
            {**self._base_config, **trial.config},
            trial.trial_id,
            checkpoint_path or trial.latest_checkpoint,
            None,
            self._use_gpu,
        )
        trial.status = "RUNNING"
        self._trial_actor[trial.trial_id] = tracked
        self._schedule_next_result(trial)

    def _schedule_next_result(self, trial: Trial) -> None:
        tracked = self._trial_actor[trial.trial_id]
        self._mgr.schedule_task(
            tracked,
            "next_result",
            on_result=lambda payload, t=trial: self._handle_result(t, payload),
            on_error=lambda e, t=trial: self._stop_trial(t, "ERROR", error=repr(e)),
        )

    def _stop_trial(
        self, trial: Trial, status: str, error: Optional[str] = None, *, notify: bool = True
    ) -> None:
        tracked = self._trial_actor.pop(trial.trial_id, None)
        if tracked is not None:
            try:
                # Unblock the training thread (it unwinds with TrialAborted
                # at its next report) before tearing the actor down.
                api.get(tracked.handle.stop_training.remote())
            except Exception:  # the trial actor may already be dead; removed below
                pass
            self._mgr.remove_actor(tracked, kill=True)
        trial.status = status
        trial.error = error
        # PBT exploit restarts the same trial; completion callbacks would
        # corrupt stateful searchers, so they only fire on real completion.
        if notify:
            self._scheduler.on_complete(trial.trial_id, trial.last_result or None)
            if isinstance(self._searcher, Searcher):
                self._searcher.on_trial_complete(
                    trial.trial_id, trial.last_result or None, error=status == "ERROR"
                )
        self._save_state(force=True)

    # -------------------------------------------------------------- events
    def _handle_result(self, trial: Trial, payload: Optional[Dict[str, Any]]) -> None:
        tracked = self._trial_actor.get(trial.trial_id)
        actor = tracked.handle if tracked is not None else None
        if payload is None:
            # Training function returned: drain/join and terminate. The
            # terminal _stop_trial sits OUTSIDE the try: if it partially
            # ran (notified the searcher) and then raised, the except would
            # re-notify the same trial as ERROR and corrupt stateful
            # searchers.
            try:
                api.get(actor.join.remote())
            except Exception as e:  # noqa: BLE001
                trial.last_result.setdefault("error", str(e))
                self._stop_trial(trial, "ERROR", error=repr(e))
                return
            self._stop_trial(trial, "TERMINATED")
            return

        metrics = dict(payload["metrics"])
        trial.iterations += 1
        metrics.setdefault("training_iteration", trial.iterations)
        metrics.setdefault("trial_id", trial.trial_id)
        trial.last_result = metrics

        ckpt_path = payload.get("checkpoint")
        if ckpt_path:
            persisted = StorageContext(
                self._storage.storage_path, self._name, trial.trial_id
            ).persist_checkpoint(Checkpoint(ckpt_path), trial.checkpoint_index)
            trial.checkpoint_index += 1
            trial.latest_checkpoint = persisted.path

        self._searcher.on_trial_result(trial.trial_id, metrics)
        decision = self._scheduler.on_result(trial.trial_id, metrics)

        if isinstance(decision, ExploitDirective):
            source = self._trials.get(decision.source_trial_id)
            src_ckpt = source.latest_checkpoint if source else None
            self._stop_trial(trial, "PENDING", notify=False)
            trial.config = decision.new_config
            self._launch_trial(trial, checkpoint_path=src_ckpt)
        elif decision == STOP:
            self._stop_trial(trial, "TERMINATED")
        else:
            self._schedule_next_result(trial)
        self._save_state()

    # ----------------------------------------------------------------- run
    def run(self) -> ResultGrid:
        from ..tune.schedulers import PopulationBasedTraining

        max_conc = self._tune_config.max_concurrent_trials or 8
        next_index = 0

        # Resume (reference: Tuner.restore): terminated trials keep their
        # recorded results; unfinished trials relaunch from their latest
        # checkpoint with their saved config.
        if self._restore_state:
            for saved in self._restore_state.get("trials", []):
                trial = Trial(
                    trial_id=saved["trial_id"],
                    config=saved.get("config", {}),
                    status=saved.get("status", "PENDING"),
                    last_result=saved.get("last_result", {}),
                    iterations=saved.get("iterations", 0),
                    error=saved.get("error"),
                    checkpoint_index=saved.get("checkpoint_index", 0),
                    latest_checkpoint=saved.get("latest_checkpoint"),
                )
                self._trials[trial.trial_id] = trial
                idx = int(trial.trial_id.rsplit("_", 1)[-1]) + 1
                next_index = max(next_index, idx)
                if trial.status not in ("TERMINATED", "ERROR"):
                    self._launch_trial(trial)

        while True:
            # Launch while there is capacity.
            while self._mgr.num_live_actors < max_conc:
                cfg = self._searcher.suggest(f"trial_{next_index:05d}")
                if cfg is None:
                    break
                trial = Trial(trial_id=f"trial_{next_index:05d}", config=cfg)
                next_index += 1
                self._trials[trial.trial_id] = trial
                if isinstance(self._scheduler, PopulationBasedTraining):
                    self._scheduler.register_config(trial.trial_id, cfg)
                self._launch_trial(trial)

            if not self._mgr.num_pending_tasks:
                break

            # One event: the manager waits fairly (random polling order)
            # and dispatches the trial's on_result/on_error callback.
            self._mgr.next()

        self._save_state(force=True)
        results = []
        for trial in self._trials.values():
            results.append(
                Result(
                    metrics=trial.last_result,
                    checkpoint=Checkpoint(trial.latest_checkpoint)
                    if trial.latest_checkpoint
                    else None,
                    path=os.path.join(self._storage.experiment_dir, trial.trial_id),
                    error=RuntimeError(trial.error) if trial.error else None,
                )
            )
        return ResultGrid(results, self._tune_config.metric, self._tune_config.mode)

    # --------------------------------------------------------------- state
    def _save_state(self, force: bool = False) -> None:
        # Throttled on the hot result path: O(trials) JSON serialization per
        # report would make state I/O quadratic in a large sweep.
        now = time.monotonic()
        if not force and now - getattr(self, "_last_state_save", 0.0) < 5.0:
            return
        self._last_state_save = now
        self._storage.write_json(
            "experiment_state.json",
            {
                "name": self._name,
                "metric": self._tune_config.metric,
                "mode": self._tune_config.mode,
                "trials": [dataclasses.asdict(t) for t in self._trials.values()],
            },
        )
