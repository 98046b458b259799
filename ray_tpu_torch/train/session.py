"""Worker-side training session: report(), checkpoints, rank info (copy
of ray_tpu/train/session.py for the PyTorch port).

Mirrors the reference's _TrainSession (reference:
python/ray/train/_internal/session.py:111; report at :403/:667 puts a
result on a size-1 queue consumed by the coordinator's TrainingIterator,
train/trainer.py:124). Same backpressure design here: `report` blocks until
the coordinator consumes the previous result, keeping worker and driver in
lockstep and bounding memory.
"""

from __future__ import annotations

import contextlib
import queue
import threading
import time as _time
from typing import Any, Dict, Optional

from .checkpoint import Checkpoint


class TrialAborted(BaseException):
    """Raised inside a training thread when the controller cancels the
    trial; derives from BaseException so user `except Exception` blocks
    don't swallow the unwind."""


_session_lock = threading.Lock()
_session: Optional["TrainSession"] = None
# Thread-keyed registry: in the thread-based local runtime all worker
# "actors" share one process, so each training thread must resolve to ITS
# session, not a process global (cross-wiring num_workers>1 otherwise).
_thread_sessions: dict = {}


class TrainSession:
    def __init__(
        self,
        world_rank: int,
        world_size: int,
        local_rank: int = 0,
        trial_name: str = "",
        checkpoint: Optional[Checkpoint] = None,
        target_world_size: Optional[int] = None,
    ):
        self.world_rank = world_rank
        self.world_size = world_size
        # Elastic runs: the world size the user ASKED for. A loop can
        # check `world_size < target_world_size` (degraded mode) to e.g.
        # rescale its per-step token budget or log the deficit.
        self.target_world_size = (
            target_world_size if target_world_size is not None else world_size
        )
        self.local_rank = local_rank
        self.trial_name = trial_name
        self._starting_checkpoint = checkpoint
        # maxsize=1: report() blocks until the previous result is consumed
        # (reference: session.py:204).
        self._result_queue: "queue.Queue" = queue.Queue(maxsize=1)
        self._finished = threading.Event()
        self._cancelled = threading.Event()
        self._drain = threading.Event()
        self._last_report_ts: Optional[float] = None
        # Efficiency telemetry (configure_telemetry): model FLOPs for the
        # MFU computation + per-step phase-time accumulators.
        self._flops_per_token: Optional[float] = None
        self._peak_flops: Optional[float] = None
        self._phase_seconds: Dict[str, float] = {}
        self._phase_lock = threading.Lock()
        # This rank's dataset shards (name -> iterator), read via
        # train.get_dataset_shard(); empty until Data is ported (ROADMAP
        # Queue 1 item 6).
        self.dataset_shards: Dict[str, Any] = {}

    # ------------------------------------------------------------ user API
    def report(self, metrics: Dict[str, Any], checkpoint: Optional[Checkpoint] = None):
        metrics = self._enrich_metrics(metrics)
        self._observe_report(metrics)
        payload = {"metrics": dict(metrics), "checkpoint": checkpoint}
        while True:
            if self._cancelled.is_set():
                raise TrialAborted()
            try:
                self._result_queue.put(payload, timeout=0.1)
                return
            except queue.Full:
                continue

    def configure_telemetry(
        self,
        flops_per_token: Optional[float] = None,
        peak_flops_per_s: Optional[float] = None,
    ) -> None:
        """Arms MFU computation: with `flops_per_token` (e.g. from
        models/transformer.py:flops_per_token) every report carrying
        `tokens_per_s` gains an `mfu` metric, against `peak_flops_per_s`
        or the CUDA devices' peak (observability/goodput.py)."""
        if flops_per_token is not None:
            self._flops_per_token = float(flops_per_token)
        if peak_flops_per_s is not None:
            self._peak_flops = float(peak_flops_per_s)

    @contextlib.contextmanager
    def phase(self, name: str):
        """Marks a step phase (data_wait / compute / allreduce / ...):
        duration lands in the raytpu_train_phase_time_ms histogram, a
        tracing span (when tracing is on), and the per-step
        `phase_seconds` breakdown attached to the next report."""
        from .. import tracing
        from ..utils import internal_metrics as imet

        t0 = _time.perf_counter()
        try:
            with tracing.maybe_span(f"train.phase.{name}", {"phase": name}):
                yield
        finally:
            dt = _time.perf_counter() - t0
            imet.TRAIN_PHASE_TIME.observe(dt * 1e3, phase=name)
            with self._phase_lock:
                self._phase_seconds[name] = self._phase_seconds.get(name, 0.0) + dt

    def _enrich_metrics(self, metrics: Dict[str, Any]) -> Dict[str, Any]:
        """Derived efficiency metrics folded into the user's report: MFU
        (when configure_telemetry armed it and tokens_per_s is present)
        and the per-step phase breakdown (reset each report)."""
        out = dict(metrics)
        tps = out.get("tokens_per_s")
        if (
            "mfu" not in out
            and isinstance(tps, (int, float))
            and self._flops_per_token
        ):
            from ..observability import goodput as _goodput

            value = _goodput.mfu(
                float(tps), self._flops_per_token, self._peak_flops
            )
            if value is not None:
                out["mfu"] = value
        with self._phase_lock:
            if self._phase_seconds and "phase_seconds" not in out:
                out["phase_seconds"] = {
                    k: round(v, 6) for k, v in self._phase_seconds.items()
                }
            self._phase_seconds = {}
        return out

    def _observe_report(self, metrics: Dict[str, Any]) -> None:
        """Internal train telemetry: report-to-report interval is the step
        time of the training loop, and recognized throughput keys
        (tokens_per_s, mfu) mirror into gauges without user-defined
        metrics."""
        from ..utils import internal_metrics as imet

        now = _time.monotonic()
        imet.TRAIN_REPORTS.inc()
        if self._last_report_ts is not None:
            imet.TRAIN_STEP_TIME.observe((now - self._last_report_ts) * 1e3)
        self._last_report_ts = now
        trial = self.trial_name or "default"
        rank = str(self.world_rank)
        for key, gauge in (
            ("tokens_per_s", imet.TRAIN_TOKENS_PER_S),
            ("mfu", imet.TRAIN_MFU),
        ):
            v = metrics.get(key)
            if isinstance(v, (int, float)):
                gauge.set(float(v), trial=trial, rank=rank)

    def get_checkpoint(self) -> Optional[Checkpoint]:
        return self._starting_checkpoint

    def drain_requested(self) -> bool:
        """True once the gang's node received a preemption notice. A
        cooperative training loop checks this each step and reacts with a
        final `report(metrics, checkpoint=...)` then returns — the
        drain -> checkpoint half of preemption recovery. Loops that never
        check still recover (the trainer falls back to the periodic
        checkpoint), they just lose the steps since it."""
        return self._drain.is_set()

    def request_drain(self) -> None:
        self._drain.set()

    # ------------------------------------------------------ coordinator API
    def next_result(self, timeout: Optional[float] = None) -> Optional[Dict[str, Any]]:
        """Returns the next reported result, or None once training finished
        and the queue is drained."""
        while True:
            try:
                return self._result_queue.get(timeout=0.1)
            except queue.Empty:
                if self._finished.is_set():
                    try:
                        return self._result_queue.get_nowait()
                    except queue.Empty:
                        return None
                if timeout is not None:
                    timeout -= 0.1
                    if timeout <= 0:
                        raise TimeoutError("no training result within timeout")

    def mark_finished(self):
        self._finished.set()

    def cancel(self):
        """Controller-side abort: unblocks a report() in flight and makes
        the training thread unwind with TrialAborted at its next report."""
        self._cancelled.set()
        try:
            self._result_queue.get_nowait()
        except queue.Empty:
            pass

    # --------------------------------------------------- thread attachment
    def attach_to_current_thread(self) -> None:
        """Binds this session to the calling (training) thread so
        `train.report()` inside user code resolves to it even when several
        worker actors share the process."""
        with _session_lock:
            _thread_sessions[threading.get_ident()] = self

    def detach_from_current_thread(self) -> None:
        with _session_lock:
            _thread_sessions.pop(threading.get_ident(), None)


def init_session(**kwargs) -> TrainSession:
    global _session
    with _session_lock:
        _session = TrainSession(**kwargs)
        return _session


def get_session() -> Optional[TrainSession]:
    with _session_lock:
        s = _thread_sessions.get(threading.get_ident())
    return s if s is not None else _session


def shutdown_session(session: Optional[TrainSession] = None):
    global _session
    with _session_lock:
        if session is None or _session is session:
            _session = None
        if session is not None:
            stale = [k for k, v in _thread_sessions.items() if v is session]
            for k in stale:
                _thread_sessions.pop(k, None)


# ----------------------------------------------------------- user functions
# (the `ray.train.report` / `get_context` equivalents, reference:
# python/ray/train/_internal/session.py module-level helpers)


def report(metrics: Dict[str, Any], checkpoint: Optional[Checkpoint] = None) -> None:
    s = get_session()
    if s is None:
        raise RuntimeError("train.report() called outside a training session")
    s.report(metrics, checkpoint)


def get_checkpoint() -> Optional[Checkpoint]:
    s = get_session()
    return s.get_checkpoint() if s else None


def drain_requested() -> bool:
    """Whether this worker's node is draining (preemption notice). See
    TrainSession.drain_requested."""
    s = get_session()
    return s.drain_requested() if s else False


def get_dataset_shard(name: str = "train"):
    """This rank's shard of a trainer-attached dataset (the
    `ray.train.get_dataset_shard` analogue). None outside a session or for
    an unknown name, and always None until Data is ported (the trainer's
    `datasets=` raises until then)."""
    s = get_session()
    if s is None:
        return None
    return s.dataset_shards.get(name)


def phase(name: str):
    """Step-phase marker for the training loop:

        with train.phase("data_wait"):
            batch = next(it)
        with train.phase("compute"):
            loss = step(params, optimizer, batch)

    Durations land in the raytpu_train_phase_time_ms histogram (by
    phase tag), tracing spans, and the next report's `phase_seconds`
    breakdown. A no-op outside a session."""
    s = get_session()
    return s.phase(name) if s else contextlib.nullcontext()


def configure_telemetry(
    flops_per_token: Optional[float] = None,
    peak_flops_per_s: Optional[float] = None,
) -> None:
    """See TrainSession.configure_telemetry. No-op outside a session."""
    s = get_session()
    if s is not None:
        s.configure_telemetry(flops_per_token, peak_flops_per_s)


class TrainContext:
    def get_world_rank(self) -> int:
        s = get_session()
        return s.world_rank if s else 0

    def get_world_size(self) -> int:
        s = get_session()
        return s.world_size if s else 1

    def get_target_world_size(self) -> int:
        """The world size the run was CONFIGURED for; larger than
        get_world_size() while an elastic run is in degraded mode."""
        s = get_session()
        return s.target_world_size if s else 1

    def is_degraded(self) -> bool:
        s = get_session()
        return bool(s) and s.world_size < s.target_world_size

    def get_local_rank(self) -> int:
        s = get_session()
        return s.local_rank if s else 0

    def get_trial_name(self) -> str:
        s = get_session()
        return s.trial_name if s else ""


def get_context() -> TrainContext:
    return TrainContext()
