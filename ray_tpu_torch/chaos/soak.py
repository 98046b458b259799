"""A seeded membership soak: partition, heal, kill and preempt events against
a live cluster while workloads run (the port of tools/chaos_soak.py's
SoakCampaign and run_soak, which import the JAX package).

Two runs with the same seed replay the same campaign. The invariants are
checked after every event and at the end:

- **Named-actor singleton**: the GCS actor table never shows more than one
  ALIVE record for the soak counter, and after the campaign exactly one
  instance answers (two instances surviving a healed partition fail here).
- **Counter exactly-once**: every client op carries a fresh op id, and the
  counter actor writes it to the GCS KV before it acknowledges. At the end
  every acknowledged op is applied exactly once, every applied op was
  attempted, and an op that errored at the client is applied at most once.
- **No wedged gets**: a background task workload finishes, or raises a
  typed error, within a bound.
- **Trainer consistency** (``use_trainer``): an elastic ``TorchTrainer.fit``
  (one CPU worker, ``train_slot`` on every worker node) survives the campaign,
  and its history equals a fault-free golden run: every step exactly once,
  no gaps, no repeats.

Events touch worker nodes only (the head, which hosts the driver, is
spared): ``partition_gcs`` (one node's raylet cut off from the GCS,
symmetric or one-way, self-healing after a few seconds), ``heal`` (the
oldest partition early), ``kill`` (a node's processes killed and a
replacement added), ``preempt`` (a drain notice with a short deadline).

Usage: ``run_soak(seed, duration_s, nodes=2, use_trainer=False)`` returns a
SoakResult whose ``ok`` is False when an invariant broke (``summary()`` says
which). From a shell::

    python -m ray_tpu_torch.chaos.soak --seed 7 --duration 60 --nodes 2 [--trainer]

prints the summary and exits 1 when an invariant broke.
"""

from __future__ import annotations

import argparse
import functools
import os
import random
import tempfile
import threading
import time
import uuid
from typing import Any, Dict, List, Optional, Set

from ..observability.logs import get_logger

KV_PREFIX = "soakctr/"
COUNTER_NAME = "soak_counter"
_SLOTS = {"soak_slot": 4.0, "train_slot": 1.0}

_log = get_logger("chaos.soak")


class SoakCounter:
    """Increments are written to the GCS KV before they are acknowledged: an
    acknowledged op implies a key. The key holds the instance's pid and a
    nonce, so an op applied twice shows as two keys under one op id."""

    def __init__(self):
        self.n = 0

    def incr(self, op_id: str) -> int:
        from ..core.runtime_base import current_runtime

        current_runtime()._gcs.call(
            "kv_put", f"{KV_PREFIX}{op_id}/{os.getpid()}-{uuid.uuid4().hex[:6]}", b"1")
        self.n += 1
        return self.n

    def whereami(self) -> int:
        return os.getpid()


def _probe(x):
    return x * 2


class SoakResult:
    def __init__(self):
        self.ops_acked: Set[str] = set()
        self.ops_errored: Set[str] = set()
        self.events: List[Dict[str, Any]] = []
        self.violations: List[str] = []
        self.task_rounds = 0
        self.fenced_total = 0.0
        self.trainer_ok: Optional[bool] = None

    @property
    def ok(self) -> bool:
        return not self.violations

    def summary(self) -> str:
        ev: Dict[str, int] = {}
        for e in self.events:
            ev[e["kind"]] = ev.get(e["kind"], 0) + 1
        return (f"events={ev} acked={len(self.ops_acked)} errored={len(self.ops_errored)} "
                f"task_rounds={self.task_rounds} fenced={self.fenced_total:.0f} "
                f"trainer_ok={self.trainer_ok} violations={self.violations or 'none'}")


def _golden_trajectory(n_steps: int):
    """The trainer arm's history in a run without faults."""
    w = 1.0
    out = []
    for step in range(n_steps):
        w = w * 0.9 + 0.1
        out.append((step, round(w, 12)))
    return out


def _train_loop(n_steps: int, step_sleep: float, config) -> None:
    """A scalar recurrence that resumes from its checkpoint: the history it
    reports is the golden trajectory whatever the faults, if every step is
    reported once."""
    from .. import train

    w, start, history = 1.0, 0, []
    ckpt = train.get_checkpoint()
    if ckpt is not None:
        d = ckpt.to_dict()
        start, w, history = d["step"] + 1, d["w"], list(d["history"])
    for step in range(start, n_steps):
        w = w * 0.9 + 0.1
        history.append((step, round(w, 12)))
        train.report({"loss": w, "step": step}, checkpoint=train.Checkpoint.from_dict(
            {"step": step, "w": w, "history": history}))
        if train.drain_requested():
            return
        time.sleep(step_sleep)


def _deterministic_train_loop(n_steps: int, step_sleep: float = 0.05):
    return functools.partial(_train_loop, n_steps, step_sleep)


class SoakCampaign:
    """One seeded campaign against a cluster this object boots and owns."""

    def __init__(self, seed: int, duration_s: float, *, nodes: int = 2,
                 cpus_per_node: float = 2.0, event_period_s: float = 1.5,
                 use_trainer: bool = False, trainer_steps: int = 20,
                 storage_path: Optional[str] = None):
        self.seed = seed
        self.rng = random.Random(seed)
        self.duration_s = duration_s
        self.nodes = nodes
        self.cpus_per_node = cpus_per_node
        self.event_period_s = event_period_s
        self.use_trainer = use_trainer
        self.trainer_steps = trainer_steps
        self.storage_path = storage_path
        self.result = SoakResult()
        self._stop = threading.Event()
        self._partitions: List[Any] = []
        self._workers: List[str] = []  # the worker nodes this campaign added

    # ----------------------------------------------------------- lifecycle
    def run(self) -> SoakResult:
        # Short membership clocks, so a short campaign sees whole
        # partition -> dead -> heal -> fence -> rejoin cycles; the daemons
        # started below read them.
        os.environ.setdefault("RAY_TPU_HEARTBEAT_INTERVAL_S", "0.25")
        os.environ.setdefault("RAY_TPU_HEARTBEAT_TIMEOUT_S", "1.5")
        os.environ["RAY_TPU_CHAOS_SEED"] = str(self.seed)

        import ray_tpu_torch as rt
        from ..core import runtime_base
        from ..core.cluster_runtime import Cluster

        self.rt = rt
        rt.shutdown()
        self.cluster = Cluster(num_cpus=self.cpus_per_node)
        self.runtime = self.cluster.runtime()
        runtime_base.set_runtime(self.runtime)
        self.gcs = self.runtime._gcs
        try:
            for _ in range(self.nodes):
                self._workers.append(self.cluster.add_node(num_cpus=self.cpus_per_node,
                                                           resources=dict(_SLOTS)))
            counter = rt.remote(max_restarts=-1, resources={"soak_slot": 0.01})(SoakCounter)
            self.counter = counter.options(name=COUNTER_NAME).remote()
            rt.get(self.counter.whereami.remote(), timeout=30)
            threads = [threading.Thread(target=self._counter_client, daemon=True,
                                        name="soak-counter"),
                       threading.Thread(target=self._task_client, daemon=True, name="soak-tasks")]
            if self.use_trainer:
                threads.append(threading.Thread(target=self._trainer, daemon=True,
                                                name="soak-trainer"))
            for t in threads:
                t.start()
            deadline = time.monotonic() + self.duration_s
            while time.monotonic() < deadline:
                self._one_event()
                self._check_singleton_record()
                time.sleep(self.event_period_s * self.rng.uniform(0.6, 1.4))
            # Quiesce: heal everything; fences, rejoins and restarts settle.
            for p in self._partitions:
                p.heal()
            self._stop.set()
            for t in threads:
                t.join(timeout=90)
                if t.is_alive():
                    self.result.violations.append(
                        f"workload thread {t.name} wedged past the quiesce join")
            self._final_checks()
        finally:
            self._stop.set()
            for p in self._partitions:
                try:
                    p.heal()
                except Exception:  # lint: swallow-ok(the heal_after deadline covers a failed heal)
                    pass
            try:
                self.runtime.shutdown()
            finally:
                self.cluster.shutdown()
                runtime_base.set_runtime(None)
        return self.result

    # ------------------------------------------------------------ workloads
    def _counter_client(self) -> None:
        while not self._stop.is_set():
            op_id = uuid.uuid4().hex[:12]
            try:
                self.rt.get(self.counter.incr.remote(op_id), timeout=30)
                self.result.ops_acked.add(op_id)
            except Exception:  # noqa: BLE001 - indeterminate: applied once at most
                self.result.ops_errored.add(op_id)
                time.sleep(0.2)
            time.sleep(0.05)

    def _task_client(self) -> None:
        probe = self.rt.remote(_probe)
        while not self._stop.is_set():
            t0 = time.monotonic()
            try:
                assert self.rt.get(probe.remote(21), timeout=60) == 42
                self.result.task_rounds += 1
            except Exception as e:  # noqa: BLE001 - only a wedge is a violation
                if time.monotonic() - t0 >= 59:
                    self.result.violations.append(f"task get wedged >60s: {type(e).__name__}")
            time.sleep(0.1)

    def _trainer(self) -> None:
        from ..train import FailureConfig, RunConfig, ScalingConfig, TorchTrainer

        with tempfile.TemporaryDirectory(prefix="soak_exp_") as tmp:
            trainer = TorchTrainer(
                _deterministic_train_loop(self.trainer_steps),
                # use_gpu=False: the loop is a scalar recurrence on the CPU.
                scaling_config=ScalingConfig(
                    num_workers=1, resources_per_worker={"train_slot": 1.0},
                    elastic=True, min_workers=1, use_gpu=False),
                run_config=RunConfig(name=f"soak_{self.seed}",
                                     storage_path=self.storage_path or tmp,
                                     failure_config=FailureConfig(max_failures=8)))
            try:
                result = trainer.fit()
                if result.error is not None or result.checkpoint is None:
                    self.result.trainer_ok = False
                    self.result.violations.append(
                        f"trainer did not recover: {result.error!r}")
                    return
                history = [tuple(x) for x in result.checkpoint.to_dict()["history"]]
            except Exception as e:  # noqa: BLE001 - recorded as a violation
                self.result.trainer_ok = False
                self.result.violations.append(f"trainer raised: {e!r}")
                return
        self.result.trainer_ok = history == _golden_trajectory(self.trainer_steps)
        if not self.result.trainer_ok:
            self.result.violations.append(
                "trainer loss trajectory diverged from the fault-free golden run "
                f"(got {len(history)} steps)")

    # -------------------------------------------------------------- events
    def _alive_workers(self) -> List[str]:
        alive = {n["NodeID"] for n in self.gcs.call("list_nodes") if n["Alive"]}
        return [w for w in self._workers if w in alive]

    def _one_event(self) -> None:
        from . import net

        kind = self.rng.choice(["partition_gcs", "partition_gcs", "heal", "kill", "preempt"])
        candidates = self._alive_workers()
        rec: Dict[str, Any] = {"kind": kind, "ts": time.time()}
        try:
            if kind == "partition_gcs" and candidates:
                victim = self.rng.choice(candidates)
                one_way = self.rng.random() < 0.3
                self._partitions.append(net.partition(
                    [[victim], ["gcs"]], one_way=one_way,
                    heal_after=self.rng.uniform(3.0, 6.0), runtime=self.runtime))
                rec.update(node=victim[:8], one_way=one_way)
            elif kind == "heal":
                live = [p for p in self._partitions if not p.healed]
                if live:
                    live[0].heal()
                    rec.update(spec=live[0].spec_id)
                else:
                    rec["kind"] = "noop"
            elif kind == "kill" and len(candidates) >= 2:
                victim = self.rng.choice(candidates)
                self.cluster.remove_node(victim)
                self._workers.remove(victim)
                self._workers.append(self.cluster.add_node(num_cpus=self.cpus_per_node,
                                                           resources=dict(_SLOTS)))
                rec.update(node=victim[:8])
            elif kind == "preempt" and candidates:
                victim = self.rng.choice(candidates)
                self.gcs.call("report_preemption", victim, self.rng.uniform(1.0, 3.0),
                              "soak preempt")
                rec.update(node=victim[:8])
            else:
                rec["kind"] = "noop"
        except Exception as e:  # noqa: BLE001 - recorded with the event
            rec.update(error=repr(e))
        self.result.events.append(rec)

    # ----------------------------------------------------------- invariants
    def _check_singleton_record(self) -> None:
        try:
            actors = self.gcs.call("list_actors", 100_000)
        except Exception:  # noqa: BLE001 - checked again after the next event
            return
        alive = [a for a in actors if a.get("name") == COUNTER_NAME and a["state"] == "ALIVE"]
        if len(alive) > 1:
            self.result.violations.append(
                f"{len(alive)} ALIVE records for named actor {COUNTER_NAME!r}")

    def _final_checks(self) -> None:
        pid = None
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            try:
                pid = self.rt.get(self.counter.whereami.remote(), timeout=15)
                break
            except Exception:  # noqa: BLE001 - retried until the deadline
                time.sleep(0.5)
        if pid is None:
            self.result.violations.append("named counter unreachable after quiesce")
        self._check_singleton_record()
        applied: Dict[str, int] = {}
        try:
            for key in self.gcs.call("kv_keys", KV_PREFIX):
                op_id = key[len(KV_PREFIX):].split("/", 1)[0]
                applied[op_id] = applied.get(op_id, 0) + 1
        except Exception as e:  # noqa: BLE001 - an audit that cannot run is a violation
            self.result.violations.append(f"could not audit KV: {e!r}")
            return
        attempted = self.result.ops_acked | self.result.ops_errored
        lost = [op for op in self.result.ops_acked if applied.get(op, 0) == 0]
        duped = sorted(op for op, n in applied.items() if n > 1)
        phantom = [op for op in applied if op not in attempted]
        if lost:
            self.result.violations.append(f"{len(lost)} acked increment(s) lost (e.g. {lost[:3]})")
        if duped:
            self.result.violations.append(
                f"{len(duped)} op(s) applied more than once (e.g. {duped[:3]})")
        if phantom:
            self.result.violations.append(f"{len(phantom)} applied op(s) never attempted")
        try:
            from ..utils import state

            self.result.fenced_total = sum(m["value"] for m in state.internal_metrics()
                                           if m["name"] == "raytpu_nodes_fenced_total")
        except Exception as e:  # noqa: BLE001 - informational: the campaign's verdict stands
            _log.warning("could not read raytpu_nodes_fenced_total: %r", e)


def run_soak(seed: int, duration_s: float, **kwargs) -> SoakResult:
    return SoakCampaign(seed, duration_s, **kwargs).run()


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m ray_tpu_torch.chaos.soak",
                                 description=__doc__.split("\n", 1)[0])
    ap.add_argument("--seed", type=int,
                    default=int(os.environ.get("RAY_TPU_CHAOS_SEED", "0") or 0))
    ap.add_argument("--duration", type=float, default=60.0)
    ap.add_argument("--nodes", type=int, default=2)
    ap.add_argument("--event-period", type=float, default=1.5)
    ap.add_argument("--trainer", action="store_true")
    args = ap.parse_args(argv)
    result = run_soak(args.seed, args.duration, nodes=args.nodes,
                      event_period_s=args.event_period, use_trainer=args.trainer)
    print(f"soak[{args.seed}]: {result.summary()}")  # console-output: the CLI's report
    return 0 if result.ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
