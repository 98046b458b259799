"""Raylet: per-node daemon — worker pool, local scheduler, object plane (the
port of ray_tpu/core/raylet.py, trimmed to one machine).

Re-design of the reference's raylet (reference: src/ray/raylet/
node_manager.h:119 NodeManager; worker_pool.h:174 WorkerPool/PopWorker;
scheduling/cluster_task_manager.cc:44 QueueAndScheduleTask with spillback;
local_task_manager.cc:74 dispatch; dependency_manager.h). One raylet per
node; each owns a shared-memory store segment and a pool of worker processes
that long-poll it for tasks.

Scheduling is two-level like the reference: the raylet first decides
local-vs-remote (consulting the GCS resource view; a remote choice forwards
the task to that raylet, the analogue of lease spillback), then the local
half gates dispatch on resource availability and argument locality (missing
arguments are pulled from their location per the GCS object directory).

Devices. The JAX raylet leases whole TPU chips to placement bundles and
starts their workers with TPU_VISIBLE_CHIPS. The port leases CUDA device ids
to every task, actor and bundle that asks for GPUs, and starts its worker
with CUDA_VISIBLE_DEVICES set to exactly those ids; a worker that asked for
none sees none. A whole request takes whole ids; a fractional request
(num_gpus=0.5) shares one id with other fractional requests up to its
capacity of 1.0, as Ray does. Workers are pooled by their env key: the
runtime env they run in and the ids they see.

Kept: task, actor and lease scheduling; the worker poll/step/done loop;
local objects and `wait_objects`; `ensure_space` (pending frees, then
pulled replicas evicted and primaries spilled to disk in seal order, and
restored on demand; the monitor loop spills above SPILL_THRESHOLD);
bundles; pulls between raylets (`pull_object`, `fetch_object(_chunk)`,
`object_size`, a spilled object served from its file), over TCP when the
cluster spans hosts (the raylet then also serves and advertises a tcp://
endpoint); the broadcast push tree (`start_broadcast`, `push_object`);
`client_put` / `client_get` for remote client drivers; runtime envs (a
worker's env materialised before its spawn, core/runtime_env.py); the warm
pool, whose workers fork from a zygote (core/worker_pool.py,
core/zygote.py), with Popen where the zygote cannot serve or the env sets
variables or an interpreter; `drain` (a preemption notice: default-
placement tasks and worker leases go to surviving nodes while in-flight and
bundle-pinned work runs on); epoch fencing (every GCS mutation carries
the epoch this incarnation registered with; when the GCS answers
StaleNodeEpochError the node dies as a member in `_fence` and registers
again as a fresh incarnation); the `chaos_partition` / `chaos_heal` RPCs
(chaos/net.py).

Logs, dumps and post-mortems (observability/{logs,flight_recorder,
postmortem}.py): the log monitor tails this node's workers' captured
stdout/stderr, publishes new lines on the `logs` pubsub channel in chunks
of at most 200 (the driver re-prints them with `(name pid=... node=...)`
prefixes) and mirrors them into structured capture records attributed to
the worker, its pid and its actor; `tail_logs` filters the session's JSONL
records; `flight_dump` dumps this raylet's ring and SIGUSR2s its workers
older than 5 s (their rings dump too; the GCS's incident harvest calls it).
A worker that dies abnormally leaves `postmortem_<worker>_<us>.json` in the
flight dir: its exit status (a forked worker's from the zygote, minus the
signal's number when killed), the task it ran and the last 50 lines of its
.err and .out, the tail its error and the GCS error table carry. The
raylet forwards its anomaly triggers to the GCS (postmortem.arm_client).
`profile` samples this raylet's threads for N seconds
(utils/sampling_profiler.py) and leaves a JSON dump that the Perfetto
merge reads. The raylet registers with its node's labels, runs the
per-node ReporterAgent (CPU, memory, RSS and fd gauges;
utils/internal_metrics.py) and makes its locks through utils/lock_order.py.
This module never imports torch.
"""

from __future__ import annotations

import collections
import json
import logging
import os
import pickle
import queue
import shutil
import signal
import subprocess
import sys
import threading
import time
import uuid
from typing import Any, Dict, List, Optional, Set, Tuple

from .. import exceptions as exc
from .. import tracing as _tracing
from ..accelerators import get_accelerator_manager
from ..accelerators.gpu import slice_env
from ..chaos.net import ChaosPartitionRpc
from ..observability import postmortem as _postmortem
from ..observability.flight_recorder import record as _flight_record
from ..utils import config
from ..utils import internal_metrics as imet
from ..utils import lock_order
from .heartbeat import HeartbeatCodec
from .ids import ObjectID
from .object_transport import StoredError
from .placement_group import decode_node_affinity
from .rpc import RpcClient, RpcServer
from .shm_store import SharedMemoryStore
from .worker_pool import WorkerPoolManager, ZygoteUnavailableError
from .zygote import PidHandle, ZygoteClient

POLL_TIMEOUT_S = config.WORKER_POLL_TIMEOUT_S
_EPS = 1e-9

_log = logging.getLogger("ray_tpu_torch.raylet")

# What `_gcs_call_fenced` returns when the GCS rejected the call as fenced.
_FENCED = object()


class _Worker:
    def __init__(self, worker_id: str, proc: subprocess.Popen, env_key: str = ""):
        self.worker_id = worker_id
        self.proc = proc
        self.mailbox: "queue.Queue" = queue.Queue()
        self.busy_with: Optional[dict] = None  # task entry being executed
        self.actor_id: Optional[str] = None  # dedicated actor worker
        self.actor_rec: Optional[dict] = None  # the record dict this worker serves
        self.env_key = env_key  # pool key: the device ids the worker sees
        self.last_done: Optional[str] = None  # a retried worker_step is applied once
        self.ready = False  # first poll arrived: the process finished booting
        self.spawned_at = time.monotonic()  # flight_dump signals none younger than 5 s


def _gpu_take(pool: Dict[str, float], amount: float) -> Optional[Dict[str, float]]:
    """Takes `amount` of GPU from `pool` (device id -> free capacity, 1.0 a
    whole device): whole ids for amount >= 1, else a share of one id, packed
    onto the most-used id that still fits. None when it does not fit."""
    if amount <= 0:
        return {}
    if amount >= 1.0 - _EPS:
        whole = [g for g in sorted(pool) if pool[g] >= 1.0 - _EPS]
        n = int(round(amount))
        if len(whole) < n:
            return None
        taken = {g: 1.0 for g in whole[:n]}
    else:
        fits = [g for g in sorted(pool) if pool[g] >= amount - _EPS]
        if not fits:
            return None
        g = min(fits, key=lambda i: pool[i])
        taken = {g: amount}
    for g, v in taken.items():
        pool[g] -= v
    return taken


def _gpu_give(pool: Dict[str, float], taken: Dict[str, float]) -> None:
    for g, v in taken.items():
        if g in pool:
            pool[g] = min(1.0, pool[g] + v)


class RayletService(ChaosPartitionRpc):
    def __init__(
        self,
        node_id: str,
        sock_path: str,
        store_path: str,
        gcs_sock: str,
        resources: Dict[str, float],
        store_capacity: int,
        prestart: int = 0,
        advertise_address: Optional[str] = None,
        labels: Optional[Dict[str, Any]] = None,
    ):
        self.node_id = node_id
        # Key/value tags this node registers with (a provider's cloud id, a
        # slice's name and index): list_nodes' `Labels`.
        self.labels = dict(labels or {})
        self.sock_path = sock_path
        # What other nodes and the GCS dial: on a cluster that spans hosts,
        # a tcp:// endpoint; this node's own workers keep the UDS.
        self.advertised = advertise_address or sock_path
        self.store_path = store_path
        self.store = SharedMemoryStore.create(store_path, store_capacity)
        self.gcs = RpcClient(gcs_sock)
        self.gcs_sock = gcs_sock
        # Anomalies seen here (chaos injections) go to the GCS's trigger bus.
        self._trigger_forward = _postmortem.arm_client(self.gcs)
        self.total = dict(resources)
        self.available = dict(resources)
        # Device accounting goes through the accelerator manager
        # (ray_tpu_torch.accelerators): which CUDA device ids this raylet may
        # lease (an inherited CUDA_VISIBLE_DEVICES restricts them) and the
        # spawn-time env that makes a worker see exactly its lease.
        self._gpu_manager = get_accelerator_manager("GPU")
        n_gpus = int(resources.get("GPU", 0))
        ids = self._gpu_manager.visible_gpu_ids(n_gpus)
        self._gpu_pool: Dict[str, float] = {g: 1.0 for g in ids}
        self._has_gpus = bool(ids)
        if n_gpus and len(ids) < n_gpus:
            # Fewer leasable ids than declared: schedule against the ids.
            self.total["GPU"] = self.available["GPU"] = float(len(ids))
        if ids and "slice_name" not in self.labels:
            # A GPU host's NVLink domain is its slice (SLICE_GANG reads the
            # labels), as a TPU host's slice is in the JAX package; labels
            # the caller gave (a provider's fake slice) win. The session's
            # first raylet on this host reads it; the others read its answer.
            try:
                spec = self._gpu_manager.detect_slice_spec(
                    len(ids), cache_dir=os.path.dirname(sock_path) or ".")
            except Exception:  # noqa: BLE001 - an unreadable topology: no slice
                spec = None
            if spec is not None and spec.slice_name:
                self.labels.setdefault("slice_name", spec.slice_name)
                self.labels.setdefault("worker_index", spec.worker_index)
                if spec.generation:
                    self.labels.setdefault("gpu_generation", spec.generation)
        self._res_lock = lock_order.tracked_lock("raylet.resources")
        # Placement-group bundles hosted here: (pg_id, bundle_index) ->
        # {"reserved", "free", "gpus"}. Reserved resources are debited from
        # `available`, so heartbeats reflect the lease (reference:
        # placement_group_resource_manager.h, the raylet owns bundle state).
        self._bundles: Dict[Tuple[str, int], dict] = {}

        self._workers: Dict[str, _Worker] = {}
        self._idle: Dict[str, List[str]] = {}  # env_key -> idle worker ids
        # Leased workers: the owner pushes tasks to the worker's direct
        # socket; the lease holds its resources until returned (reference:
        # HandleRequestWorkerLease, node_manager.cc:1797).
        self._leases: Dict[str, Dict[str, Any]] = {}
        self._workers_lock = lock_order.tracked_lock("raylet.workers")
        # Ids a batched zygote spawn asked for and not yet registered: a forked
        # child can poll before its registration lands, and must not be told
        # to stop.
        self._spawning: Set[str] = set()
        self._max_task_workers = max(1, int(resources.get("CPU", 1)))
        self._cancelled: "collections.OrderedDict[str, bool]" = collections.OrderedDict()
        # (task_id, attempt) -> return ids: a one-way submit resent after a
        # reconnect must not run twice.
        self._seen_submits: "collections.OrderedDict[Tuple[str, int], List[str]]" = (
            collections.OrderedDict())
        self._seen_lock = lock_order.tracked_lock("raylet.seen_submits")
        self._pending: "queue.Queue" = queue.Queue()
        self._sched_wake = threading.Event()
        self._waiting: List[dict] = []
        self._actors: Dict[str, dict] = {}
        self._actor_lock = lock_order.tracked_lock("raylet.actors")
        self._remote_raylets: Dict[str, RpcClient] = {}
        self._stop = threading.Event()
        self._draining = False
        self._hb_codec = HeartbeatCodec()
        # The membership epoch granted at registration, carried on every
        # GCS mutation. The incarnation number stamps each queued entry and
        # advances when a fence starts, so the old life's queued work is
        # dropped at dispatch (the epoch itself also advances when a GCS
        # that lost this node takes it back, and that queued work is still
        # this life's). _max_fenced_epoch is the highest epoch a fence
        # voided: a batch rejected at a higher one belongs to a live
        # incarnation and is sent again.
        self.epoch = 0
        self._incarnation = 0
        self._fence_guard = threading.Lock()
        self._fencing = False
        self._max_fenced_epoch = 0
        self._seal_cv = threading.Condition()
        self._pulling: Set[str] = set()
        self._pull_sem = threading.BoundedSemaphore(config.MAX_CONCURRENT_PULLS)
        self._serve_sem = threading.BoundedSemaphore(config.MAX_CONCURRENT_SERVES)
        # Batched control-plane updates to the GCS (object locations, task
        # events, actor starts), off the task fast path.
        self._loc_buf: List[str] = []
        self._evt_buf: List[dict] = []
        self._started_buf: List[str] = []
        self._buf_lock = lock_order.tracked_lock("raylet.gcs_sync_buf")
        self._buf_wake = threading.Event()
        self._deferred_deletes: Set[str] = set()
        # Local objects in seal order (True = primary, False = a pulled
        # replica that eviction may drop), and the files of spilled
        # primaries; _objects_lock guards both (reference: plasma
        # eviction_policy.h:160 LRU, raylet/local_object_manager.h:41).
        self._local_objects: "collections.OrderedDict[str, bool]" = collections.OrderedDict()
        self._spilled: Dict[str, str] = {}
        self._objects_lock = threading.Lock()
        # Serialises whole evict/spill/restore sequences: concurrent
        # ensure_space calls must not unlink each other's fresh files.
        self._evict_lock = lock_order.tracked_lock("raylet.evict")
        # Spills land next to the raylet socket, in the session dir on
        # disk: spilling into tmpfs would not relieve the pool's memory.
        self._spill_dir = os.path.join(os.path.dirname(sock_path) or ".", f"spill_{node_id}")
        os.makedirs(self._spill_dir, exist_ok=True)
        self._last_reclaim = 0.0
        self._log_dir = os.path.join(os.path.dirname(sock_path) or ".", "logs")
        os.makedirs(self._log_dir, exist_ok=True)
        # The pids of the workers this raylet spawned, by worker id: the log
        # monitor tails only their files (nodes on one host share the
        # session's log dir), and a dead worker's last lines keep its pid.
        self._spawned_pids: Dict[str, int] = {}
        self._last_log_gc = 0.0
        # The warm pool and its zygote (core/worker_pool.py): spawns fork
        # from a daemon that already imported the worker stack and torch;
        # until it is up, or when it is down, they Popen.
        self._pool = WorkerPoolManager(self, prestart=prestart)
        reg = self.gcs.call("register_node", node_id, self.advertised, store_path, self.total,
                            self.labels)
        self._cluster_size = reg.get("nodes", 1)
        self.epoch = reg.get("epoch", 0)
        # This raylet's `raytpu_*` records flush through its GCS client.
        imet.configure(node_id=node_id, reporter=f"raylet_{node_id}",
                       sink=lambda recs: self.gcs.call("report_internal_metrics",
                                                       f"raylet_{node_id}", recs, timeout=10.0))
        # The node's CPU, memory, RSS and fd gauges (the raylet never imports
        # torch, so it reports no device gauge).
        self._reporter = imet.ReporterAgent()
        self._reporter.start()
        self._threads = [
            threading.Thread(target=self._scheduler_loop, daemon=True, name="sched"),
            threading.Thread(target=self._heartbeat_loop, daemon=True, name="hb"),
            threading.Thread(target=self._monitor_loop, daemon=True, name="monitor"),
            threading.Thread(target=self._flush_loop, daemon=True, name="flush"),
        ]
        if os.environ.get("RAY_TPU_LOG_MONITOR", "1") != "0":
            self._threads.append(threading.Thread(target=self._log_monitor_loop, daemon=True,
                                                  name="logmon"))
        for t in self._threads:
            t.start()
        self._pool.start()

    # ----------------------------------------------- control-plane batching
    def _notify_sealed(self, oid_hexes: List[str], primary: bool = True) -> None:
        """A local seal: wake waiters now, tell the GCS directory soon."""
        if oid_hexes:
            with self._objects_lock:
                for h in oid_hexes:
                    self._local_objects[h] = primary
                    self._local_objects.move_to_end(h)
        with self._seal_cv:
            self._seal_cv.notify_all()
        with self._buf_lock:
            self._loc_buf.extend(oid_hexes)
        self._buf_wake.set()
        self._sched_wake.set()  # a sealed object may unblock queued tasks

    def _task_event(self, task_id: str, state: str, **extra) -> None:
        evt = {"task_id": task_id, "state": state, "ts": time.time()}
        evt.update((k, v) for k, v in extra.items() if v is not None)
        with self._buf_lock:
            self._evt_buf.append(evt)
        self._buf_wake.set()

    def _enqueue(self, entry: dict) -> None:
        entry["_q_ts"] = time.monotonic()  # queue-to-dispatch latency
        entry["_node_incarnation"] = self._incarnation
        self._pending.put(entry)
        self._sched_wake.set()

    def _flush_loop(self) -> None:
        """Drains location, task-event and actor-start buffers to the GCS."""
        while not self._stop.is_set():
            self._buf_wake.wait(timeout=0.2)
            self._buf_wake.clear()
            # The epoch is read before the buffers: these entries belong to
            # the incarnation that buffered them, and a fence completing in
            # between must not slip them past the GCS's fence under the new
            # epoch.
            ep = self.epoch
            with self._buf_lock:
                locs, self._loc_buf = self._loc_buf, []
                evts, self._evt_buf = self._evt_buf, []
                started, self._started_buf = self._started_buf, []
            if started:
                try:
                    verdicts = self.gcs.call("actor_started_batch", self.node_id, started, ep)
                except exc.StaleNodeEpochError:
                    # Fenced mid-launch: the GCS moved these actors; the
                    # instances die with the fence.
                    self._fence("actor_started", ep)
                except Exception:  # noqa: BLE001 - GCS briefly unreachable: retry
                    with self._buf_lock:
                        self._started_buf = started + self._started_buf
                else:
                    for aid, ok in (verdicts or {}).items():
                        if ok is False:
                            self._kill_duplicate_instance(aid)
            if not locs and not evts:
                continue
            try:
                self.gcs.call("node_sync", self.node_id, locs, evts, ep)
                imet.GCS_SYNC_TOTAL.inc()
                imet.GCS_SYNC_BATCH.observe(len(locs) + len(evts))
            except exc.StaleNodeEpochError:
                # This incarnation is fenced: its seals and events are void
                # (sent again after the rejoin they would advertise dangling
                # locations). A rejection above every fenced epoch came from
                # a GCS that lost this node and took it back under a new
                # number: the same live incarnation, whose batch goes again.
                self._fence("node_sync", ep)
                if ep > self._max_fenced_epoch:
                    with self._buf_lock:
                        self._loc_buf = locs + self._loc_buf
                        self._evt_buf = evts + self._evt_buf
            except Exception:  # noqa: BLE001 - GCS briefly unreachable: retry later
                with self._buf_lock:
                    self._loc_buf = locs + self._loc_buf
                    self._evt_buf = evts + self._evt_buf
                self._stop.wait(0.5)

    def _kill_duplicate_instance(self, aid: str) -> None:
        """The GCS record for `aid` points elsewhere: kill the local instance
        without an actor_died report (the record is not ours)."""
        with self._actor_lock:
            a = self._actors.get(aid)
            wid = a.get("worker_id") if a else None
            if a:
                a["state"] = "DEAD"
        if wid:
            with self._workers_lock:
                w = self._workers.get(wid)
            if w:
                w.proc.kill()

    # ------------------------------------------------------------ helpers
    def _remote(self, sock: str) -> RpcClient:
        cli = self._remote_raylets.get(sock)
        if cli is None:
            cli = self._remote_raylets[sock] = RpcClient(sock, connect_timeout=5.0)
        return cli

    def _fits(self, pool: Dict[str, float], resources: Dict[str, float]) -> bool:
        return all(pool.get(k, 0.0) >= v - _EPS for k, v in resources.items())

    def _try_acquire(self, resources: Dict[str, float]) -> Optional[Dict[str, float]]:
        """Debits `resources` from the node's free pool; returns the GPU ids
        taken ({} without GPUs), or None when it does not fit now."""
        with self._res_lock:
            if not self._fits(self.available, resources):
                return None
            gpus = _gpu_take(self._gpu_pool, resources.get("GPU", 0.0)) if self._has_gpus else {}
            if gpus is None:
                return None
            for k, v in resources.items():
                self.available[k] = self.available.get(k, 0.0) - v
            return gpus

    def _release(self, resources: Dict[str, float],
                 gpus: Optional[Dict[str, float]] = None) -> None:
        with self._res_lock:
            for k, v in resources.items():
                self.available[k] = min(self.total.get(k, 0.0), self.available.get(k, 0.0) + v)
            if gpus:
                _gpu_give(self._gpu_pool, gpus)

    def _fits_total(self, resources: Dict[str, float]) -> bool:
        return self._fits(self.total, resources)

    def _can_run_soon(self, resources) -> bool:
        with self._res_lock:
            return self._fits(self.available, resources)

    # ------------------------------------------------- placement bundles
    def reserve_bundle(self, pg_id: str, bundle_index: int, resources: Dict[str, float]) -> bool:
        """Leases a placement-group bundle out of this node's free pool,
        with the GPU ids (or the share of one id) that its workers will see."""
        key = (pg_id, bundle_index)
        with self._res_lock:
            if key in self._bundles:
                return True  # idempotent retry
            short = not self._fits(self.available, resources)
        if short:
            self._maybe_reclaim_leases(resources)
        with self._res_lock:
            if key in self._bundles:
                return True
            if not self._fits(self.available, resources):
                return False
            gpus = _gpu_take(self._gpu_pool, resources.get("GPU", 0.0)) if self._has_gpus else {}
            if gpus is None:
                return False
            for k, v in resources.items():
                self.available[k] = self.available.get(k, 0.0) - v
            self._bundles[key] = {"reserved": dict(resources), "free": dict(resources),
                                  "gpus": dict(gpus), "gpu_free": dict(gpus)}
        return True

    def release_bundle(self, pg_id: str, bundle_index: int) -> bool:
        with self._res_lock:
            b = self._bundles.pop((pg_id, bundle_index), None)
            if b is None:
                return False
            for k, v in b["reserved"].items():
                self.available[k] = min(self.total.get(k, 0.0), self.available.get(k, 0.0) + v)
            _gpu_give(self._gpu_pool, b["gpus"])
        self._sched_wake.set()
        return True

    def _entry_bundle_key(self, entry: dict) -> Optional[Tuple[str, int]]:
        pg_id = entry.get("pg_id")
        return (pg_id, entry.get("bundle_index", 0)) if pg_id else None

    def _fail_if_unschedulable(self, entry: dict) -> bool:
        """Bundle-pinned work whose bundle is gone, or that asks for more than
        the bundle reserves, can never dispatch: fail it now."""
        key = self._entry_bundle_key(entry)
        if key is None:
            return False
        with self._res_lock:
            b = self._bundles.get(key)
            reserved = dict(b["reserved"]) if b else None
        if reserved is None:
            self._store_error_for(entry, RuntimeError(
                f"placement group {key[0][:8]} bundle {key[1]} is not reserved on this "
                "node (placement group removed?)"))
            return True
        if not self._fits(reserved, entry["resources"]):
            self._store_error_for(entry, RuntimeError(
                f"task requires {entry['resources']} but bundle {key[1]} of placement "
                f"group {key[0][:8]} only reserves {reserved}"))
            return True
        return False

    def _try_acquire_entry(self, entry: dict) -> bool:
        """Acquires the entry's resources (from its bundle's reservation when
        it has one) and records the GPU ids it got in entry["_gpus"]."""
        key = self._entry_bundle_key(entry)
        if key is None:
            gpus = self._try_acquire(entry["resources"])
        else:
            with self._res_lock:
                b = self._bundles.get(key)
                if b is None or not self._fits(b["free"], entry["resources"]):
                    return False
                gpus = _gpu_take(b["gpu_free"], entry["resources"].get("GPU", 0.0))
                if gpus is None:
                    return False
                for k, v in entry["resources"].items():
                    b["free"][k] = b["free"].get(k, 0.0) - v
        if gpus is None:
            return False
        entry["_gpus"] = gpus
        return True

    def _release_entry(self, entry: dict) -> None:
        gpus = entry.pop("_gpus", None)
        key = self._entry_bundle_key(entry)
        if key is None:
            self._release(entry["resources"], gpus)
            return
        with self._res_lock:
            b = self._bundles.get(key)
            if b is None:
                return  # the bundle was released while the task ran
            for k, v in entry["resources"].items():
                b["free"][k] = min(b["reserved"].get(k, 0.0), b["free"].get(k, 0.0) + v)
            if gpus:
                _gpu_give(b["gpu_free"], gpus)

    # ----------------------------------------------------------- ingress
    def submit_task(self, spec_blob: bytes, forwarded: bool = False) -> List[str]:
        """Queues a normal task; returns its return ids. May forward it to
        another node (spillback, reference: cluster_task_manager.cc:136)."""
        entry = pickle.loads(spec_blob)
        dup = self._dedupe_submit(entry)
        if dup is not None:
            return dup
        return self._ingest_entry(entry, spec_blob, forwarded)

    def submit_task_batch(self, batch_blob: bytes) -> int:
        """Batched one-way submission (reference: the submission-queue
        batching in NormalTaskSubmitter)."""
        entries = pickle.loads(batch_blob)
        for entry in entries:
            if self._dedupe_submit(entry) is None:
                self._ingest_entry(entry, None, False)
        return len(entries)

    def _dedupe_submit(self, entry: dict) -> Optional[List[str]]:
        key = (entry["task_id"], entry.get("attempt", 0))
        with self._seen_lock:
            if key in self._seen_submits:
                self._seen_submits.move_to_end(key)
                return self._seen_submits[key]
            self._seen_submits[key] = entry["return_ids"]
            while len(self._seen_submits) > 65536:
                self._seen_submits.popitem(last=False)
        return None

    def _queue_here(self, entry: dict) -> List[str]:
        entry["type"] = "task"
        self._task_event(entry["task_id"], "QUEUED", name=entry.get("desc", ""))
        self._enqueue(entry)
        return entry["return_ids"]

    def _ingest_entry(self, entry: dict, spec_blob: Optional[bytes], forwarded: bool) -> List[str]:
        resources = entry["resources"]

        def blob() -> bytes:
            return spec_blob if spec_blob is not None else pickle.dumps(entry)

        def background(target, *args) -> List[str]:
            # Placement that needs the GCS runs off the handler thread: a
            # one-way submit must not stall the connection behind it.
            threading.Thread(target=target, args=args, daemon=True).start()
            return entry["return_ids"]

        if entry.get("pg_id") or forwarded:
            return self._queue_here(entry)
        strategy = entry.get("strategy") or "DEFAULT"
        affinity = decode_node_affinity(strategy)
        if affinity is not None:
            target_id, soft = affinity
            if target_id != self.node_id:
                return background(self._place_affinity, entry, blob(), target_id, soft)
            if self._fits_total(resources):
                return self._queue_here(entry)
            if not soft:
                self._store_error_for(entry, RuntimeError(
                    f"hard NodeAffinity to {target_id[:12]}: node cannot ever satisfy "
                    f"{resources}"))
                return entry["return_ids"]
        elif self._draining:
            # Draining (a preemption notice): fresh default-placement work
            # goes to a node that outlives the grace window; a node-pinned
            # task keeps its pin.
            return background(self._place_elsewhere, entry, blob())
        elif strategy == "SPREAD":
            return background(self._place_spread, entry, blob())
        if not self._fits_total(resources):
            return background(self._place_elsewhere, entry, blob())
        if self._cluster_size > 1 and not self._can_run_soon(resources):
            try:
                target = self.gcs.call("pick_node", resources, [self.node_id])
                if target is not None:
                    return self._remote(target["sock"]).call("submit_task", blob(), True)
            except Exception as e:  # noqa: BLE001 - queue locally instead
                _log.debug("spillback failed, queuing locally: %r", e)
        return self._queue_here(entry)

    def _place_affinity(self, entry: dict, spec_blob: bytes, target_id: str, soft: bool) -> None:
        """Forwards a NodeAffinity task to its target node (background)."""
        info = None
        looked_up = False
        for _ in range(3):
            try:
                info = self.gcs.call("node_info", target_id)
                looked_up = True
                break
            except Exception:  # noqa: BLE001 - retried
                time.sleep(0.3)
        if info is not None and info.get("alive"):
            if self._fits(info.get("resources") or {}, entry["resources"]):
                try:
                    self._remote(info["sock"]).call("submit_task", spec_blob, True)
                    return
                except Exception:
                    pass  # lint: swallow-ok(target died mid-forward; retried until deadline)
            elif not soft:
                self._store_error_for(entry, RuntimeError(
                    f"hard NodeAffinity to {target_id[:12]}: node cannot ever satisfy "
                    f"{entry['resources']}"))
                return
        if not soft:
            self._store_error_for(entry, RuntimeError(
                f"hard NodeAffinity to {target_id[:12]} cannot be satisfied: "
                + ("node is gone" if looked_up else "GCS unreachable")))
            return
        entry = dict(entry, strategy="DEFAULT")
        self._ingest_entry(entry, None, False)

    def _place_spread(self, entry: dict, spec_blob: bytes) -> None:
        try:
            target = self.gcs.call("pick_node", entry["resources"], [], "spread")
            if target is not None and target["node_id"] != self.node_id:
                self._remote(target["sock"]).call("submit_task", spec_blob, True)
                return
        except Exception as e:  # noqa: BLE001 - queue locally instead
            _log.debug("spread placement failed, queuing locally: %r", e)
        self._queue_here(entry)

    def _place_elsewhere(self, entry: dict, spec_blob: bytes) -> None:
        """Finds a node for a task this node can never run; retries while the
        GCS view catches up, then fails the task visibly."""
        deadline = time.monotonic() + config.PLACEMENT_RETRY_TIMEOUT_S
        while time.monotonic() < deadline:
            try:
                target = self.gcs.call("pick_node", entry["resources"], [self.node_id])
            except Exception:  # noqa: BLE001 - retried
                target = None
            if target is not None:
                try:
                    self._remote(target["sock"]).call("submit_task", spec_blob, True)
                    return
                except Exception:
                    pass  # lint: swallow-ok(target died mid-forward; retried until deadline)
            time.sleep(0.1)
        self._store_error_for(entry, exc.SchedulingError(
            f"no node can satisfy {entry['resources']}"))

    def _mark_cancelled(self, task_id: str) -> None:
        self._cancelled[task_id] = True
        while len(self._cancelled) > 10_000:
            self._cancelled.popitem(last=False)

    def is_cancelled(self, task_id: str) -> bool:
        return task_id in self._cancelled

    def cancel_task(self, task_id: str, force: bool = False) -> bool:
        """Cancels a queued or running normal task (reference: core_worker
        CancelTask; queued removal, SIGINT or kill of the executor)."""
        with self._workers_lock:
            running = next((w for w in self._workers.values() if w.busy_with is not None
                            and w.busy_with.get("task_id") == task_id), None)
        self._mark_cancelled(task_id)
        if running is None:
            self._sched_wake.set()
            return True
        if force:
            entry = running.busy_with
            running.proc.kill()
            self._store_error_for(entry, exc.TaskCancelledError(
                f"{entry.get('desc', 'task')} was cancelled"))
        else:
            try:
                running.proc.send_signal(signal.SIGINT)
            except OSError:
                pass
        return True

    # ------------------------------------------------------------- actors
    def create_actor(self, spec_blob: bytes, bundle_index: Optional[int] = None) -> bool:
        """Hosts an actor (the GCS already picked this node)."""
        self._pool.note_demand()
        entry = pickle.loads(spec_blob)
        entry["type"] = "actor_creation"
        if bundle_index is not None and bundle_index >= 0:
            entry["bundle_index"] = bundle_index
        with self._actor_lock:
            existing = self._actors.get(entry["actor_id"])
            if existing is not None and existing["state"] != "DEAD":
                return True  # duplicate delivery
            self._actors[entry["actor_id"]] = {
                "worker_id": None,
                "state": "PENDING",
                "inflight": [],
                "creation_entry": entry,
                "resources_held": False,
            }
        self._task_event(entry["task_id"], "QUEUED", name=entry.get("desc", ""))
        self._enqueue(entry)
        return True

    def create_actor_batch(self, items: List[Tuple[bytes, Optional[int]]]) -> int:
        for blob, bundle_index in items:
            self.create_actor(blob, bundle_index)
        return len(items)

    def submit_actor_task(self, spec_blob: bytes) -> List[str]:
        entry = pickle.loads(spec_blob)
        entry["type"] = "actor_task"
        aid = entry["actor_id"]
        with self._actor_lock:
            a = self._actors.get(aid)
            dead = a is None or a["state"] == "DEAD"
        if dead:
            self._store_error_for(entry, exc.ActorDiedError(aid, "not on this node or dead"))
            return entry["return_ids"]
        self._task_event(entry["task_id"], "QUEUED", name=entry.get("desc", ""))
        self._enqueue(entry)
        return entry["return_ids"]

    def kill_actor(self, actor_id: str, no_restart: bool = True) -> bool:
        with self._actor_lock:
            a = self._actors.get(actor_id)
            wid = a.get("worker_id") if a else None
            if a:
                a["state"] = "DEAD"
        # The worker dies before the GCS hears of it: with a restart allowed
        # the GCS may re-create the actor here at once.
        if wid:
            with self._workers_lock:
                w = self._workers.get(wid)
            if w:
                w.proc.kill()
        try:
            self._gcs_call_fenced("actor_died", actor_id, "killed via kill()", no_restart,
                                  self.node_id)
        except Exception as e:  # noqa: BLE001 - the GCS heals on the next report
            _log.warning("actor_died report for %s failed: %r", actor_id[:8], e)
        return True

    def actor_direct_sock(self, actor_id: str) -> Optional[str]:
        """The direct-push socket of the worker hosting this actor (None
        until the actor is ALIVE here)."""
        with self._actor_lock:
            a = self._actors.get(actor_id)
            if not a or a.get("state") != "ALIVE" or not a.get("worker_id"):
                return None
            wid = a["worker_id"]
        return self._direct_sock(wid)

    # ------------------------------------------------------- object plane
    def pull_object(self, oid_hex: str, timeout: float = 30.0) -> bool:
        """Ensures the object is in the local store, fetching it from another
        node if needed; a spilled object comes back from its file
        (reference: pull_manager.h:52)."""
        oid = ObjectID.from_hex(oid_hex)
        if self.store.contains(oid) or self._restore(oid_hex):
            return True
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self._restore(oid_hex):
                # A transiently full pool can fail the first restore; the
                # file stays the local copy.
                return True
            for loc in self.gcs.call("get_object_locations", oid_hex):
                if loc["node_id"] == self.node_id:
                    continue
                try:
                    if self._pull_from(loc["sock"], oid):
                        self._notify_sealed([oid_hex], primary=False)
                        return True
                except exc.ObjectStoreFullError:
                    break  # pins may drop; retry within the deadline
                except Exception:  # lint: swallow-ok(one dead location; try the next replica)
                    continue
            if self.store.contains(oid):
                return True
            time.sleep(0.01)
        return False

    def _pull_async(self, oid_hex: str) -> None:
        """One in-flight pull per object, shared by all waiters."""
        with self._seal_cv:
            if oid_hex in self._pulling:
                return
            self._pulling.add(oid_hex)

        def run():
            try:
                self.pull_object(oid_hex, timeout=config.OBJECT_WAIT_POLL_S)
            finally:
                with self._seal_cv:
                    self._pulling.discard(oid_hex)
                    self._seal_cv.notify_all()

        threading.Thread(target=run, daemon=True).start()

    # -------------------------------------------------- remote-client proxy
    def client_put(self, oid_hex: str, blob: bytes) -> bool:
        """Stores a framed object for a remote client driver, which has no
        pool of its own (reference: ray client's server-side proxy,
        util/client/server/); this node holds the primary copy."""
        oid = ObjectID.from_hex(oid_hex)
        try:
            self.store.put_raw(oid, blob)
        except exc.ObjectStoreFullError:
            self.ensure_space(len(blob))
            self.store.put_raw(oid, blob)
        self._notify_sealed([oid_hex])
        return True

    def client_get(self, oid_hex: str, timeout: float = 30.0) -> Optional[bytes]:
        """The framed object for a remote client driver, pulled here first
        when another node holds it; None when it has not appeared within
        `timeout` (the client then checks for a lost task and asks again)."""
        oid = ObjectID.from_hex(oid_hex)
        deadline = time.monotonic() + timeout
        while True:
            if self.store.contains(oid) or self._restore(oid_hex):
                raw = self.store.get_raw(oid)
                if raw is not None:
                    return raw
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return None
            self.wait_objects([oid_hex], 1, min(remaining, 5.0), pull=True)

    def wait_objects(self, oid_hexes: List[str], num_returns: Optional[int] = None,
                     timeout: float = 10.0, pull: bool = False) -> List[str]:
        """Long-poll until >= num_returns of the objects are available.
        pull=True (the get path) counts only objects in the local pool,
        restoring spilled ones and fetching remote ones in; pull=False (the
        wait path) counts an object that exists anywhere in the cluster, a
        spilled one included. Wakes on local seals."""
        if num_returns is None:
            num_returns = len(oid_hexes)
        deadline = time.monotonic() + max(0.0, timeout)
        exists_remote: Set[str] = set()
        last_loc_check = 0.0
        while True:
            ready = [h for h in oid_hexes
                     if h in exists_remote or self.store.contains(ObjectID.from_hex(h))
                     or (not pull and h in self._spilled)]
            now = time.monotonic()
            if len(ready) >= num_returns or now >= deadline:
                return ready
            missing = [h for h in oid_hexes if h not in ready]
            if pull:
                for h in missing:
                    if h in self._spilled:
                        self._restore(h)
            if missing and now - last_loc_check >= 0.05:
                last_loc_check = now
                try:
                    locs = self.gcs.call("get_object_locations_batch", missing)
                except Exception:  # noqa: BLE001 - checked again next round
                    locs = {}
                for h, ls in locs.items():
                    if any(loc["node_id"] != self.node_id for loc in ls):
                        if pull:
                            self._pull_async(h)
                        else:
                            exists_remote.add(h)
            with self._seal_cv:
                self._seal_cv.wait(timeout=min(0.05, max(0.001, deadline - now)))

    def _pull_from(self, sock: str, oid: ObjectID) -> bool:
        """Fetches one object from another raylet: small objects in one RPC,
        large ones in transfer_chunk_bytes pieces written straight into the
        preallocated pool region (reference: push_manager.h:30,
        object_buffer_pool.h). Bounded by the pull semaphore."""
        with self._pull_sem:
            remote = self._remote(sock)
            oid_hex = oid.hex()
            chunk = config.TRANSFER_CHUNK_BYTES
            size = remote.call("object_size", oid_hex)
            if size is None:
                return False
            if size <= chunk:
                raw = remote.call("fetch_object", oid_hex)
                if raw is None:
                    return False
                try:
                    self.store.put_raw(oid, raw)
                except exc.ObjectStoreFullError:
                    self.ensure_space(len(raw))
                    self.store.put_raw(oid, raw)
                imet.OBJECT_BYTES_IN.inc(len(raw))
                return True
            try:
                pool_off = self.store.begin_put_raw(oid, size)
            except exc.ObjectStoreFullError:
                self.ensure_space(size)
                pool_off = self.store.begin_put_raw(oid, size)
            if pool_off is None:
                return True  # a concurrent pull won
            sealed = False
            try:
                pos = 0
                while pos < size:
                    piece = remote.call("fetch_object_chunk", oid_hex, pos, chunk)
                    if not piece:  # the source evicted or died mid-transfer
                        return False
                    self.store.write_raw_at(pool_off, pos, piece)
                    pos += len(piece)
                self.store.finish_put_raw(oid)
                sealed = True
                imet.OBJECT_BYTES_IN.inc(size)
                return True
            finally:
                if not sealed:
                    self.store.delete(oid)  # never seal a truncated payload

    # ---------------------------------------------------- tree broadcast
    def push_object(self, oid_hex: str, src_sock: str, targets: List[str]) -> bool:
        """Receives a broadcast relay: fetches the object from `src_sock`,
        then fans the remaining targets out as two subtrees rooted at their
        first nodes, so N nodes get it in O(log N) rounds with every node
        uploading at most twice (reference: push_manager.h:30)."""
        threading.Thread(target=self._do_push, args=(oid_hex, src_sock, list(targets)),
                         daemon=True).start()
        return True

    def _do_push(self, oid_hex: str, src_sock: str, targets: List[str]) -> None:
        oid = ObjectID.from_hex(oid_hex)
        try:
            if not self.store.contains(oid):
                if not self._pull_from(src_sock, oid) and not self.store.contains(oid):
                    # The source lost the object mid-broadcast: the
                    # directory's pull path serves this subtree.
                    if not self.pull_object(oid_hex, timeout=30.0):
                        return
                self._notify_sealed([oid_hex], primary=False)
        except Exception as e:  # noqa: BLE001 - the subtree heals through pulls
            _log.debug("broadcast relay of %s failed: %r", oid_hex[:12], e)
            return
        self._relay_push(oid_hex, targets)

    def _relay_push(self, oid_hex: str, targets: List[str]) -> None:
        """Splits the targets into two subtrees and notifies their roots."""
        targets = [t for t in targets if t not in (self.advertised, self.sock_path)]
        if not targets:
            return
        mid = (len(targets) + 1) // 2
        for half in (targets[:mid], targets[mid:]):
            if not half:
                continue
            try:
                self._remote(half[0]).notify("push_object", oid_hex, self.advertised, half[1:])
            except Exception as e:  # noqa: BLE001 - the subtree heals through pulls
                _log.debug("broadcast notify of %s failed: %r", half[0], e)

    def start_broadcast(self, oid_hex: str) -> int:
        """Pushes a local object to every other alive node through the tree;
        returns the number of targets (their advertised addresses)."""
        try:
            nodes = self.gcs.call("list_nodes")
        except Exception:  # noqa: BLE001 - nothing to push to
            return 0
        targets = [n["sock"] for n in nodes if n.get("Alive") and n["NodeID"] != self.node_id]
        self._relay_push(oid_hex, targets)
        return len(targets)

    def _spill_path(self, oid_hex: str) -> Optional[str]:
        with self._objects_lock:
            return self._spilled.get(oid_hex)

    def _read_spilled(self, oid_hex: str, offset: int = 0, length: int = -1) -> Optional[bytes]:
        """Bytes of a spilled object's file (None when it has none)."""
        path = self._spill_path(oid_hex)
        if path is None:
            return None
        try:
            with open(path, "rb") as f:
                f.seek(offset)
                return f.read(length)
        except OSError:
            return None

    def object_size(self, oid_hex: str) -> Optional[int]:
        size = self.store.raw_size(ObjectID.from_hex(oid_hex))
        if size is not None:
            return size
        path = self._spill_path(oid_hex)
        try:
            return os.path.getsize(path) if path is not None else None
        except OSError:
            return None

    def fetch_object_chunk(self, oid_hex: str, offset: int, length: int) -> Optional[bytes]:
        """Serves one chunk of the framed payload to a pulling raylet, a
        spilled object's from its file without restoring it."""
        with self._serve_sem:
            piece = self.store.read_raw_chunk(ObjectID.from_hex(oid_hex), offset, length)
        if piece is None:
            piece = self._read_spilled(oid_hex, offset, length)
        if piece is not None:
            imet.OBJECT_BYTES_OUT.inc(len(piece))
        return piece

    def fetch_object(self, oid_hex: str) -> Optional[bytes]:
        raw = self.store.get_raw(ObjectID.from_hex(oid_hex))
        if raw is None:
            raw = self._read_spilled(oid_hex)
        if raw is not None:
            imet.OBJECT_BYTES_OUT.inc(len(raw))
        return raw

    # ---------------------------------------------------- eviction / spill
    def _spill_to(self, target_bytes: int, fit: int = 0) -> bool:
        with self._evict_lock:
            return self._spill_to_locked(target_bytes, fit)

    def _spill_to_locked(self, target_bytes: int, fit: int = 0) -> bool:
        """Evicts pulled replicas and spills primaries, in seal order (the
        oldest first), until the pool holds at most `target_bytes` and, for
        `fit` > 0, one free block takes `fit` bytes: the first-fit pool can
        be below its byte target with every hole too small, and a restore
        or put that waits on bytes alone never fits. One snapshot, one
        forward scan. True when both are met."""
        def met() -> bool:
            return (self.store.bytes_in_use() <= target_bytes
                    and (fit <= 0 or self.store.fits(fit)))

        if met():
            return True
        with self._objects_lock:
            candidates = list(self._local_objects.items())
        for h, primary in candidates:
            if met():
                return True
            self._try_evict_one_locked(h, primary)
        return met()

    def _try_evict_one_locked(self, h: str, primary: bool) -> bool:
        oid = ObjectID.from_hex(h)
        if not self.store.contains(oid):
            with self._objects_lock:
                self._local_objects.pop(h, None)
            return False
        if not primary:
            # A pulled replica: another node holds the primary, so a plain
            # delete is safe once the directory forgets this copy.
            if not self.store.delete(oid):
                return False  # pinned by a reader
            with self._objects_lock:
                self._local_objects.pop(h, None)
            try:
                self._gcs_call_fenced("remove_object_location", h, self.node_id)
            except Exception:  # lint: swallow-ok(directory heals via node_sync batches)
                pass
            return True
        raw = self.store.get_raw(oid)
        if raw is None:
            with self._objects_lock:
                self._local_objects.pop(h, None)
            return False
        path = os.path.join(self._spill_dir, h)
        try:
            with open(path + ".tmp", "wb") as f:
                f.write(raw)
            os.replace(path + ".tmp", path)
        except OSError:
            return False  # disk full or unwritable
        if self.store.delete(oid):
            with self._objects_lock:
                self._spilled[h] = path
                self._local_objects.pop(h, None)
            imet.OBJECT_SPILL_TOTAL.inc()
            imet.OBJECT_SPILL_BYTES.inc(len(raw))
            return True
        try:
            os.unlink(path)  # pinned after all: the pool copy stays
        except OSError:
            pass
        return False

    def ensure_space(self, nbytes: int) -> bool:
        """Makes room for an allocation of `nbytes`: the owners' pending frees
        first, then replicas evicted and primaries spilled to disk."""
        target = max(0, int(self.store.capacity() * 0.95) - int(nbytes))
        try:
            self.gcs.call("flush_frees")
        except Exception:
            pass  # lint: swallow-ok(advisory pre-pressure; eviction below is the guarantee)
        if self.store.bytes_in_use() <= target and self.store.fits(nbytes):
            return True
        return self._spill_to(target, fit=int(nbytes))

    def _restore(self, oid_hex: str) -> bool:
        """Brings a spilled object back into the pool, under the evict lock
        so a concurrent spill cannot unlink the file mid-read."""
        with self._evict_lock:
            raw = self._read_spilled(oid_hex)
            if raw is None:
                return False
            oid = ObjectID.from_hex(oid_hex)
            try:
                self.store.put_raw(oid, raw)
            except exc.ObjectStoreFullError:
                self._spill_to_locked(max(0, int(self.store.capacity() * 0.95) - len(raw)),
                                      fit=len(raw))
                try:
                    self.store.put_raw(oid, raw)
                except exc.ObjectStoreFullError:
                    return False
            with self._objects_lock:
                path = self._spilled.pop(oid_hex)  # held: no delete can race
            try:
                os.unlink(path)
            except OSError:
                pass
        imet.OBJECT_RESTORE_TOTAL.inc()
        self._notify_sealed([oid_hex])
        return True

    def _object_stats(self) -> dict:
        """This node's object-plane counters (the catalog's values live in
        the process that bumps them) and what its pool and spill dir hold:
        debug_state's "objects"."""
        def total(metric) -> float:
            return sum(metric.values().values())

        with self._objects_lock:
            n_spilled = len(self._spilled)
        try:
            spill_files = len(os.listdir(self._spill_dir))
        except OSError:
            spill_files = 0
        return {"bytes_in_use": self.store.bytes_in_use(),
                "num_objects": self.store.num_objects(), "num_spilled": n_spilled,
                "spill_files": spill_files, "spill_total": total(imet.OBJECT_SPILL_TOTAL),
                "spill_bytes": total(imet.OBJECT_SPILL_BYTES),
                "restore_total": total(imet.OBJECT_RESTORE_TOTAL),
                "bytes_in": total(imet.OBJECT_BYTES_IN),
                "bytes_out": total(imet.OBJECT_BYTES_OUT)}

    def notify_object(self, oid_hex: str) -> bool:
        self._notify_sealed([oid_hex])
        return True

    def delete_objects(self, oid_hexes: List[str]) -> int:
        """Frees objects from the local pool (the owner dropped its last
        reference). Objects pinned by a zero-copy reader are retried by the
        monitor loop."""
        freed = 0
        for h in oid_hexes:
            oid = ObjectID.from_hex(h)
            # The evict lock: an in-flight spill of h records its file
            # before this decides what to remove.
            with self._evict_lock, self._objects_lock:
                self._local_objects.pop(h, None)
                spill_path = self._spilled.pop(h, None)
            if spill_path is not None:
                try:
                    os.unlink(spill_path)
                except OSError:
                    pass
            if self.store.delete(oid):
                freed += 1
            elif self.store.contains(oid):
                with self._buf_lock:
                    self._deferred_deletes.add(h)
        return freed

    # --------------------------------------------------- leased fast path
    def _direct_sock(self, worker_id: str) -> str:
        """The worker's direct-push UDS (made by the worker at boot)."""
        return os.path.join(os.path.dirname(self.sock_path) or ".", f"wkr_{worker_id}.sock")

    def request_worker_lease(self, resources: Dict[str, float], env_key: str = "") -> dict:
        """Grants a worker lease for direct owner->worker task pushes: the
        resources are held for the lease's lifetime and the raylet steps out
        of the per-task loop (reference: normal_task_submitter.cc:354
        RequestWorkerLease and the cached lease at :555)."""
        resources = dict(resources or {"CPU": 1.0})

        def spill_or_retry() -> dict:
            try:
                target = self.gcs.call("pick_node", resources, [self.node_id])
            except Exception:  # noqa: BLE001 - the owner retries
                target = None
            if target is not None and target["node_id"] != self.node_id:
                return {"spill": target["sock"]}
            return {"retry": True}

        if self._draining or not self._fits_total(resources):
            # A draining node sheds fast-path owners toward a surviving
            # node (they submit through the raylet if none has room).
            return spill_or_retry()
        if (self._waiting or self._pending.qsize()) and not self._can_run_soon(
                {k: 2 * v for k, v in resources.items()}):
            return {"retry": True}  # let the queue drain first
        gpus = self._try_acquire(resources)
        if gpus is None:
            return spill_or_retry() if self._cluster_size > 1 else {"retry": True}
        w = self._checkout_worker(env_key)
        if w is None:
            self._release(resources, gpus)
            return {"retry": True}
        token = uuid.uuid4().hex
        self._leases[w.worker_id] = {"resources": resources, "gpus": gpus,
                                     "granted_at": time.monotonic(), "token": token}
        w.mailbox.put({"type": "direct", "token": token})
        return {"granted": {"worker_id": w.worker_id, "sock": self._direct_sock(w.worker_id),
                            "token": token}}

    def return_worker_lease(self, worker_id: str, token: Optional[str] = None) -> bool:
        """Lease handed back (by the owner, the worker, or both): releases the
        held resources once, token-matched, and pools the worker."""
        lease = self._leases.get(worker_id)
        if lease is not None and token is not None and lease.get("token") == token:
            self._leases.pop(worker_id, None)
            self._release(lease["resources"], lease.get("gpus"))
        with self._workers_lock:
            w = self._workers.get(worker_id)
            if w is not None and w.proc.poll() is None and w.actor_id is None \
                    and w.busy_with is None:
                idle = self._idle.setdefault(w.env_key, [])
                if worker_id not in idle:
                    idle.append(worker_id)
        self._sched_wake.set()
        return True

    def _maybe_reclaim_leases(self, needed: Dict[str, float]) -> None:
        """Queued work cannot get resources while leases hold them: revoke
        leases (resources released now) and tell each worker to wind down."""
        now = time.monotonic()
        if now - self._last_reclaim < 0.1:
            return
        self._last_reclaim = now
        victims: List[str] = []
        for wid, lease in list(self._leases.items()):
            if now - lease.get("granted_at", 0.0) < 0.25:
                continue  # just granted: let it do some work first
            if any(lease["resources"].get(k, 0.0) > 0 for k in needed) or not needed:
                lease2 = self._leases.pop(wid, None)
                if lease2 is not None:
                    victims.append(wid)
                    self._release(lease2["resources"], lease2.get("gpus"))
        for wid in victims:
            threading.Thread(target=self._send_revoke, args=(wid,), daemon=True).start()
        if victims:
            self._sched_wake.set()

    def _send_revoke(self, worker_id: str) -> None:
        """Tells a worker over its direct socket that its lease is revoked;
        retries while the worker boots and binds that socket."""
        import socket as socketlib

        from .rpc import _send_msg

        deadline = time.monotonic() + 15.0
        while time.monotonic() < deadline:
            with self._workers_lock:
                w = self._workers.get(worker_id)
            if w is None or w.proc.poll() is not None:
                return
            try:
                s = socketlib.socket(socketlib.AF_UNIX, socketlib.SOCK_STREAM)
                s.settimeout(2.0)
                s.connect(self._direct_sock(worker_id))
                _send_msg(s, pickle.dumps(("rv",)))
                s.close()
                return
            except OSError:
                time.sleep(0.1)

    def lease_active(self, worker_id: str) -> bool:
        return worker_id in self._leases

    def cancel_lease_task(self, worker_id: str, task_id: str, force: bool = False) -> bool:
        """Cancels a task pushed directly to a leased worker: marks intent
        (the worker checks is_cancelled) and interrupts the process."""
        self._mark_cancelled(task_id)
        with self._workers_lock:
            w = self._workers.get(worker_id)
        if w is None:
            return False
        if force:
            w.proc.kill()
        else:
            try:
                w.proc.send_signal(signal.SIGINT)
            except OSError:
                pass
        return True

    def fastpath_done(self, worker_id: str, sealed: List[str], events) -> bool:
        """Batched completions from a leased/direct worker: seal locations and
        task events, one-way and off the latency path."""
        if sealed:
            self._notify_sealed(sealed)
        for evt in events or ():
            # (task_id, state) or (task_id, state, started, ended, name): the
            # worker's own clock gives a call that ran its RUNNING -> end span.
            if len(evt) > 2 and evt[2] is not None:
                self._task_event(evt[0], "RUNNING", ts=evt[2], name=evt[4])
                self._task_event(evt[0], evt[1], ts=evt[3])
            else:
                self._task_event(evt[0], evt[1])
        return True

    # -------------------------------------------------------- worker loop
    def worker_poll(self, worker_id: str) -> dict:
        """Long-poll on the worker's task mailbox (the reference's PushTask
        direction inverted: workers pull)."""
        with self._workers_lock:
            w = self._workers.get(worker_id)
            registering = w is None and worker_id in self._spawning
        if w is None:
            if registering:
                # Forked and polling before the batch that spawned it is
                # registered: "stop" would end a worker the raylet is about
                # to hand an actor (it exited 0 with no output: "worker
                # process died"). It polls again.
                time.sleep(0.01)
                return {"type": "noop"}
            return {"type": "stop"}
        w.ready = True
        if w.busy_with is not None and w.mailbox.empty():
            # A serial worker polls only after reporting its task, so a poll
            # with busy_with set means the reply carrying the entry was lost.
            return {"type": "task", "entry": w.busy_with}
        try:
            msg = w.mailbox.get(timeout=POLL_TIMEOUT_S)
        except queue.Empty:
            msg = {"type": "noop"}
        if msg.get("type") != "direct" and worker_id in self._leases:
            # A lease holder polling for pool work has left direct mode and
            # its return notification was lost: reclaim the lease.
            lease = self._leases.get(worker_id)
            if lease is not None and time.monotonic() - lease.get("granted_at", 0.0) > 2.0:
                self.return_worker_lease(worker_id, lease.get("token"))
        return msg

    def worker_step(self, worker_id: str, done: Optional[dict] = None) -> dict:
        """Completion report plus next-task poll: one RPC per task."""
        if done is not None:
            self.worker_done(worker_id, done.get("ok", True), done.get("sealed"),
                             done.get("task_id"))
        return self.worker_poll(worker_id)

    def worker_done(self, worker_id: str, ok: bool, sealed: Optional[List[str]] = None,
                    task_id: Optional[str] = None) -> bool:
        with self._workers_lock:
            w0 = self._workers.get(worker_id)
            if w0 is not None and task_id is not None and w0.last_done == task_id:
                return True  # duplicate report
        if sealed:
            self._notify_sealed(sealed)
        if task_id is not None:
            self._cancelled.pop(task_id, None)
        with self._workers_lock:
            w = self._workers.get(worker_id)
            if w is None:
                return False
            entry = w.busy_with
            w.busy_with = None
            w.last_done = task_id
            if w.actor_id is None:
                idle = self._idle.setdefault(w.env_key, [])
                if worker_id not in idle:
                    idle.append(worker_id)
        if w.actor_id is not None and entry is None:
            with self._actor_lock:
                a = self._actors.get(w.actor_id)
                if a and a["inflight"]:
                    idx = next((i for i, e in enumerate(a["inflight"])
                                if e["task_id"] == task_id), None)
                    if idx is not None:
                        finished = a["inflight"].pop(idx)
                        self._task_event(finished["task_id"], "FINISHED" if ok else "FAILED")
        if entry is not None:
            self._task_event(entry["task_id"], "FINISHED" if ok else "FAILED")
            if entry["type"] == "task":
                self._release_entry(entry)
            elif entry["type"] == "actor_creation":
                aid = entry["actor_id"]
                with self._actor_lock:
                    a = self._actors.get(aid)
                    if a:
                        a["state"] = "ALIVE" if ok else "DEAD"
                if ok:
                    with self._buf_lock:
                        self._started_buf.append(aid)
                    self._buf_wake.set()
                else:
                    try:
                        self._gcs_call_fenced("actor_died", aid, "constructor failed", True,
                                              self.node_id)
                    except Exception as e:  # noqa: BLE001 - logged; the caller's get raises
                        _log.warning("actor_died report for %s failed: %r", aid[:8], e)
        self._sched_wake.set()
        return True

    # --------------------------------------------------------- scheduling
    def _scheduler_loop(self) -> None:
        while not self._stop.is_set():
            self._sched_wake.wait(timeout=0.05)
            self._sched_wake.clear()
            while True:
                try:
                    self._waiting.append(self._pending.get_nowait())
                except queue.Empty:
                    break
            still: List[dict] = []
            for e in self._waiting:
                try:
                    if e.get("task_id") in self._cancelled:
                        self._cancelled.pop(e["task_id"], None)
                        self._store_error_for(e, exc.TaskCancelledError(
                            f"{e.get('desc', 'task')} was cancelled"))
                        continue
                    if not self._deps_ready(e) or not self._dispatch(e):
                        still.append(e)
                except Exception as sched_err:  # noqa: BLE001 - fail the entry, keep the loop
                    try:
                        self._store_error_for(e, sched_err)
                    except Exception as store_err:  # noqa: BLE001
                        _log.warning("could not store scheduling error for %s: %r",
                                     e.get("task_id", "?")[:8], store_err)
            self._waiting = still
            imet.SCHED_QUEUE_DEPTH.set(len(still) + self._pending.qsize())

    def _deps_ready(self, entry: dict) -> bool:
        for dep_hex in entry.get("deps", []):
            if not self.store.contains(ObjectID.from_hex(dep_hex)):
                self._pull_async(dep_hex)  # deduped; checked again next round
                return False
        return True

    def _dispatch(self, entry: dict) -> bool:
        if entry.get("_node_incarnation", self._incarnation) != self._incarnation:
            # Queued by an incarnation fenced since: the GCS failed this
            # node's tasks at its death and the owners retried elsewhere, so
            # running it here would apply it twice. Dropped silently: a
            # FAILED event would carry the fresh epoch past the fence and
            # overwrite a live retry's record.
            return True
        kind = entry["type"]
        if kind in ("task", "actor_creation"):
            if self._fail_if_unschedulable(entry):
                if kind == "actor_creation":
                    self._actor_creation_failed(entry, "placement bundle gone")
                return True
            if not self._try_acquire_entry(entry):
                self._maybe_reclaim_leases(entry["resources"])
                return False
            env_key = self._env_key(entry)
            try:
                if kind == "task":
                    w = self._checkout_worker(env_key)
                else:
                    # The actor's launch span, parented to the driver's
                    # actor_launch span through the entry's trace_ctx.
                    with _tracing.continue_context(
                            entry.get("trace_ctx"), "actor_launch.worker_spawn",
                            {"actor_id": entry.get("actor_id", "")}) as sp:
                        with self._workers_lock:
                            w = self._pop_idle_locked(env_key)
                            if w is not None:
                                w.actor_id = entry["actor_id"]
                        pooled = w is not None
                        if w is None:
                            w = self._spawn_worker(actor_id=entry["actor_id"], env_key=env_key)
                        else:
                            self._pool.note_hit("idle")
                        if sp is not None:
                            sp["attrs"]["mode"] = "pooled" if pooled else "spawned"
            except BaseException:
                # A runtime env that failed to materialise: the scheduler
                # stores the error on this entry; its resources go back.
                self._release_entry(entry)
                if kind == "actor_creation":
                    self._actor_creation_failed(entry, "runtime_env setup failed")
                raise
            if w is None:
                self._release_entry(entry)
                return False
            if kind == "actor_creation":
                with self._actor_lock:
                    a = self._actors.get(entry["actor_id"])
                    if a is not None:
                        a["worker_id"] = w.worker_id
                        a["resources_held"] = True
                        w.actor_rec = a
            self._observe_dispatch(entry)
            if kind == "task":
                self._schedule_span(entry)
            w.busy_with = entry
            self._task_event(entry["task_id"], "RUNNING")
            w.mailbox.put({"type": "task", "entry": entry})
            return True
        if kind == "actor_task":
            aid = entry["actor_id"]
            with self._actor_lock:
                a = self._actors.get(aid)
                if a is None or a["state"] == "DEAD":
                    self._store_error_for(entry, exc.ActorDiedError(aid, "dead"))
                    return True
                wid = a.get("worker_id")
            if wid is None:
                return False  # still constructing
            with self._workers_lock:
                w = self._workers.get(wid)
            if w is None:
                return False
            with self._actor_lock:
                a["inflight"].append(entry)  # the actor mailbox keeps submission order
            self._observe_dispatch(entry)
            self._task_event(entry["task_id"], "RUNNING")
            w.mailbox.put({"type": "task", "entry": entry})
            return True
        return True

    @staticmethod
    def _observe_dispatch(entry: dict) -> None:
        ts = entry.pop("_q_ts", None)
        if ts is not None:
            imet.SCHED_DISPATCH_LATENCY.observe((time.monotonic() - ts) * 1e3)

    def _schedule_span(self, entry: dict) -> None:
        """The middle rung of the submit -> schedule -> execute flow: a
        near-zero-width span at the dispatch decision, a step of the
        entry's flow. Tracing off: one dict lookup."""
        ctx = entry.get("trace_ctx")
        if ctx and _tracing.is_enabled():
            with _tracing.continue_context(
                    dict(ctx, flow=None),  # a step, not the head: no flow_in
                    f"schedule {entry.get('desc', 'task')}",
                    {"task_id": entry.get("task_id", ""), "node_id": self.node_id[:12],
                     "flow_step": ctx.get("flow")}):
                pass

    def _actor_creation_failed(self, entry: dict, reason: str) -> None:
        with self._actor_lock:
            a = self._actors.get(entry["actor_id"])
            if a:
                a["state"] = "DEAD"
        try:
            self._gcs_call_fenced("actor_died", entry["actor_id"], reason, True, self.node_id)
        except Exception as e:  # noqa: BLE001 - logged; the caller's get raises
            _log.warning("actor_died report failed: %r", e)

    def _env_key(self, entry: dict) -> str:
        """The pool key of the worker an entry needs: its runtime env and
        the device ids it was leased (reference: worker_pool PopWorker
        matching the runtime_env hash and the accelerator visibility)."""
        desc: Dict[str, Any] = {}
        if entry.get("runtime_env"):
            desc["runtime_env"] = entry["runtime_env"]
        if entry.get("_gpus"):
            desc["gpu"] = sorted(entry["_gpus"])
        if self._entry_bundle_key(entry) is not None and self.labels.get("slice_name"):
            # A bundle's worker on a slice host learns the slice's identity.
            desc["slice"] = [str(self.labels["slice_name"]),
                             int(self.labels.get("worker_index", 0))]
        return json.dumps(desc, sort_keys=True) if desc else ""

    def _pop_idle_locked(self, env_key: str) -> Optional[_Worker]:
        """Pops a live idle worker for this env key (callers hold
        _workers_lock): a booted one, the most recently idle first, since it
        most likely has what the next task imports (torch, a CUDA context)."""
        idle = self._idle.setdefault(env_key, [])
        for i in range(len(idle) - 1, -1, -1):
            w = self._workers.get(idle[i])
            if w is not None and w.ready and w.proc.poll() is None and w.actor_id is None:
                del idle[i]
                return w
        while idle:
            w = self._workers.get(idle.pop())
            if w is not None and w.proc.poll() is None and w.actor_id is None:
                return w
        return None

    def _checkout_worker(self, env_key: str = "") -> Optional[_Worker]:
        with self._workers_lock:
            w = self._pop_idle_locked(env_key)
            if w is not None:
                self._pool.note_hit("idle")
                return w
            n_task_workers = sum(1 for w in self._workers.values() if w.actor_id is None)
            if n_task_workers < self._max_task_workers:
                return self._spawn_worker_locked(env_key=env_key)
            # At the cap with only other-env idle workers: retire one.
            for k, lst in self._idle.items():
                if k != env_key and lst:
                    old = self._workers.pop(lst.pop(), None)
                    if old is not None:
                        old.mailbox.put({"type": "stop"})
                    return self._spawn_worker_locked(env_key=env_key)
        return None

    def _default_spawn_spec(self, env_key: str = "") -> Tuple[str, List[str], Dict[str, str], str]:
        """(worker id, worker_proc argv, env, log base): the one assembly of a
        worker's spawn, shared by the zygote and the Popen path."""
        worker_id = uuid.uuid4().hex[:12]
        env = dict(os.environ)
        env["RAY_TPU_WORKER"] = "1"
        env["RAY_TPU_LOG_DIR"] = self._log_dir  # the worker's JSONL beside its .out/.err
        desc = json.loads(env_key) if env_key else {}
        slice_name, worker_index = desc.get("slice") or (None, 0)
        if self._has_gpus:
            env.update(self._gpu_manager.worker_visibility_env(
                desc.get("gpu", []), slice_name=slice_name, worker_index=worker_index))
        else:
            env.update(slice_env(slice_name, worker_index))
        log_base = os.path.join(self._log_dir, f"worker_{worker_id}")
        argv = [self.sock_path, self.store_path, self.gcs_sock, worker_id, self.node_id]
        return worker_id, argv, env, log_base

    def _prestart_idle(self, n: int) -> int:
        """Spawns `n` idle workers (the boot prestart and the pool's refill)
        into the default pool: one batched request to the zygote, each
        taking a parked child where one is, else Popen one by one. They
        enter the idle pool, or they would count against the task-worker
        cap while no checkout could find them."""
        if n <= 0:
            return 0
        specs, wids = [], []
        for _ in range(n):
            wid, argv, env, log_base = self._default_spawn_spec()
            specs.append(ZygoteClient.spawn_spec(argv, env, log_base + ".out",
                                                 log_base + ".err", log_base + ".exit"))
            wids.append(wid)
        with self._workers_lock:
            self._spawning.update(wids)
        try:
            t0 = time.perf_counter()
            results = self._pool.zygote_spawn_batch(specs)
        except ZygoteUnavailableError as e:
            _log.debug("batched prestart fell back to popen: %r", e)
            with self._workers_lock:
                self._spawning.difference_update(wids)  # strays are told to stop
        else:
            per_ms = (time.perf_counter() - t0) * 1e3 / max(1, len(results))
            with self._workers_lock:
                for wid, (pid, _warm) in zip(wids, results):
                    status = os.path.join(self._log_dir, f"worker_{wid}.exit")
                    self._workers[wid] = _Worker(wid, PidHandle(pid, status))
                    self._spawned_pids[wid] = pid
                    self._idle.setdefault("", []).append(wid)
                self._spawning.difference_update(wids)
            for _pid, warm in results:
                mode = "prefork" if warm else "zygote"
                imet.WORKER_SPAWN_TOTAL.inc(mode=mode)
                imet.ZYGOTE_FORK_LATENCY.observe(per_ms, mode=mode)
            self._sched_wake.set()
            return len(results)
        spawned = 0
        for _ in range(n):
            if self._stop.is_set():
                break
            with self._workers_lock:
                w = self._spawn_worker_locked(_pool_refill=True)
                self._idle.setdefault("", []).append(w.worker_id)
            spawned += 1
        if spawned:
            self._sched_wake.set()
        return spawned

    def _retire_idle(self, k: int) -> int:
        """Stops up to `k` idle workers, oldest first, taken out of the idle
        lists under the lock so no checkout adopts one being stopped."""
        retired = 0
        with self._workers_lock:
            for lst in self._idle.values():
                while lst and retired < k:
                    w = self._workers.get(lst.pop(0))
                    if w is None or w.proc.poll() is not None:
                        continue
                    w.mailbox.put({"type": "stop"})
                    retired += 1
        return retired

    def _spawn_worker(self, actor_id: Optional[str] = None, env_key: str = "") -> _Worker:
        with self._workers_lock:
            return self._spawn_worker_locked(actor_id, env_key)

    def _spawn_worker_locked(self, actor_id: Optional[str] = None, env_key: str = "",
                             _pool_refill: bool = False) -> _Worker:
        """Materialises the key's runtime env (packages fetched, a venv
        built; raises on failure, which the scheduler stores on the entry),
        then forks the worker from the zygote (a parked child, else a fresh
        fork). It Popens when the zygote cannot serve, and when the env sets
        variables, another interpreter or a command prefix: the zygote
        imported torch and the worker stack already, so variables read at
        import would not take effect in a fork. CUDA_VISIBLE_DEVICES alone
        may fork: CUDA reads it at the worker's first cuInit."""
        worker_id, worker_args, env, log_base = self._default_spawn_spec(env_key)
        renv = (json.loads(env_key) if env_key else {}).get("runtime_env")
        py_exe, prefix = sys.executable, None
        if renv:
            from .runtime_env import materialize_runtime_env

            py_exe, renv = materialize_runtime_env(renv, self.gcs)
            for k, v in (renv.get("env_vars") or {}).items():
                env[str(k)] = str(v)
            env["RAY_TPU_RUNTIME_ENV"] = json.dumps(renv)
            prefix = renv.get("_command_prefix")
        t0 = time.perf_counter()
        proc = None
        if py_exe == sys.executable and not prefix and not (renv or {}).get("env_vars"):
            try:
                pid, warm = self._pool.zygote_spawn(worker_args, env, log_base + ".out",
                                                    log_base + ".err", log_base + ".exit")
            except ZygoteUnavailableError:
                # A timed-out request may still be forked once the daemon
                # moves again. That child carries this worker id, so the
                # Popen takes a new one: the raylet never adopts the old id,
                # and answers the stray child's first poll with "stop".
                worker_id = uuid.uuid4().hex[:12]
                worker_args[3] = worker_id
                log_base = os.path.join(self._log_dir, f"worker_{worker_id}")
            else:
                proc = PidHandle(pid, log_base + ".exit")
                mode = "prefork" if warm else "zygote"
                if not _pool_refill:
                    if warm:
                        self._pool.note_hit("prefork")
                    else:
                        self._pool.note_miss("zygote")
        if proc is None:
            argv = [py_exe, "-m", "ray_tpu_torch.core.worker_proc", *worker_args]
            if prefix:
                argv = self._expand_prefix(prefix, env) + argv
            with open(log_base + ".out", "ab", buffering=0) as out_f, \
                    open(log_base + ".err", "ab", buffering=0) as err_f:
                proc = subprocess.Popen(argv, env=env, stdout=out_f, stderr=err_f)
            mode = "popen"
            if not _pool_refill:
                self._pool.note_miss("popen")
        imet.ZYGOTE_FORK_LATENCY.observe((time.perf_counter() - t0) * 1e3, mode=mode)
        imet.WORKER_SPAWN_TOTAL.inc(mode=mode)
        w = _Worker(worker_id, proc, env_key=env_key)
        w.actor_id = actor_id
        self._workers[worker_id] = w
        self._spawned_pids[worker_id] = proc.pid
        return w

    @staticmethod
    def _expand_prefix(prefix: List[str], env: Dict[str, str]) -> List[str]:
        """A container plugin's command prefix (image_uri), with its
        sentinel replaced by `--env K=V` for every variable this spawn set
        beyond the inherited environment (docker has no --env-host)."""
        from .runtime_env import ImageUriPlugin

        out: List[str] = []
        for part in prefix:
            if part == ImageUriPlugin.ENV_ARGS_SENTINEL:
                for k, v in env.items():
                    if os.environ.get(k) != v:
                        out += ["--env", f"{k}={v}"]
            else:
                out.append(part)
        return out

    def _store_error_for(self, entry: dict, error: BaseException) -> None:
        sealed = []
        for rid_hex in entry["return_ids"]:
            oid = ObjectID.from_hex(rid_hex)
            err_obj = StoredError(error, entry.get("desc", ""))
            try:
                try:
                    self.store.put(oid, err_obj)
                except exc.ObjectStoreFullError as e:
                    self.ensure_space(e.nbytes)
                    self.store.put(oid, err_obj)
                sealed.append(oid.hex())
            except Exception as put_err:  # noqa: BLE001
                _log.warning("failed to store error object for %s: %r", oid.hex()[:8], put_err)
        self._notify_sealed(sealed)
        self._task_event(entry["task_id"], "FAILED", reason=str(error))

    def _worker_log_tail(self, worker_id: str, n_lines: int = 50) -> str:
        """The last captured output lines of one worker (its .err and .out
        files, each under a header): the tail a crash's error, its error
        report and its post-mortem carry."""
        chunks: List[str] = []
        for ext in (".err", ".out"):
            path = os.path.join(self._log_dir, f"worker_{worker_id}{ext}")
            try:
                size = os.path.getsize(path)
                with open(path, "rb") as f:
                    f.seek(max(0, size - 16384))
                    data = f.read()
            except OSError:
                continue
            lines = data.decode(errors="replace").splitlines()[-n_lines:]
            if lines:
                chunks.append(f"--- worker_{worker_id}{ext} (tail) ---")
                chunks.extend(lines)
        return "\n".join(chunks)

    def _write_postmortem(self, w: _Worker, tail: str) -> Optional[str]:
        """Writes a dying worker's exit status, task and output tail to the
        flight dir, where the rings land."""
        from ..observability import flight_recorder as _fr

        try:
            d = _fr.flight_dir()
            os.makedirs(d, exist_ok=True)
            path = os.path.join(d, f"postmortem_{w.worker_id}_{time.time_ns() // 1000}.json")
            payload = {"worker_id": w.worker_id, "node_id": self.node_id,
                       "actor_id": w.actor_id, "exit_code": w.proc.poll(),
                       "task": (w.busy_with or {}).get("desc"),
                       "tail": tail.splitlines()}
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(payload, f, default=repr)
            os.replace(tmp, path)
            return path
        except OSError:
            return None

    def _deliberate_end(self, w: _Worker, entry: Optional[dict]) -> bool:
        """A killed actor or a cancelled task ends its worker on purpose:
        no crash to report."""
        if entry is not None and entry.get("task_id") in self._cancelled:
            return True
        if w.actor_id is not None:
            with self._actor_lock:
                a = self._actors.get(w.actor_id)
            return a is not None and a.get("state") == "DEAD"
        return False

    def _monitor_loop(self) -> None:
        """Detects worker-process death; fails or retries in-flight work and
        drives the actor restart state machine (reference: node_manager
        worker-failure handling + gcs_actor_manager.h:548)."""
        while not self._stop.wait(config.WORKER_MONITOR_INTERVAL_S):
            dead: List[_Worker] = []
            with self._workers_lock:
                for w in list(self._workers.values()):
                    if w.proc.poll() is not None:
                        dead.append(w)
                        del self._workers[w.worker_id]
                        idle_list = self._idle.get(w.env_key)
                        if idle_list and w.worker_id in idle_list:
                            idle_list.remove(w.worker_id)
            for w in dead:
                lease = self._leases.pop(w.worker_id, None)
                if lease is not None:
                    self._release(lease["resources"], lease.get("gpus"))
                try:
                    os.unlink(self._direct_sock(w.worker_id))
                except OSError:
                    pass
                entry = w.busy_with
                tail = ""
                if w.proc.poll() not in (0, None) and not self._deliberate_end(w, entry):
                    tail = self._worker_log_tail(w.worker_id)
                    self._write_postmortem(w, tail)
                    self._report_crash(w, entry, tail)
                tail_note = f"; last output:\n{tail}" if tail else ""
                if entry is not None and entry["type"] != "actor_creation":
                    self._release_entry(entry)
                    mr = entry.get("max_retries", 0)
                    if entry.get("task_id") in self._cancelled:
                        self._cancelled.pop(entry["task_id"], None)
                        self._store_error_for(entry, exc.TaskCancelledError(
                            f"{entry.get('desc', 'task')} was cancelled"))
                    elif mr < 0 or mr - entry.get("attempt", 0) > 0:
                        entry["attempt"] = entry.get("attempt", 0) + 1
                        imet.TASKS_RETRIED.inc()
                        self._task_event(entry["task_id"], "QUEUED")
                        self._enqueue(entry)
                    else:
                        self._store_error_for(entry, exc.WorkerCrashedError(
                            f"worker died executing {entry.get('desc', 'task')}{tail_note}"))
                if w.actor_id is not None:
                    self._on_actor_worker_death(w, tail_note)
            with self._buf_lock:
                retry, self._deferred_deletes = list(self._deferred_deletes), set()
            if retry:
                self.delete_objects(retry)
            # Background relief: spill ahead of allocation failures.
            cap = self.store.capacity()
            if self.store.bytes_in_use() > config.SPILL_THRESHOLD * cap:
                self._spill_to(int(0.75 * config.SPILL_THRESHOLD * cap))

    def _report_crash(self, w: _Worker, entry: Optional[dict], tail: str) -> None:
        """A worker that died abnormally while it ran a task or hosted an
        actor goes to the GCS error table with its output's tail."""
        if entry is None and w.actor_id is None:
            return
        _log.warning("worker %s died abnormally (exit %s, task=%s)", w.worker_id,
                     w.proc.poll(), (entry or {}).get("desc"))
        error = f"worker died (exit {w.proc.poll()})"
        if entry is not None:
            error += f" executing {entry.get('desc', 'task')}"
        try:
            self.gcs.notify("report_error", {
                "type": "worker_crash", "node_id": self.node_id, "worker_id": w.worker_id,
                "actor_id": w.actor_id, "error": error, "log_tail": tail[-4000:]})
        except Exception as e:  # noqa: BLE001 - the error objects below are the contract
            _log.warning("crash report for %s failed: %r", w.worker_id, e)

    def _on_actor_worker_death(self, w: _Worker, tail_note: str = "") -> None:
        aid = w.actor_id
        with self._actor_lock:
            a = self._actors.get(aid)
            if a is None:
                return
            if (w.actor_rec is not None and a is not w.actor_rec) or a.get(
                    "worker_id") not in (None, w.worker_id):
                return  # a bygone worker of a re-created record
            was_dead = a["state"] == "DEAD"  # deliberate kill_actor()
            a["state"] = "DEAD"
            a["worker_id"] = None
            inflight, a["inflight"] = list(a.get("inflight", [])), []
            creation_entry = a.get("creation_entry")
            held, a["resources_held"] = a.get("resources_held", False), False
        err = exc.ActorDiedError(aid, f"worker process exited{tail_note}")
        if w.busy_with is not None and w.busy_with["type"] == "actor_creation":
            inflight.append(w.busy_with)
        for e in inflight:
            self._store_error_for(e, err)
        while True:
            try:
                m = w.mailbox.get_nowait()
            except queue.Empty:
                break
            if m.get("type") == "task":
                self._store_error_for(m["entry"], err)
        if held and creation_entry is not None:
            self._release_entry(creation_entry)
        if was_dead:
            return  # killed deliberately: the GCS already knows, no restart
        try:
            # Fenced while the worker died: the GCS already rescheduled the
            # actor, and a report would hijack the successor.
            self._gcs_call_fenced("actor_died", aid, f"worker process died{tail_note[:1200]}",
                                  False, self.node_id)
        except Exception as e:  # noqa: BLE001 - logged
            _log.warning("actor_died report for %s failed: %r", aid[:8], e)

    def _heartbeat_loop(self) -> None:
        while not self._stop.wait(config.HEARTBEAT_INTERVAL_S):
            with self._res_lock:
                avail = dict(self.available)
            # No workers lock: a spawn holds it while the zygote answers.
            # list() copies each table in one step under the interpreter lock.
            workers = list(self._workers.values())
            n_workers = len(workers)
            imet.WORKER_POOL_IDLE.set(sum(len(v) for v in list(self._idle.values())))
            imet.WORKER_POOL_BUSY.set(sum(1 for w in workers if w.busy_with is not None))
            imet.WORKER_POOL_LEASED.set(len(self._leases))
            with self._objects_lock:
                n_spilled = len(self._spilled)
            stats = {"bytes_in_use": self.store.bytes_in_use(),
                     "num_objects": self.store.num_objects(), "num_spilled": n_spilled,
                     "num_workers": n_workers, "wall_ts": time.time(),
                     "pool": self._pool.stats()}
            if self._draining:
                # A drain started here reaches the GCS's node record this
                # way; one the GCS started is already there.
                stats["draining"] = True
            send_avail, send_stats = self._hb_codec.encode(avail, stats)
            try:
                # Fenced: the GCS declared this node dead while a partition
                # hid its beats; _fence kills the workers and rejoins fresh.
                reply = self._gcs_call_fenced("heartbeat", self.node_id, send_avail, send_stats)
                if reply is _FENCED:
                    continue
                self._cluster_size = reply.get("nodes", self._cluster_size)
                self._pool.set_hint(int(reply.get("pool_hint", 0) or 0))
                if not reply.get("ok", True):
                    # A restarted GCS that lost this node: register again and
                    # take the epoch it grants (reference: the
                    # RayletNotifyGCSRestart path, core_worker.proto:441).
                    reg = self.gcs.call("register_node", self.node_id, self.advertised,
                                        self.store_path, self.total, self.labels)
                    self.epoch = reg.get("epoch", self.epoch)
                    self._hb_codec.force_full()
            except Exception as e:  # noqa: BLE001 - retried next tick
                # Debug only: at a 0.25 s beat a GCS restart would flood the
                # log. The codec's baselines moved for a beat never applied.
                _log.debug("heartbeat to GCS failed: %r", e)
                self._hb_codec.force_full()

    def _gcs_call_fenced(self, method: str, *args) -> Any:
        """One epoch-fenced GCS mutation: the epoch read before the call is
        its last argument, and on StaleNodeEpochError the fence runs for
        exactly the incarnation that spoke. Returns _FENCED then, else the
        reply."""
        ep = self.epoch
        try:
            return self.gcs.call(method, *args, ep)
        except exc.StaleNodeEpochError:
            self._fence(method, ep)
            return _FENCED

    def _fence(self, origin: str, epoch: Optional[int] = None) -> None:
        """The reaction to StaleNodeEpochError: the GCS declared this
        incarnation dead and has rescheduled its actors and dropped its
        object locations, so acting on any of that state would be split
        brain. The node dies as a member (every worker killed and reaped,
        leases, actors, bundles and GPU ids freed, queued work and buffers
        dropped, the parked pool drained, object pins forgotten) and then
        registers as a fresh incarnation with a new epoch.

        `epoch` is the one the rejected call carried: when another thread's
        fence already completed (self.epoch moved on), the rejection is
        about a bygone incarnation and is ignored, as a second fence would
        kill the fresh incarnation's workers with the GCS none the wiser."""
        with self._fence_guard:
            if self._fencing or self._stop.is_set():
                return
            if epoch is not None and epoch != self.epoch:
                return
            self._fencing = True
            self._max_fenced_epoch = max(self._max_fenced_epoch, self.epoch)
            # A new incarnation at the start: the old life's queued entries
            # are droppable at once, even if the registration below fails.
            self._incarnation += 1
        old_epoch = self.epoch
        try:
            _flight_record("node.fence", (self.node_id[:12], old_epoch, origin))
            _log.warning("node %s (epoch %s) fenced by the GCS via %s: killing workers, "
                         "dropping leases, registering again", self.node_id[:12], old_epoch,
                         origin)
            # Workers first: the old life's actors and tasks must stop. They
            # leave the table before the kill, so the monitor loop never
            # reports their deaths as crashes of records that moved.
            with self._workers_lock:
                victims = list(self._workers.values())
                self._workers.clear()
                self._idle.clear()
            for w in victims:
                try:
                    w.proc.kill()
                except OSError:
                    pass
            # Reap: a Popen'd child is waited here, a forked one is reaped by
            # the zygote (its PidHandle waits for the pid to go); until then
            # a process may still hold its CUDA context.
            deadline = time.monotonic() + 5.0
            for w in victims:
                try:
                    w.proc.wait(timeout=max(0.0, deadline - time.monotonic()))
                except subprocess.TimeoutExpired:
                    _log.warning("fenced worker %s (pid %d) not gone after the kill",
                                 w.worker_id, w.proc.pid)
                try:
                    os.unlink(self._direct_sock(w.worker_id))
                except OSError:
                    pass
            self._leases.clear()
            with self._actor_lock:
                self._actors.clear()
            with self._res_lock:
                self._bundles.clear()
                self.available = dict(self.total)
                # Every device id back in the free set: the workers that saw
                # them through CUDA_VISIBLE_DEVICES are gone.
                self._gpu_pool = {g: 1.0 for g in self._gpu_pool}
            with self._seen_lock:
                self._seen_submits.clear()
            # Queued work belongs to the old life (the GCS failed it at the
            # node's death); what sits in _waiting is dropped at dispatch by
            # its incarnation stamp.
            try:
                while True:
                    self._pending.get_nowait()
            except queue.Empty:
                pass
            with self._buf_lock:
                self._loc_buf.clear()
                self._evt_buf.clear()
                self._started_buf.clear()
                self._deferred_deletes.clear()
            # No pre-forked child outlives the incarnation that forked it.
            self._pool.on_fence()
            # The directory dropped this node's locations: forget the old
            # life's objects, so no later sync advertises them again.
            with self._evict_lock, self._objects_lock:
                self._local_objects.clear()
                self._spilled.clear()
            self._draining = False
            reg = self.gcs.call("register_node", self.node_id, self.advertised,
                                self.store_path, self.total, self.labels)
            self.epoch = reg.get("epoch", 0)
            self._cluster_size = reg.get("nodes", self._cluster_size)
            # The GCS built this node's record afresh: the next beat carries
            # everything.
            self._hb_codec.force_full()
            _log.warning("node %s rejoined as epoch %s", self.node_id[:12], self.epoch)
            self._sched_wake.set()
        except Exception as e:  # noqa: BLE001 - the next fenced beat retries it all
            _log.warning("fence of node %s did not complete (%r); will retry",
                         self.node_id[:12], e)
        finally:
            with self._fence_guard:
                self._fencing = False

    def ping(self) -> str:
        return "pong"

    def drain(self, deadline_s: float = 30.0) -> bool:
        """Preemption-notice handling (reference: the DrainNode RPC): new
        default-placement tasks are placed elsewhere and worker-lease
        requests spill to surviving nodes, while in-flight and bundle-pinned
        work keeps running through the grace window (gang supervisors own
        their members' checkpoint and stop). Idempotent."""
        if not self._draining:
            self._draining = True
            _log.warning("node %s draining (deadline %.1f s)", self.node_id[:12], deadline_s)
        self._sched_wake.set()
        return True

    def is_draining(self) -> bool:
        return self._draining

    def node_resources(self) -> Tuple[Dict[str, float], Dict[str, float]]:
        with self._res_lock:
            return dict(self.total), dict(self.available)

    def debug_state(self) -> dict:
        """Scheduler, worker-pool and object-plane introspection (first stop
        for a hang)."""
        with self._workers_lock:
            workers = {wid: {"actor": w.actor_id, "busy": (w.busy_with or {}).get("task_id"),
                             "env_key": w.env_key, "alive": w.proc.poll() is None,
                             "pid": w.proc.pid}
                       for wid, w in self._workers.items()}
            idle = {k: list(v) for k, v in self._idle.items()}
        with self._res_lock:
            avail = dict(self.available)
            gpu_pool = dict(self._gpu_pool)
        return {"workers": workers, "idle": idle,
                "leases": {k: v["resources"] for k, v in self._leases.items()},
                "available": avail, "gpu_pool": gpu_pool,
                "bundles": {f"{k[0][:8]}:{k[1]}": dict(v) for k, v in self._bundles.items()},
                "waiting": [e.get("task_id") for e in self._waiting],
                "pending_qsize": self._pending.qsize(), "pool": self._pool.stats(),
                "objects": self._object_stats()}

    def zygote_stats(self) -> dict:
        """The zygote daemon's own answer: its pid, its parked children and
        whether CUDA was ever initialised in it ({} while it is down)."""
        return self._pool.zygote_stats()

    # ------------------------------------------------ dumps and logs
    def flight_dump(self) -> dict:
        """Dumps this raylet's flight ring and SIGUSR2s its workers (each
        dumps its own ring). A worker younger than 5 s is skipped: one
        Popen'd and still in its imports has not bound the signal yet, and
        its default action would kill it. Returns the raylet's dump path,
        the workers signalled, the flight dir and the pids whose rings to
        expect (the harvest maps each to this node's clock offset)."""
        from ..observability import flight_recorder as _fr

        path = _fr.dump(reason=f"flight_dump (raylet {self.node_id[:12]})")
        pids = [os.getpid()]
        with self._workers_lock:
            workers = list(self._workers.values())
        now = time.monotonic()
        for w in workers:
            if now - w.spawned_at < 5.0:
                continue
            try:
                if w.proc.poll() is None:
                    # send_signal, not os.kill: a PidHandle never signals a
                    # recycled pid.
                    w.proc.send_signal(signal.SIGUSR2)
                    pids.append(w.proc.pid)
            except OSError:
                pass
        return {"path": path, "workers_signaled": len(pids) - 1, "dir": _fr.flight_dir(),
                "pids": pids}

    def profile(self, seconds: float = 5.0) -> dict:
        """Runs the in-process sampling profiler for `seconds` and dumps the
        hottest stacks (JSON for the trace merge, text for a person).
        Blocking: the RPC returns when the dump is on disk; the server's
        thread pool absorbs the wait."""
        from ..utils import sampling_profiler

        return sampling_profiler.run_for(seconds, name=f"raylet-{self.node_id[:12]}")

    _TAIL_FILTER_KEYS = ("component", "level", "task_id", "actor_id", "trace_id",
                         "worker_id", "node_id", "grep", "since_ts")

    def tail_logs(self, filters: Optional[dict] = None) -> List[dict]:
        """Filtered structured records from the session's log dir (newest
        `tail`, default 1000); workers' raw prints are there too, as the log
        monitor's capture records. Unknown filter keys are dropped."""
        from ..observability import logs as _logs

        filters = dict(filters or {})
        tail = filters.pop("tail", 1000)
        clean = {k: v for k, v in filters.items() if k in self._TAIL_FILTER_KEYS}
        return _logs.read_records(self._log_dir, tail=tail, **clean)

    def _worker_attribution(self, worker_id: str
                            ) -> Tuple[Optional[int], Optional[str], Optional[str]]:
        """(pid, actor_id, actor name) of one worker: the identity its
        output lines carry."""
        with self._workers_lock:
            w = self._workers.get(worker_id)
        if w is None:
            return None, None, None
        aid = w.actor_id
        name = None
        if aid:
            with self._actor_lock:
                a = self._actors.get(aid)
                entry = (a or {}).get("creation_entry") or {}
            name = entry.get("name") or f"Actor({aid[:8]})"
        return w.proc.pid, aid, name

    def _log_monitor_loop(self) -> None:
        """Tails this raylet's workers' worker_*.out / .err every 0.2 s: each
        batch of complete new lines is published on the `logs` pubsub
        channel, at most 200 lines a message so a burst of several workers
        fits the GCS's retention window, and written as structured capture
        records (component stdout/stderr, the worker's ids). A worker's
        identity is kept from when it was alive, and its pid from its
        spawn, so the last lines of one that died still carry them."""
        from ..observability import logs as _logs

        offsets: Dict[str, int] = {}
        known: Dict[str, Tuple[Optional[int], Optional[str], Optional[str]]] = {}
        while not self._stop.wait(0.2):
            try:
                names = sorted(os.listdir(self._log_dir))
            except OSError:
                continue
            for name in names:
                if not (name.startswith("worker_")
                        and (name.endswith(".out") or name.endswith(".err"))):
                    continue
                wid = name[len("worker_"):-len(".out")]
                if wid not in self._spawned_pids:
                    continue  # another node's worker, in the shared dir
                path = os.path.join(self._log_dir, name)
                try:
                    size = os.path.getsize(path)
                except OSError:
                    offsets.pop(name, None)
                    continue
                pos = offsets.get(name, 0)
                if pos > size:
                    pos = 0  # truncated or replaced: start over
                if size <= pos:
                    continue
                try:
                    with open(path, "rb") as f:
                        f.seek(pos)
                        data = f.read(size - pos)
                except OSError:
                    continue
                cut = data.rfind(b"\n")
                if cut < 0:
                    continue  # no complete line yet
                offsets[name] = pos + cut + 1
                lines = data[:cut + 1].decode(errors="replace").splitlines()
                if not lines:
                    continue
                stream = name.rsplit(".", 1)[1]
                attrib = self._worker_attribution(wid)
                if attrib[0] is not None:
                    known[wid] = attrib
                pid, aid, actor_name = known.get(wid, (self._spawned_pids[wid], None, None))
                now = time.time()
                _logs.write_capture_records([
                    _logs.capture_record(line, stream, self.node_id, wid, aid, pid, ts=now)
                    for line in lines])
                imet.LOG_LINES_PUBLISHED.inc(len(lines))
                for i in range(0, len(lines), 200):
                    msg = {"node_id": self.node_id, "worker_id": wid, "pid": pid,
                           "actor": actor_name, "stream": stream, "lines": lines[i:i + 200]}
                    try:
                        self.gcs.notify("pubsub_publish", "logs", msg)
                    except Exception:  # noqa: BLE001 - the GCS is away; the lines stay on disk
                        break
            # The retention GC rides the monitor, every ~10 s. Live workers'
            # files and the daemons' are protected: their writers hold them
            # open, and an unlink would void all their later output.
            now_mono = time.monotonic()
            if now_mono - self._last_log_gc > 10.0:
                self._last_log_gc = now_mono
                with self._workers_lock:
                    live = [f"worker_{wid}" for wid in self._workers]
                try:
                    _logs.gc_log_dir(self._log_dir,
                                     protect_prefixes=live + ["gcs", "raylet_", "zygote"])
                except Exception as e:  # noqa: BLE001 - the next round retries
                    _log.debug("log-dir GC failed this round: %r", e)

    def stop(self) -> bool:
        """Stops every worker of this node and the raylet's loops."""
        self._stop.set()
        self._reporter.stop()
        # A trigger after the stop must not dial the GCS through this raylet.
        _postmortem.disarm(self._trigger_forward)
        with self._workers_lock:
            workers = list(self._workers.values())
        for w in workers:
            w.mailbox.put({"type": "stop"})
        # A polling worker exits at once; one serving a lease or running a
        # task does not read its mailbox and is killed after a short grace.
        deadline = time.monotonic() + 0.3
        for w in workers:
            try:
                w.proc.wait(timeout=max(0.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                w.proc.kill()
        for w in workers:
            try:
                w.proc.wait(timeout=5.0)
            except subprocess.TimeoutExpired:
                _log.warning("worker %s (pid %d) did not exit", w.worker_id, w.proc.pid)
        self._pool.stop()
        with self._evict_lock, self._objects_lock:
            self._spilled.clear()
        shutil.rmtree(self._spill_dir, ignore_errors=True)
        return True


def main(argv: List[str]) -> None:
    node_id, sock_path, store_path, gcs_sock, resources_json, capacity, prestart = argv[:7]
    tcp_spec = (argv[7] if len(argv) > 7 else "") or None
    labels = json.loads(argv[8]) if len(argv) > 8 else {}
    from ..observability import logs as _logs
    from ..observability.flight_recorder import install_crash_hooks
    from .gcs import exit_with_parent

    from ..utils.sampling_profiler import maybe_start_from_env

    install_crash_hooks("raylet")
    _logs.configure("raylet", node_id=node_id,
                    directory=os.path.join(os.path.dirname(sock_path) or ".", "logs"))
    maybe_start_from_env("raylet")
    _log.info("raylet started (node %s, pid %d)", node_id[:12], os.getpid())
    # On a cluster that spans hosts the TCP endpoint is bound first, so the
    # service registers the port it got; connections wait for the service.
    servers = [RpcServer(tcp_spec, None)] if tcp_spec else []
    service = RayletService(node_id, sock_path, store_path, gcs_sock,
                            json.loads(resources_json), int(capacity), int(prestart),
                            advertise_address=servers[0].address if servers else None,
                            labels=labels)
    for server in servers:
        server.service = service
    servers.append(RpcServer(sock_path, service))
    exit_with_parent(service._stop)
    try:
        while not service._stop.wait(0.5):
            pass
    finally:
        service.stop()
        for server in servers:
            server.shutdown()
        service.store.close()


if __name__ == "__main__":
    main(sys.argv[1:])
