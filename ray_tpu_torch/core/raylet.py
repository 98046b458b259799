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
capacity of 1.0, as Ray does. Workers are pooled by the ids they see.

Kept: task, actor and lease scheduling; the worker poll/step/done loop;
local objects and `wait_objects`; `ensure_space` (frees and replica
eviction); bundles; pulls between raylets (`pull_object`,
`fetch_object(_chunk)`, `object_size`), over TCP when the cluster spans
hosts (the raylet then also serves and advertises a tcp:// endpoint);
`client_put` / `client_get` for remote client drivers; the warm pool, whose
workers fork from a zygote (core/worker_pool.py, core/zygote.py), with Popen
where the zygote cannot serve; `drain` (a preemption notice: default-
placement tasks and worker leases go to surviving nodes while in-flight and
bundle-pinned work runs on). Left out (ROADMAP Queue 1 item 3): runtime
envs, spill to disk and broadcast, push, epoch fencing, profile, tail_logs
and flight dumps. This module never imports torch.
"""

from __future__ import annotations

import collections
import json
import logging
import os
import pickle
import queue
import signal
import subprocess
import sys
import threading
import time
import uuid
from typing import Any, Dict, List, Optional, Set, Tuple

from .. import exceptions as exc
from ..accelerators import get_accelerator_manager
from ..utils import config
from ..utils import internal_metrics as imet
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


class RayletService:
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
    ):
        self.node_id = node_id
        self.sock_path = sock_path
        # What other nodes and the GCS dial: on a cluster that spans hosts,
        # a tcp:// endpoint; this node's own workers keep the UDS.
        self.advertised = advertise_address or sock_path
        self.store_path = store_path
        self.store = SharedMemoryStore.create(store_path, store_capacity)
        self.gcs = RpcClient(gcs_sock)
        self.gcs_sock = gcs_sock
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
        self._res_lock = threading.Lock()
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
        self._workers_lock = threading.Lock()
        self._max_task_workers = max(1, int(resources.get("CPU", 1)))
        self._cancelled: "collections.OrderedDict[str, bool]" = collections.OrderedDict()
        # (task_id, attempt) -> return ids: a one-way submit resent after a
        # reconnect must not run twice.
        self._seen_submits: "collections.OrderedDict[Tuple[str, int], List[str]]" = (
            collections.OrderedDict())
        self._seen_lock = threading.Lock()
        self._pending: "queue.Queue" = queue.Queue()
        self._sched_wake = threading.Event()
        self._waiting: List[dict] = []
        self._actors: Dict[str, dict] = {}
        self._actor_lock = threading.Lock()
        self._remote_raylets: Dict[str, RpcClient] = {}
        self._stop = threading.Event()
        self._draining = False
        self._hb_codec = HeartbeatCodec()
        self._seal_cv = threading.Condition()
        self._pulling: Set[str] = set()
        self._pull_sem = threading.BoundedSemaphore(config.MAX_CONCURRENT_PULLS)
        self._serve_sem = threading.BoundedSemaphore(config.MAX_CONCURRENT_SERVES)
        # Batched control-plane updates to the GCS (object locations, task
        # events, actor starts), off the task fast path.
        self._loc_buf: List[str] = []
        self._evt_buf: List[dict] = []
        self._started_buf: List[str] = []
        self._buf_lock = threading.Lock()
        self._buf_wake = threading.Event()
        self._deferred_deletes: Set[str] = set()
        # Local objects in seal order (True = primary, False = a pulled
        # replica that eviction may drop).
        self._local_objects: "collections.OrderedDict[str, bool]" = collections.OrderedDict()
        self._objects_lock = threading.Lock()
        self._evict_lock = threading.Lock()
        self._last_reclaim = 0.0
        self._log_dir = os.path.join(os.path.dirname(sock_path) or ".", "logs")
        os.makedirs(self._log_dir, exist_ok=True)
        # The warm pool and its zygote (core/worker_pool.py): spawns fork
        # from a daemon that already imported the worker stack and torch;
        # until it is up, or when it is down, they Popen.
        self._pool = WorkerPoolManager(self, prestart=prestart)
        reg = self.gcs.call("register_node", node_id, self.advertised, store_path, self.total)
        self._cluster_size = reg.get("nodes", 1)
        self._threads = [
            threading.Thread(target=self._scheduler_loop, daemon=True, name="sched"),
            threading.Thread(target=self._heartbeat_loop, daemon=True, name="hb"),
            threading.Thread(target=self._monitor_loop, daemon=True, name="monitor"),
            threading.Thread(target=self._flush_loop, daemon=True, name="flush"),
        ]
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
        evt.update(extra)
        with self._buf_lock:
            self._evt_buf.append(evt)
        self._buf_wake.set()

    def _enqueue(self, entry: dict) -> None:
        self._pending.put(entry)
        self._sched_wake.set()

    def _flush_loop(self) -> None:
        """Drains location, task-event and actor-start buffers to the GCS."""
        while not self._stop.is_set():
            self._buf_wake.wait(timeout=0.2)
            self._buf_wake.clear()
            with self._buf_lock:
                locs, self._loc_buf = self._loc_buf, []
                evts, self._evt_buf = self._evt_buf, []
                started, self._started_buf = self._started_buf, []
            if started:
                try:
                    verdicts = self.gcs.call("actor_started_batch", self.node_id, started)
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
                self.gcs.call("node_sync", self.node_id, locs, evts)
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
                except Exception:  # noqa: BLE001 - died mid-forward
                    pass
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
                except Exception:  # noqa: BLE001 - target died mid-forward; retried
                    pass
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
            self.gcs.call("actor_died", actor_id, "killed via kill()", no_restart, self.node_id)
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
        node if needed (reference: pull_manager.h:52)."""
        oid = ObjectID.from_hex(oid_hex)
        if self.store.contains(oid):
            return True
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            for loc in self.gcs.call("get_object_locations", oid_hex):
                if loc["node_id"] == self.node_id:
                    continue
                try:
                    if self._pull_from(loc["sock"], oid):
                        self._notify_sealed([oid_hex], primary=False)
                        return True
                except exc.ObjectStoreFullError:
                    break  # pins may drop; retry within the deadline
                except Exception:  # noqa: BLE001 - one dead location; try the next
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
            if self.store.contains(oid):
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
        pull=True (the get path) counts only local objects and fetches remote
        ones in; pull=False (the wait path) counts an object that exists
        anywhere in the cluster. Wakes on local seals."""
        if num_returns is None:
            num_returns = len(oid_hexes)
        deadline = time.monotonic() + max(0.0, timeout)
        exists_remote: Set[str] = set()
        last_loc_check = 0.0
        while True:
            ready = [h for h in oid_hexes
                     if h in exists_remote or self.store.contains(ObjectID.from_hex(h))]
            now = time.monotonic()
            if len(ready) >= num_returns or now >= deadline:
                return ready
            missing = [h for h in oid_hexes if h not in ready]
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
                return True
            finally:
                if not sealed:
                    self.store.delete(oid)  # never seal a truncated payload

    def object_size(self, oid_hex: str) -> Optional[int]:
        return self.store.raw_size(ObjectID.from_hex(oid_hex))

    def fetch_object_chunk(self, oid_hex: str, offset: int, length: int) -> Optional[bytes]:
        """Serves one chunk of the framed payload to a pulling raylet."""
        with self._serve_sem:
            return self.store.read_raw_chunk(ObjectID.from_hex(oid_hex), offset, length)

    def fetch_object(self, oid_hex: str) -> Optional[bytes]:
        return self.store.get_raw(ObjectID.from_hex(oid_hex))

    def ensure_space(self, nbytes: int) -> bool:
        """Makes room for an allocation of `nbytes`: the owners' pending frees
        first, then pulled replicas in seal order (LRU). Primary copies stay:
        spill to disk is not ported (ROADMAP Queue 1 item 3)."""
        target = max(0, int(self.store.capacity() * 0.95) - int(nbytes))
        try:
            self.gcs.call("flush_frees")
        except Exception:  # noqa: BLE001 - advisory; eviction below is the guarantee
            pass
        if self.store.bytes_in_use() <= target:
            return True
        with self._evict_lock:
            with self._objects_lock:
                replicas = [h for h, primary in self._local_objects.items() if not primary]
            for h in replicas:
                if self.store.bytes_in_use() <= target:
                    break
                if self.store.delete(ObjectID.from_hex(h)):
                    with self._objects_lock:
                        self._local_objects.pop(h, None)
                    try:
                        self.gcs.call("remove_object_location", h, self.node_id)
                    except Exception:  # noqa: BLE001 - the directory heals on the next sync
                        pass
        return self.store.bytes_in_use() <= target

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
            with self._objects_lock:
                self._local_objects.pop(h, None)
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
        for tid, state in events or ():
            self._task_event(tid, state)
        return True

    # -------------------------------------------------------- worker loop
    def worker_poll(self, worker_id: str) -> dict:
        """Long-poll on the worker's task mailbox (the reference's PushTask
        direction inverted: workers pull)."""
        with self._workers_lock:
            w = self._workers.get(worker_id)
        if w is None:
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
                        self.gcs.call("actor_died", aid, "constructor failed", True, self.node_id)
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

    def _deps_ready(self, entry: dict) -> bool:
        for dep_hex in entry.get("deps", []):
            if not self.store.contains(ObjectID.from_hex(dep_hex)):
                self._pull_async(dep_hex)  # deduped; checked again next round
                return False
        return True

    def _dispatch(self, entry: dict) -> bool:
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
            if kind == "task":
                w = self._checkout_worker(env_key)
                if w is None:
                    self._release_entry(entry)
                    return False
            else:
                with self._workers_lock:
                    w = self._pop_idle_locked(env_key)
                    if w is not None:
                        w.actor_id = entry["actor_id"]
                if w is None:
                    w = self._spawn_worker(actor_id=entry["actor_id"], env_key=env_key)
                else:
                    self._pool.note_hit("idle")
                with self._actor_lock:
                    a = self._actors.get(entry["actor_id"])
                    if a is not None:
                        a["worker_id"] = w.worker_id
                        a["resources_held"] = True
                        w.actor_rec = a
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
            self._task_event(entry["task_id"], "RUNNING")
            w.mailbox.put({"type": "task", "entry": entry})
            return True
        return True

    def _actor_creation_failed(self, entry: dict, reason: str) -> None:
        with self._actor_lock:
            a = self._actors.get(entry["actor_id"])
            if a:
                a["state"] = "DEAD"
        try:
            self.gcs.call("actor_died", entry["actor_id"], reason, True, self.node_id)
        except Exception as e:  # noqa: BLE001 - logged; the caller's get raises
            _log.warning("actor_died report failed: %r", e)

    def _env_key(self, entry: dict) -> str:
        """The pool key of the worker an entry needs: the device ids it was
        leased (workers are pooled by the devices they see)."""
        gpus = entry.get("_gpus")
        return json.dumps({"gpu": sorted(gpus)}) if gpus else ""

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

    def _spawn_worker(self, actor_id: Optional[str] = None, env_key: str = "") -> _Worker:
        with self._workers_lock:
            return self._spawn_worker_locked(actor_id, env_key)

    def _default_spawn_spec(self, env_key: str = "") -> Tuple[str, List[str], Dict[str, str], str]:
        """(worker id, worker_proc argv, env, log base): the one assembly of a
        worker's spawn, shared by the zygote and the Popen path."""
        worker_id = uuid.uuid4().hex[:12]
        env = dict(os.environ)
        env["RAY_TPU_WORKER"] = "1"
        if self._has_gpus:
            ids = json.loads(env_key)["gpu"] if env_key else []
            env.update(self._gpu_manager.worker_visibility_env(ids))
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
                                                 log_base + ".err"))
            wids.append(wid)
        try:
            t0 = time.perf_counter()
            results = self._pool.zygote_spawn_batch(specs)
        except ZygoteUnavailableError as e:
            _log.debug("batched prestart fell back to popen: %r", e)
        else:
            per_ms = (time.perf_counter() - t0) * 1e3 / max(1, len(results))
            with self._workers_lock:
                for wid, (pid, _warm) in zip(wids, results):
                    self._workers[wid] = _Worker(wid, PidHandle(pid))
                    self._idle.setdefault("", []).append(wid)
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
        """Forks the worker from the zygote (a parked child, else a fresh
        fork); Popens it when the zygote cannot. The port has no runtime
        envs, so every worker may fork: its environment differs from the
        zygote's only in CUDA_VISIBLE_DEVICES, which CUDA reads at the
        worker's first cuInit, not at import."""
        worker_id, worker_args, env, log_base = self._default_spawn_spec(env_key)
        t0 = time.perf_counter()
        try:
            pid, warm = self._pool.zygote_spawn(worker_args, env, log_base + ".out",
                                                log_base + ".err")
        except ZygoteUnavailableError:
            with open(log_base + ".out", "ab", buffering=0) as out_f, \
                    open(log_base + ".err", "ab", buffering=0) as err_f:
                proc = subprocess.Popen(
                    [sys.executable, "-m", "ray_tpu_torch.core.worker_proc", *worker_args],
                    env=env, stdout=out_f, stderr=err_f)
            mode = "popen"
            if not _pool_refill:
                self._pool.note_miss("popen")
        else:
            proc = PidHandle(pid)
            mode = "prefork" if warm else "zygote"
            if not _pool_refill:
                if warm:
                    self._pool.note_hit("prefork")
                else:
                    self._pool.note_miss("zygote")
        imet.ZYGOTE_FORK_LATENCY.observe((time.perf_counter() - t0) * 1e3, mode=mode)
        imet.WORKER_SPAWN_TOTAL.inc(mode=mode)
        w = _Worker(worker_id, proc, env_key=env_key)
        w.actor_id = actor_id
        self._workers[worker_id] = w
        return w

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

    def _worker_log_tail(self, worker_id: str, n_bytes: int = 2000) -> str:
        try:
            with open(os.path.join(self._log_dir, f"worker_{worker_id}.err"), "rb") as f:
                f.seek(0, os.SEEK_END)
                f.seek(max(0, f.tell() - n_bytes))
                return f.read().decode(errors="replace")
        except OSError:
            return ""

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
                if w.proc.poll() not in (0, None):
                    tail = self._worker_log_tail(w.worker_id)
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
            self.gcs.call("actor_died", aid, f"worker process died{tail_note[:1200]}", False,
                          self.node_id)
        except Exception as e:  # noqa: BLE001 - logged
            _log.warning("actor_died report for %s failed: %r", aid[:8], e)

    def _heartbeat_loop(self) -> None:
        while not self._stop.wait(config.HEARTBEAT_INTERVAL_S):
            with self._res_lock:
                avail = dict(self.available)
            with self._workers_lock:
                n_workers = len(self._workers)
            stats = {"bytes_in_use": self.store.bytes_in_use(),
                     "num_objects": self.store.num_objects(),
                     "num_workers": n_workers, "wall_ts": time.time(),
                     "pool": self._pool.stats()}
            if self._draining:
                # A drain started here reaches the GCS's node record this
                # way; one the GCS started is already there.
                stats["draining"] = True
            send_avail, send_stats = self._hb_codec.encode(avail, stats)
            try:
                reply = self.gcs.call("heartbeat", self.node_id, send_avail, send_stats)
                self._cluster_size = reply.get("nodes", self._cluster_size)
                self._pool.set_hint(int(reply.get("pool_hint", 0) or 0))
                if not reply.get("ok", True):
                    self.gcs.call("register_node", self.node_id, self.advertised,
                                  self.store_path, self.total)
                    self._hb_codec.force_full()
            except Exception as e:  # noqa: BLE001 - retried next tick
                _log.debug("heartbeat to GCS failed: %r", e)
                self._hb_codec.force_full()

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
        """Scheduler and worker-pool introspection (first stop for a hang)."""
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
                "pending_qsize": self._pending.qsize(), "pool": self._pool.stats()}

    def zygote_stats(self) -> dict:
        """The zygote daemon's own answer: its pid, its parked children and
        whether CUDA was ever initialised in it ({} while it is down)."""
        return self._pool.zygote_stats()

    def stop(self) -> bool:
        """Stops every worker of this node and the raylet's loops."""
        self._stop.set()
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
        return True


def main(argv: List[str]) -> None:
    node_id, sock_path, store_path, gcs_sock, resources_json, capacity, prestart = argv[:7]
    tcp_spec = argv[7] if len(argv) > 7 else None
    from .gcs import exit_with_parent

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s raylet %(levelname)s %(message)s")
    _log.info("raylet started (node %s, pid %d)", node_id[:12], os.getpid())
    # On a cluster that spans hosts the TCP endpoint is bound first, so the
    # service registers the port it got; connections wait for the service.
    servers = [RpcServer(tcp_spec, None)] if tcp_spec else []
    service = RayletService(node_id, sock_path, store_path, gcs_sock,
                            json.loads(resources_json), int(capacity), int(prestart),
                            advertise_address=servers[0].address if servers else None)
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
