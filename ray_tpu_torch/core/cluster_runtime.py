"""ClusterRuntime: the multi-process runtime, driver and worker side (the
port of ray_tpu/core/cluster_runtime.py, for one machine).

Re-design of the reference's driver bootstrap + CoreWorker client side
(reference: python/ray/_private/worker.py ray.init:1262 starting
Node.start_head_processes node.py:1354 — GCS and raylet daemons — and the
CoreWorker connecting to them, _raylet.pyx:3284). `Cluster` spawns one GCS
process and one raylet process per node (`add_node`, the analogue of
python/ray/cluster_utils.py:135), all on this machine and all speaking RPC
over Unix domain sockets. The driver holds a GCS client, its local raylet
client and the node's shared-memory store.

Completion signaling rides the object plane: a task's results (or a
StoredError) appear in the store or arrive inline on a direct worker's ack,
and `get` waits on that. Task functions and arguments are pickled by
core/serialization.py, which sends what another process cannot import by
value.

Liveness of a session. Every pool file is /dev/shm/rtpt_<session>_<node>.
The driver that started the session holds an exclusive `flock` on
/dev/shm/rtpt_<session>.lock for the session's life. The lock sits beside
the pools, so every process on the machine tests the same file whatever its
TMPDIR. The sweep of orphaned pools unlinks a session's pools only when it
can take that lock, which is when the driver is gone; a pool with no lock
file belongs to no session it knows and is kept. The JAX copy instead calls
a session dead when none of its daemon sockets accepts within 0.2 s
(cluster_runtime.py:1455-1537), which can unlink the live pool of a node
that is starting or slow under load; the port does not copy that, and
sweeps only rtpt_* pools.

A cluster spans hosts over TCP (core/rpc.py, with its auth token):
`Cluster(head_port=)` serves the GCS on a tcp:// port as well, every raylet
advertises a tcp:// endpoint, `start_worker_node` joins a raylet on this
host to a head elsewhere, and core/client_runtime.py is a driver outside the
cluster. A worker node's driver-side caller holds that node's session lock.

Runtime envs: a task's or actor's `runtime_env` is normalised here at
submission (core/runtime_env.py `process_runtime_env`: local working_dir and
py_modules directories become content-addressed packages in the GCS KV,
once per distinct env) and travels in the task's entry; the raylet
materialises it before it spawns the worker.

Observability: every process of the runtime binds the flight recorder's
crash hooks and arms the post-mortem trigger bus with its GCS client. Each
task entry carries `trace_ctx` (tracing.inject_context), so a worker's
execution span parents to the submitter's ambient span; `submit` and
`actor_launch` spans hold the flow arrows' tails. The driver writes its
structured records to the session's logs/ and re-prints its workers'
captured output from the `logs` pubsub channel with `(name pid=...
node=...)` prefixes, deduplicated and rate-limited (logs.DedupPrinter;
RAY_TPU_LOG_TO_DRIVER=0 turns it off); `_log_recent` keeps the last lines.

Sessions and labels. The head writes `<session_dir>/session.json` (the GCS
socket and TCP address, the head raylet's socket and store, its node id):
`ClusterRuntime.connect(session_dir)` attaches a driver to a running head
through it, which is what `init(address=<session dir> | "auto")` does
(api.py). Every node may carry labels, key/value tags given at
`Cluster(labels=)`, `add_node(labels=)` or `start_worker_node(labels=)`; the
raylet registers with them, the GCS keeps them in its snapshot and log,
and list_nodes / `nodes()` show them as `Labels`.

A remote client (core/client_runtime.py) iterates streaming returns too:
each step is one long poll on its gateway raylet.
"""

from __future__ import annotations

import atexit
import collections
import concurrent.futures
import fcntl
import glob
import hashlib
import json
import logging
import os
import pickle
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
import uuid
from typing import Any, Dict, List, Optional, Sequence

from .. import exceptions as exc
from .. import tracing as _tracing
from ..utils import config
from . import serialization
from ..native.build import shm_pool_lib
from .gcs_shards import resolve_shard_count
from .ids import ActorID, ObjectID, TaskID
from .object_transport import StoredError
from .rpc import RpcClient, require_auth_token
from .runtime_base import Runtime
from .shm_store import SharedMemoryStore
from .task_spec import ArgRef, TaskSpec, TaskType

_log = logging.getLogger("ray_tpu_torch.driver")

POOL_PREFIX = "rtpt_"


class _FunctionBlobs:
    """Pickles each task function or actor class once per process: a task
    loop must not re-pickle a large closure per call. Keeps the object
    alive, so its id cannot be reused while the entry exists."""

    def __init__(self):
        self._lock = threading.Lock()
        self._blobs: Dict[int, tuple] = {}

    def get(self, fn: Any):
        with self._lock:
            hit = self._blobs.get(id(fn))
            if hit is not None and hit[0] is fn:
                return hit[1], hit[2]
        blob = serialization.dumps(fn)
        fhash = hashlib.sha1(blob).hexdigest()
        with self._lock:
            self._blobs[id(fn)] = (fn, blob, fhash)
        return blob, fhash


def _entry_from_spec(spec: TaskSpec, blobs: _FunctionBlobs) -> dict:
    """Flattens a TaskSpec into the wire entry the raylet/worker consume."""
    deps = [a.object_id.hex() for a in spec.args if isinstance(a, ArgRef)]
    deps += [v.object_id.hex() for v in spec.kwargs.values() if isinstance(v, ArgRef)]
    resources = dict(spec.options.resources.to_dict()) if spec.options.resources else {}
    resources = {k: v for k, v in resources.items() if v}
    if spec.task_type == TaskType.NORMAL_TASK and not resources:
        resources = {"CPU": 1.0}
    streaming = spec.num_returns == "streaming"
    func_blob, func_hash = (blobs.get(spec.func_blob) if spec.task_type != TaskType.ACTOR_TASK
                            else (b"", ""))
    return {
        "task_id": spec.task_id.hex(),
        # The executing span parents to the submitter's ambient span, and a
        # flow id ties them (None with tracing off).
        "trace_ctx": _tracing.inject_context(),
        "func_blob": func_blob,
        "func_hash": func_hash,
        "method_name": spec.method_name,
        "args_blob": serialization.dumps((spec.args, spec.kwargs)),
        "deps": deps,
        # Streaming tasks pre-declare only the header (index 0).
        "return_ids": ([spec.task_id.object_id_for_return(0).hex()] if streaming
                       else [spec.task_id.object_id_for_return(i).hex()
                             for i in range(spec.num_returns)]),
        "streaming": streaming,
        "resources": resources,
        "actor_id": spec.actor_id.hex() if spec.actor_id else None,
        "max_restarts": spec.options.max_restarts,
        "max_retries": spec.options.max_retries,
        "max_concurrency": spec.options.max_concurrency,
        "concurrency_groups": spec.options.concurrency_groups,
        "concurrency_group": spec.concurrency_group,
        "runtime_env": spec.options.runtime_env,
        "attempt": 0,
        "strategy": spec.options.scheduling_strategy,
        "pg_id": spec.options.placement_group_id,
        "bundle_index": spec.options.bundle_index,
        "name": spec.options.name,
        "namespace": spec.options.namespace,
        "desc": spec.description(),
    }


def _submit_span(entry: dict):
    """The submit-side anchor of the submit -> execute flow arrow: a span
    with `flow_out`, paired with the flow id riding the entry's trace_ctx.
    Tracing off: nothing."""
    ctx = entry.get("trace_ctx")
    if not ctx:
        return _tracing.null_span()
    return _tracing.span(f"submit {entry.get('desc', 'task')}",
                         {"task_id": entry.get("task_id", ""), "flow_out": ctx.get("flow")})


class _ActorCreateBatcher:
    """Coalescing leader-follower batcher over the GCS `create_actors` RPC:
    a serial caller flushes at once (a batch of 1), and while one batch is
    in flight concurrent creators queue behind it and ride the next RPC."""

    def __init__(self, gcs: RpcClient):
        self._gcs = gcs
        self._cv = threading.Condition()
        self._queue: List[dict] = []
        self._inflight = False

    def create(self, spec: dict) -> dict:
        item = {"spec": spec, "done": False, "result": None}
        batch: Optional[List[dict]] = None
        with self._cv:
            self._queue.append(item)
            while not item["done"]:
                if not self._inflight and self._queue:
                    batch, self._queue = self._queue, []
                    self._inflight = True
                    break
                self._cv.wait()
        if batch is not None:
            results = None
            try:
                results = self._gcs.call("create_actors", [it["spec"] for it in batch])
            except Exception as e:  # noqa: BLE001 - every spec of the batch fails with it
                results = [{"error": e}] * len(batch)
            finally:
                with self._cv:
                    if results is None:
                        results = [{"error": RuntimeError("create_actors batch interrupted")}] \
                            * len(batch)
                    for it, r in zip(batch, results):
                        it["result"] = r
                        it["done"] = True
                    self._inflight = False
                    self._cv.notify_all()
        result = item["result"]
        err = result.get("error")
        if err is not None:
            raise err if isinstance(err, BaseException) else RuntimeError(str(err))
        return result


class _TaskRecord:
    """Owner-side record of a submitted task, kept for retry until the last
    reference to its outputs drops (reference: task_manager.h:208)."""

    __slots__ = ("entry", "kind", "attempts", "last_submit", "lock")

    def __init__(self, entry: dict, kind: str):
        self.entry = entry
        self.kind = kind  # "task" | "actor_task"
        self.attempts = 0
        self.last_submit = time.monotonic()
        self.lock = threading.Lock()


class ClusterRuntime(Runtime):
    def __init__(self, gcs: RpcClient, raylet: RpcClient, store: SharedMemoryStore,
                 node_id: str, driver: bool = True):
        self._gcs = gcs
        self._raylet = raylet
        self._store = store
        self._node_id = node_id
        self._driver = driver
        self._cluster: Optional["Cluster"] = None
        self._worker_id = f"driver-{os.getpid()}" if driver else f"worker-{os.getpid()}"
        self._namespace = "default"
        # This process's `raytpu_*` records carry its node and go to this GCS
        # (a worker names itself again once it knows its raylet-given id).
        from ..observability import postmortem as _postmortem
        from ..observability.flight_recorder import install_crash_hooks
        from ..utils import internal_metrics as imet

        imet.configure(node_id=node_id, reporter=self._worker_id)
        # An unhandled crash of this process dumps its flight ring; the
        # anomalies it sees (a collective's timeout) go to the GCS's bus.
        install_crash_hooks("driver" if driver else "worker")
        self._trigger_forward = _postmortem.arm_client(gcs)
        self._blobs = _FunctionBlobs()
        self._actor_location: Dict[str, str] = {}  # actor_id -> raylet sock
        self._raylet_clients: Dict[str, RpcClient] = {}
        self._actor_batcher = _ActorCreateBatcher(gcs)
        self._shutdown_done = False
        # Owner-side reference counting and task records (reference:
        # reference_count.h:64, task_manager.h:208).
        self._ref_lock = threading.Lock()
        self._local_refs: Dict[str, int] = {}
        self._owned: set = set()
        self._records: Dict[str, _TaskRecord] = {}
        self._pending_free: List[str] = []
        self._borrow_buf: Dict[str, int] = {}
        # Oids whose refs were serialized out of this process: their frees
        # take the GCS borrow-grace path; the rest free eagerly.
        self._escaped: set = set()
        self._dropped_records: List[_TaskRecord] = []
        self._deferred_drops: "collections.deque[ObjectID]" = collections.deque()
        self._free_wake = threading.Event()
        threading.Thread(target=self._free_loop, daemon=True, name="free").start()
        # Submission coalescing: bursts of .remote() calls drain into one
        # submit_task_batch message.
        self._submit_lock = threading.Lock()
        self._submit_buf: List[dict] = []
        self._submit_wake = threading.Event()
        threading.Thread(target=self._submit_loop, daemon=True, name="submit").start()
        from .fastpath import FastPath

        self._fastpath = FastPath(self)
        self._actor_channels: Dict[str, Any] = {}
        self._actor_channels_lock = threading.Lock()
        self._cancelled_tids: set = set()
        # Fast-path completion wakeups and the owner's memory store for
        # small direct results (reference: the CoreWorker in-memory store).
        self._fast_pending: set = set()
        self._fast_seal_cv = threading.Condition()
        self._fast_waiting: set = set()
        self._memstore: Dict[str, bytes] = {}
        self._memstore_bytes = 0
        self._stream_tasks: set = set()
        self._renv_cache: Dict[str, dict] = {}
        # The driver's structured records go to the session's log dir, and
        # its workers' captured output comes back over the `logs` channel.
        from ..observability import logs as _logs

        session = None if raylet.path.startswith("tcp://") else os.path.dirname(raylet.path)
        if driver:
            _logs.configure("driver", node_id=node_id,
                            directory=os.path.join(session, "logs") if session else None)
        self._log_printer = _logs.DedupPrinter()
        self._log_recent: List[str] = []  # the last re-printed lines
        if driver and os.environ.get("RAY_TPU_LOG_TO_DRIVER", "1") != "0":
            threading.Thread(target=self._log_subscriber, daemon=True, name="logmon").start()

    def _log_subscriber(self) -> None:
        """Re-prints the workers' captured output with `(name pid=...
        node=...)` prefixes, from the `logs` pubsub channel the raylets'
        log monitors publish on: repeats are deduplicated and the stream
        rate-limited (logs.DedupPrinter)."""
        from ..observability import logs as _logs

        # From the channel's tail: earlier output belongs to earlier drivers.
        # A failed first poll retries, and never falls back to cursor 0,
        # which would replay a long-lived cluster's retained history.
        cursor = None
        while cursor is None and not self._shutdown_done:
            try:
                entries = self._gcs.call("pubsub_poll", "logs", 0, 0.0, timeout=10.0)
                cursor = entries[-1][0] if entries else 0
            except Exception:  # noqa: BLE001 - the GCS is away: try again
                time.sleep(0.5)
        printer = self._log_printer
        failing_since = None
        while not self._shutdown_done:
            try:
                entries = self._gcs.call("pubsub_poll", "logs", cursor, 1.0, timeout=11.0)
                failing_since = None
            except Exception:  # noqa: BLE001 - the GCS is away or restarting
                # A GCS gone for a minute is a cluster shut down under a
                # runtime nobody shut down: the thread ends.
                failing_since = failing_since or time.monotonic()
                if time.monotonic() - failing_since > 60.0:
                    return
                time.sleep(0.5)
                continue
            for seq, msg in entries:
                cursor = max(cursor, seq)
                if self._shutdown_done:
                    return  # nothing is printed once shutdown() began
                if not isinstance(msg, dict):
                    continue
                prefix = _logs.capture_prefix(msg)
                for line in msg.get("lines") or ():
                    printer.emit(prefix, line)
                    self._log_recent.append(f"{prefix} {line}")
                if len(self._log_recent) > 1000:
                    del self._log_recent[:-500]
            printer.flush()

    # ------------------------------------------------------ construction
    @classmethod
    def create(cls, num_cpus: Optional[float] = None, num_gpus: Optional[float] = None,
               resources: Optional[Dict[str, float]] = None, namespace: Optional[str] = None,
               object_store_memory: Optional[int] = None,
               num_workers: int = 0) -> "ClusterRuntime":
        """Starts a head on this machine (a GCS and one raylet) and returns
        the driver's runtime on it."""
        rt = Cluster(num_cpus=num_cpus, num_gpus=num_gpus, resources=resources,
                     object_store_memory=object_store_memory,
                     num_workers=num_workers).runtime()
        if namespace:
            rt._namespace = namespace
        return rt

    @classmethod
    def connect(cls, session_dir: str) -> "ClusterRuntime":
        """Attaches a driver to a running head on this machine through its
        session dir's session.json. The head's process keeps the cluster:
        this runtime's shutdown() closes only its own connections."""
        with open(os.path.join(session_dir, "session.json")) as f:
            info = json.load(f)
        return cls.attach(gcs_sock=info["gcs_sock"], raylet_sock=info["head_raylet_sock"],
                          store_path=info["head_store"], node_id=info["head_node_id"])

    @classmethod
    def attach(cls, gcs_sock: str, raylet_sock: str, store_path: str, node_id: str,
               driver: bool = True) -> "ClusterRuntime":
        return cls(RpcClient(gcs_sock), RpcClient(raylet_sock), SharedMemoryStore(store_path),
                   node_id, driver=driver)

    # ----------------------------------------------------- fast-path acks
    def _fast_register(self, entry: dict) -> None:
        with self._fast_seal_cv:
            self._fast_pending.update(entry["return_ids"])

    def _fast_sealed(self, sealed: List[str], inline: Optional[dict] = None) -> None:
        """Completion ack from a direct worker: inline results go to the
        owner's memory store (or to shm when a ref escaped), and local
        waiters wake."""
        if inline:
            for h, blob in inline.items():
                to_shm = False
                with self._ref_lock:
                    if not (h in self._owned or h[:24] in self._stream_tasks):
                        continue  # every ref dropped while in flight
                    if h in self._escaped or self._memstore_bytes + len(blob) > 256 << 20:
                        to_shm = True
                    else:
                        self._memstore[h] = blob
                        self._memstore_bytes += len(blob)
                if to_shm:
                    try:
                        self._store.put_raw(ObjectID.from_hex(h), blob)
                        self._raylet.notify("notify_object", h)
                    except Exception:  # noqa: BLE001 - last resort: gets still work here
                        self._memstore[h] = blob
                        self._memstore_bytes += len(blob)
        with self._fast_seal_cv:
            self._fast_pending.difference_update(sealed)
            if inline:
                self._fast_pending.difference_update(inline.keys())
            waiting = self._fast_waiting
            if waiting and (any(h in waiting for h in sealed)
                            or (inline and any(h in waiting for h in inline))):
                self._fast_seal_cv.notify_all()

    # ------------------------------------------------------- references
    def add_local_ref(self, object_id: ObjectID) -> None:
        h = object_id.hex()
        borrowed = False
        with self._ref_lock:
            c = self._local_refs.get(h, 0)
            self._local_refs[h] = c + 1
            if c == 0 and h not in self._owned:
                self._borrow_buf[h] = self._borrow_buf.get(h, 0) + 1
                borrowed = True
        if borrowed:
            self._free_wake.set()

    def mark_escaped(self, object_id: ObjectID) -> None:
        """A ref left this process: an inline result moves to shm so the
        borrower can read it."""
        h = object_id.hex()
        with self._ref_lock:
            self._escaped.add(h)
            blob = self._memstore.get(h)
        if blob is None:
            return
        try:
            try:
                self._store.put_raw(object_id, blob)
            except exc.ObjectStoreFullError:
                self._raylet.call("ensure_space", len(blob))
                self._store.put_raw(object_id, blob)
        except Exception:  # noqa: BLE001 - keep it in memory; local gets still work
            return
        self._raylet.notify("notify_object", h)
        with self._ref_lock:
            if self._memstore.pop(h, None) is not None:
                self._memstore_bytes -= len(blob)

    def remove_local_ref(self, object_id: ObjectID) -> None:
        # ObjectRef.__del__ calls this, and a garbage collection can run it on
        # a thread that already holds _ref_lock (the JAX copy deadlocks there,
        # ROADMAP Queue 3): while the lock is taken, the drop waits in a queue
        # that the free loop drains. The try/finally below releases it.
        if not self._ref_lock.acquire(blocking=False):  # lint: disable=lock-discipline
            self._deferred_drops.append(object_id)
            self._free_wake.set()
            return
        try:
            freed, eager = self._drop_ref_locked(object_id.hex())
        finally:
            self._ref_lock.release()
        if eager is not None and not self._shutdown_done:
            try:
                self._store.delete(ObjectID.from_hex(eager))
            except Exception:  # lint: swallow-ok(pinned readers; async GCS free path retries)
                pass
        if freed:
            self._free_wake.set()

    def _drop_ref_locked(self, h: str):
        """One reference to `h` dropped (caller holds _ref_lock). Returns
        (whether the last one went, the oid to delete from the local pool now:
        an owned object no other process can have borrowed)."""
        c = self._local_refs.get(h, 0) - 1
        if c > 0:
            self._local_refs[h] = c
            return False, None
        self._local_refs.pop(h, None)
        if h not in self._owned:
            self._borrow_buf[h] = self._borrow_buf.get(h, 0) - 1
            self._escaped.discard(h)
            return True, None
        self._owned.discard(h)
        rec = self._records.pop(h, None)
        if rec is not None and rec.entry.get("deps") and not any(
                self._records.get(r) is rec for r in rec.entry["return_ids"]):
            self._dropped_records.append(rec)  # its argument pins go once it finished
        mem_blob = self._memstore.pop(h, None)
        if mem_blob is not None:
            self._memstore_bytes -= len(mem_blob)
        eager = None
        if mem_blob is None or h in self._escaped:
            if h not in self._escaped:
                eager = h
            self._escaped.discard(h)
            self._pending_free.append(h)
        return True, eager

    def _release_dropped_records(self) -> None:
        """Releases the argument pins of tasks whose every output ref was
        dropped, once the task is over (its state terminal in the GCS, or
        unknown for long enough): a fire-and-forget task must still find its
        arguments when it runs."""
        with self._ref_lock:
            pending, self._dropped_records = self._dropped_records, []
        if not pending:
            return
        try:
            states = self._gcs.call("get_task_states", [r.entry["task_id"] for r in pending])
        except Exception:  # noqa: BLE001 - GCS hiccup: retried next round
            with self._ref_lock:
                self._dropped_records.extend(pending)
            return
        keep, now = [], time.monotonic()
        for rec in pending:
            st = states.get(rec.entry["task_id"])
            if (st is not None and st["state"] in ("FINISHED", "FAILED")) or (
                    st is None and now - rec.last_submit > 2 * config.HEARTBEAT_TIMEOUT_S):
                for dep in rec.entry["deps"]:
                    self.remove_local_ref(ObjectID.from_hex(dep))
            else:
                keep.append(rec)
        if keep:
            with self._ref_lock:
                self._dropped_records.extend(keep)

    def _free_loop(self) -> None:
        """Batches owner releases and borrow deltas into one RPC each."""
        while not self._shutdown_done:
            self._free_wake.wait(timeout=0.5)
            self._free_wake.clear()
            time.sleep(0.02)  # coalesce a burst of drops
            if self._shutdown_done:
                return
            for _ in range(len(self._deferred_drops)):
                self.remove_local_ref(self._deferred_drops.popleft())
            self._release_dropped_records()
            self.flush_local_frees()

    def flush_local_frees(self) -> None:
        """Pushes this owner's pending borrow deltas (first) and frees to the
        GCS now (also called under pool pressure)."""
        with self._ref_lock:
            batch, self._pending_free = self._pending_free, []
            borrows, self._borrow_buf = self._borrow_buf, {}
        borrows = {h: d for h, d in borrows.items() if d != 0}
        if borrows:
            try:
                self._gcs.call("update_borrows", borrows)
            except Exception:  # noqa: BLE001 - GCS hiccup: retried next round
                with self._ref_lock:
                    for h, d in borrows.items():
                        self._borrow_buf[h] = self._borrow_buf.get(h, 0) + d
        if batch:
            try:
                self._gcs.call("free_objects", batch)
            except Exception:  # noqa: BLE001 - GCS hiccup: retried next round
                with self._ref_lock:
                    self._pending_free = batch + self._pending_free

    def _record_submission(self, entry: dict, kind: str) -> None:
        rec = _TaskRecord(entry, kind)
        with self._ref_lock:
            for h in entry["return_ids"]:
                self._records[h] = rec
                self._owned.add(h)
            for dep in entry.get("deps", []):
                self._local_refs[dep] = self._local_refs.get(dep, 0) + 1

    # ------------------------------------------------------------ objects
    def put(self, value: Any) -> ObjectID:
        oid = TaskID.for_task().object_id_for_return(0)
        self._store.put_with_pressure(oid, value, self._raylet,
                                      pre_pressure=self.flush_local_frees)
        with self._ref_lock:
            self._owned.add(oid.hex())
        self._raylet.notify("notify_object", oid.hex())
        return oid

    def _get_one(self, oid: ObjectID, deadline: Optional[float]) -> Any:
        h = oid.hex()
        fast_until: Optional[float] = None
        while True:
            blob = self._memstore.get(h)
            if blob is not None:
                value = serialization.unpack(blob)
                if isinstance(value, StoredError):
                    raise value.error
                return value
            if self._store.contains(oid):
                value = self._store.get(oid, timeout=5.0)
                if isinstance(value, StoredError):
                    raise value.error
                return value
            remaining = None if deadline is None else deadline - time.monotonic()
            if remaining is not None and remaining <= 0:
                raise exc.GetTimeoutError(f"get() timed out for {h[:12]}")
            if h in self._fast_pending:
                now = time.monotonic()
                if fast_until is None:
                    fast_until = now + 5.0
                if now < fast_until:
                    with self._fast_seal_cv:
                        if h in self._fast_pending:
                            self._fast_waiting.add(h)
                            try:
                                self._fast_seal_cv.wait(timeout=0.05)
                            finally:
                                self._fast_waiting.discard(h)
                    continue
            fast_until = None
            if h in self._memstore or self._store.contains(oid):
                continue  # an ack landed between the checks above
            poll = config.OBJECT_WAIT_POLL_S
            if remaining is not None:
                poll = max(0.05, min(poll, remaining))
            if self._raylet.call("wait_objects", [h], 1, poll, True, timeout=poll + 10.0):
                continue
            self._maybe_recover(oid)

    def get(self, object_ids: Sequence[ObjectID], timeout: Optional[float] = None) -> List[Any]:
        deadline = None if timeout is None else time.monotonic() + timeout
        return [self._get_one(oid, deadline) for oid in object_ids]

    def wait(self, object_ids, num_returns, timeout):
        deadline = None if timeout is None else time.monotonic() + timeout
        ids = list(object_ids)
        hexes = [oid.hex() for oid in ids]

        def local_ready() -> set:
            return {h for h in hexes if h in self._memstore
                    or self._store.contains(ObjectID.from_hex(h))}

        while True:
            ready_h = local_ready()
            if len(ready_h) >= num_returns:
                break
            if any(h in self._fast_pending for h in hexes):
                pending = [h for h in hexes if h in self._fast_pending]
                with self._fast_seal_cv:
                    self._fast_waiting.update(pending)
                    try:
                        self._fast_seal_cv.wait(timeout=0.05)
                    finally:
                        self._fast_waiting.difference_update(pending)
                if deadline is not None and time.monotonic() >= deadline:
                    ready_h = local_ready()
                    break
                continue
            remaining = None if deadline is None else deadline - time.monotonic()
            poll = config.OBJECT_WAIT_POLL_S
            if remaining is not None:
                poll = max(0.0, min(poll, remaining))
            mem = {h for h in hexes if h in self._memstore}
            ready_h = mem | set(self._raylet.call(
                "wait_objects", [h for h in hexes if h not in mem],
                max(0, num_returns - len(mem)), poll, False, timeout=poll + 10.0))
            if len(ready_h) >= num_returns or (deadline is not None
                                               and time.monotonic() >= deadline):
                break
            for oid in ids:
                if oid.hex() not in ready_h:
                    try:
                        self._maybe_recover(oid, store_errors=True)
                    except Exception as e:  # noqa: BLE001 - a nudge only
                        _log.debug("recovery nudge for %s failed: %r", oid.hex()[:8], e)
        ready_idx = [i for i, h in enumerate(hexes) if h in ready_h][:num_returns]
        ready_set = set(ready_idx)
        return ready_idx, [i for i in range(len(ids)) if i not in ready_set]

    def _maybe_recover(self, oid: ObjectID, store_errors: bool = False) -> None:
        """Owner-side retry decision for an object that has not appeared
        (reference: object_recovery_manager.h:41 + task_manager.h retries):
        raises (or stores an error object) only when it is unrecoverable."""
        h = oid.hex()
        rec = self._records.get(h)
        if rec is None or rec.kind != "task":
            return  # a put, a borrow, or an actor output (the raylet reports those)
        with rec.lock:
            if time.monotonic() - rec.last_submit < config.HEARTBEAT_TIMEOUT_S:
                return
            tid = rec.entry["task_id"]
            st = self._gcs.call("get_task_states", [tid]).get(tid)
            state = st["state"] if st else None
            if state in ("QUEUED", "RUNNING"):
                rec.last_submit = time.monotonic()
                return
            if self._gcs.call("get_object_locations", h):
                return  # exists somewhere; a pull is in progress
            mr = rec.entry.get("max_retries", 0)
            budget = float("inf") if mr < 0 else max(1, mr)
            if mr == 0 and state != "FINISHED":
                budget = 0
            if rec.attempts >= budget:
                err = exc.ObjectLostError(h)
                if store_errors:
                    self._store_error_object(rec.entry, err)
                    return
                raise err
            rec.attempts += 1
            rec.last_submit = time.monotonic()
            entry = dict(rec.entry, attempt=rec.attempts)
        # Rebuild lost dependencies first (lineage two or more deep), with
        # their throttle lifted: the resubmitted task would wait on them.
        for dep in entry.get("deps", []):
            dep_oid = ObjectID.from_hex(dep)
            if self._store.contains(dep_oid) or self._gcs.call("get_object_locations", dep):
                continue
            dep_rec = self._records.get(dep)
            if dep_rec is not None:
                with dep_rec.lock:
                    dep_rec.last_submit = 0.0
                self._maybe_recover(dep_oid, store_errors=store_errors)
        self._submit_entry(entry)

    def _store_error_object(self, entry: dict, err: BaseException) -> None:
        for rid in entry["return_ids"]:
            try:
                self._store.put_with_pressure(
                    ObjectID.from_hex(rid), StoredError(err, entry.get("desc", "")),
                    self._raylet, deadline_s=5.0, pre_pressure=self.flush_local_frees)
                self._raylet.notify("notify_object", rid)
            except Exception as e:  # noqa: BLE001
                _log.warning("failed to store error object: %r", e)

    def object_future(self, object_id: ObjectID) -> concurrent.futures.Future:
        fut: concurrent.futures.Future = concurrent.futures.Future()

        def poll():
            try:
                fut.set_result(self._get_one(object_id, None))
            except BaseException as e:  # noqa: BLE001 - delivered through the future
                fut.set_exception(e)

        threading.Thread(target=poll, daemon=True).start()
        return fut

    # -------------------------------------------------------- submission
    def _fastpath_failed(self, entries: List[dict]) -> None:
        """A leased worker died with these tasks outstanding: retry them on
        the raylet path or store the failure (reference: task_manager.h retry
        on worker death)."""
        for entry in entries:
            entry.pop("_fast", None)
            if entry.get("task_id") in self._cancelled_tids:
                self._cancelled_tids.discard(entry["task_id"])
                self._store_error_object(entry, exc.TaskCancelledError(
                    f"{entry.get('desc', 'task')} was cancelled"))
            elif entry.get("max_retries", 0) < 0 or entry.get("attempt", 0) < entry.get(
                    "max_retries", 0):
                entry = dict(entry, attempt=entry.get("attempt", 0) + 1)
                rec = self._records.get((entry.get("return_ids") or [None])[0])
                if rec is not None:
                    rec.attempts = entry["attempt"]
                    rec.last_submit = time.monotonic()
                self._submit_entry_slow(entry)
            else:
                self._store_error_object(entry, exc.WorkerCrashedError(
                    f"worker died executing {entry.get('desc', 'task')}"))
            self._fast_sealed(entry["return_ids"])

    def _actor_fast_failed(self, actor_hex: str, entries: List[dict]) -> None:
        """In-flight direct actor calls when the actor's worker died."""
        err = exc.ActorDiedError(actor_hex, "worker process exited")
        for entry in entries:
            self._store_error_object(entry, err)
            self._fast_sealed(entry["return_ids"])

    def _submit_entry(self, entry: dict) -> None:
        if not entry.get("pg_id") and self._fastpath.try_submit(entry):
            return
        self._submit_entry_slow(entry)

    def _submit_entry_slow(self, entry: dict) -> None:
        if entry.get("pg_id"):
            target = self._gcs.call("pick_bundle", entry["pg_id"], entry["bundle_index"])
            if target is None:
                self._store_error_object(entry, exc.PlacementGroupError(
                    f"placement group {entry['pg_id'][:8]} bundle {entry['bundle_index']} "
                    "is not schedulable (removed?)"))
                return
            entry = dict(entry, bundle_index=target["bundle_index"])
            self._raylet_for(target["sock"]).notify("submit_task", pickle.dumps(entry))
            return
        with self._submit_lock:
            self._submit_buf.append(entry)
        self._submit_wake.set()

    def _submit_loop(self) -> None:
        while not self._shutdown_done:
            self._submit_wake.wait(timeout=0.5)
            self._submit_wake.clear()
            self._drain_submit_buf()

    def _drain_submit_buf(self) -> None:
        while True:
            with self._submit_lock:
                batch, self._submit_buf = self._submit_buf, []
            if not batch:
                return
            try:
                if len(batch) == 1:
                    self._raylet.notify("submit_task", pickle.dumps(batch[0]))
                else:
                    self._raylet.notify("submit_task_batch", pickle.dumps(batch))
            except Exception as e:  # noqa: BLE001 - stored for the callers' gets
                for entry in batch:
                    self._store_error_object(entry, e)

    def stream_next(self, task_id, index: int, timeout: Optional[float] = None):
        """Next item oid of a streaming task, or None at the end."""
        from .object_ref import STREAM_COUNT_KEY

        header_oid = task_id.object_id_for_return(0)
        item_oid = task_id.object_id_for_return(index + 1)
        h_item, h_header = item_oid.hex(), header_oid.hex()
        deadline = None if timeout is None else time.monotonic() + timeout
        last_remote_check = 0.0
        header_seen = False
        while True:
            if h_item in self._memstore or self._store.contains(item_oid):
                self._adopt_stream_item(h_item)
                return item_oid
            if h_header in self._memstore or self._store.contains(header_oid):
                hdr = self._get_one(header_oid, None)
                if index >= hdr.get(STREAM_COUNT_KEY, 0):
                    return None
                header_seen = True
            if deadline is not None and time.monotonic() >= deadline:
                raise exc.GetTimeoutError(f"stream item {index} of {task_id.hex()[:12]} timed out")
            now = time.monotonic()
            if now - last_remote_check > 2.0:
                last_remote_check = now
                # The raylet pulls in an item made on another node. Once the
                # header is here the wait is for the item alone: a header
                # already local satisfies a wait for either, which would
                # return before the item's pull starts (the JAX copy's
                # in-cluster stream then blocks from its second remote item).
                want = [h_item] if header_seen else [h_item, h_header]
                try:
                    self._raylet.call("wait_objects", want, 1, 0.2, True, timeout=10.0)
                except Exception:  # lint: swallow-ok(advisory wait; the loop checks again)
                    pass
                continue
            with self._fast_seal_cv:
                self._fast_seal_cv.wait(timeout=0.05)

    def _adopt_stream_item(self, h: str) -> None:
        """First sight of a stream item the task made: this process owns it,
        and one outside its memstore lives in a store (escaped)."""
        with self._ref_lock:
            if h not in self._owned:
                self._owned.add(h)
                if h not in self._memstore:
                    self._escaped.add(h)

    def stream_done(self, task_id) -> None:
        prefix = task_id.hex()[:24]
        with self._fast_seal_cv:
            self._stream_tasks.discard(prefix)

    def _process_renv(self, spec: TaskSpec) -> None:
        """Driver-side runtime-env normalisation: local working_dir and
        py_modules directories become content-addressed GCS packages,
        cached per env, so a task loop zips once and not per call."""
        renv = spec.options.runtime_env
        if not renv:
            return
        key = json.dumps(renv, sort_keys=True, default=str)
        cached = self._renv_cache.get(key)
        if cached is None:
            from .runtime_env import process_runtime_env

            cached = self._renv_cache[key] = process_runtime_env(renv, self._gcs)
        spec.options.runtime_env = cached

    def submit_task(self, spec: TaskSpec) -> List[ObjectID]:
        self._process_renv(spec)
        entry = _entry_from_spec(spec, self._blobs)
        spec.return_ids = [ObjectID.from_hex(h) for h in entry["return_ids"]]
        if entry["streaming"]:
            with self._fast_seal_cv:
                self._stream_tasks.add(spec.task_id.hex()[:24])
        self._record_submission(entry, "task")
        with _submit_span(entry):
            self._submit_entry(entry)
        return spec.return_ids

    def create_actor(self, spec: TaskSpec) -> ActorID:
        actor_id = spec.actor_id or ActorID.from_random()
        spec.actor_id = actor_id
        self._process_renv(spec)
        # The launch's trace: the raylet's worker_spawn and the worker's
        # constructor parent to this span through the entry's trace_ctx.
        with _tracing.maybe_span("actor_launch", {"actor_id": actor_id.hex()}):
            entry = _entry_from_spec(spec, self._blobs)
            with self._ref_lock:
                for dep in entry.get("deps", []):
                    self._local_refs[dep] = self._local_refs.get(dep, 0) + 1
            entry["actor_id"] = actor_id.hex()
            with _tracing.maybe_span("actor_launch.gcs_register",
                                     {"flow_out": (entry.get("trace_ctx") or {}).get("flow")}):
                node = self._actor_batcher.create({
                    "actor_id": actor_id.hex(),
                    "spec_blob": pickle.dumps(entry),
                    "resources": entry["resources"]
                    or ({"CPU": 1.0} if spec.options.actor_placement_bias else {}),
                    "max_restarts": spec.options.max_restarts,
                    "name": spec.options.name,
                    "namespace": spec.options.namespace,
                    "pg_id": spec.options.placement_group_id,
                    "bundle_index": spec.options.bundle_index,
                    "strategy": spec.options.scheduling_strategy,
                })
        self._actor_location[actor_id.hex()] = node["sock"]
        return actor_id

    def _raylet_for(self, sock: str) -> RpcClient:
        if sock == self._raylet.path:
            return self._raylet
        cli = self._raylet_clients.get(sock)
        if cli is None:
            cli = self._raylet_clients[sock] = RpcClient(sock, connect_timeout=5.0)
        return cli

    def _actor_raylet(self, actor_id: ActorID) -> RpcClient:
        sock = self._actor_location.get(actor_id.hex())
        if sock is None:
            info = self._gcs.call("get_actor", actor_id.hex())
            if info is None or info.get("sock") is None:
                raise exc.ActorDiedError(actor_id.hex(),
                                         (info or {}).get("death_reason", "unknown actor"))
            sock = self._actor_location[actor_id.hex()] = info["sock"]
        return self._raylet_for(sock)

    def submit_actor_task(self, spec: TaskSpec) -> List[ObjectID]:
        entry = _entry_from_spec(spec, self._blobs)
        spec.return_ids = [ObjectID.from_hex(h) for h in entry["return_ids"]]
        if entry["streaming"]:
            with self._fast_seal_cv:
                self._stream_tasks.add(spec.task_id.hex()[:24])
        self._record_submission(entry, "actor_task")
        with _submit_span(entry):
            self._actor_channel(spec.actor_id.hex()).submit(entry)
        return spec.return_ids

    def _actor_channel(self, actor_hex: str):
        with self._actor_channels_lock:
            ch = self._actor_channels.get(actor_hex)
            if ch is None:
                from .fastpath import ActorChannel

                ch = self._actor_channels[actor_hex] = ActorChannel(self, actor_hex)
            return ch

    def _submit_actor_slow(self, entry: dict) -> None:
        """Raylet-mediated actor submission (the fast path disabled)."""
        actor_id = ActorID.from_hex(entry["actor_id"])
        try:
            self._actor_raylet(actor_id).call("submit_actor_task", pickle.dumps(entry))
        except exc.ActorDiedError:
            raise
        except Exception:  # noqa: BLE001 - the actor moved: resolve it again
            self._actor_location.pop(entry["actor_id"], None)
            self._actor_raylet(actor_id).call("submit_actor_task", pickle.dumps(entry))

    def cancel(self, object_id: ObjectID, force: bool = False) -> None:
        """Cancels the task producing `object_id` (reference: ray.cancel ->
        CoreWorker::CancelTask)."""
        rec = self._records.get(object_id.hex())
        if rec is None or rec.kind != "task":
            raise ValueError("cancel() requires the ObjectRef of a submitted (non-actor) task")
        tid = rec.entry["task_id"]
        rec.entry["max_retries"] = 0  # a cancelled task is not retried
        if rec.entry.get("_fast"):
            self._cancelled_tids.add(tid)
            try:
                self._raylet.call("cancel_lease_task", rec.entry["_fast"], tid, force)
            except Exception as e:  # noqa: BLE001 - the lease's EOF still fails the task
                _log.debug("cancel_lease_task for %s failed: %r", tid[:8], e)
            return
        # Task events reach the GCS in batches: wait up to 1 s for the node
        # that holds the task, and only if it stays unknown ask every raylet.
        sock = None
        deadline = time.monotonic() + 1.0
        while True:
            st = self._gcs.call("get_task_states", [tid]).get(tid)
            if st is not None and st.get("node"):
                node = self._gcs.call("node_info", st["node"])
                if node is not None and node.get("alive"):
                    sock = node["sock"]
                break
            if time.monotonic() > deadline:
                break
            time.sleep(0.05)
        if sock is not None:
            self._raylet_for(sock).call("cancel_task", tid, force)
            return
        for n in self._gcs.call("list_nodes"):
            if n.get("Alive"):
                try:
                    self._raylet_for(n["sock"]).call("cancel_task", tid, force)
                except Exception:
                    pass  # lint: swallow-ok(node may be dead; cancel is best-effort per node)

    def kill_actor(self, actor_id: ActorID, no_restart: bool = True) -> None:
        try:
            self._actor_raylet(actor_id).call("kill_actor", actor_id.hex(), no_restart)
        except exc.ActorDiedError:
            pass
        self._actor_location.pop(actor_id.hex(), None)

    def get_named_actor(self, name: str, namespace: Optional[str]) -> ActorID:
        aid = self._gcs.call("lookup_named_actor", name, namespace or self._namespace)
        if aid is None:
            raise ValueError(f"Failed to look up actor with name {name!r}")
        return ActorID.from_hex(aid)

    def cluster_resources(self) -> Dict[str, float]:
        return self._gcs.call("cluster_resources")

    def available_resources(self) -> Dict[str, float]:
        return self._gcs.call("available_resources")

    def nodes(self) -> List[dict]:
        return self._gcs.call("list_nodes")

    def node_id(self) -> str:
        return self._node_id

    def is_driver(self) -> bool:
        return self._driver

    # --------------------------------------------------- placement groups
    def create_placement_group(self, bundles, strategy, name=""):
        from .placement_group import PlacementGroupHandle

        pg_id = uuid.uuid4().hex
        try:
            result = self._gcs.call("create_placement_group", pg_id, bundles, strategy)
        except exc.PlacementGroupError:
            self._gcs.call("register_pending_placement_group", pg_id, bundles, strategy)
            result = {"placements": []}
        handle = PlacementGroupHandle(pg_id, bundles, strategy, name)
        handle.bundle_placements = dict(enumerate(result["placements"]))
        return handle

    def remove_placement_group(self, pg_id) -> None:
        self._gcs.call("remove_placement_group", pg_id)

    def placement_group_ready(self, pg_id, timeout=None) -> bool:
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            info = self._gcs.call("get_placement_group", pg_id)
            if info is not None and info.get("state") == "CREATED":
                return True
            if info is not None and info.get("state") == "PENDING":
                if self._gcs.call("retry_pending_placement_group", pg_id):
                    return True
            if deadline is None or time.monotonic() >= deadline:
                return False
            time.sleep(0.25)

    def placement_group_table(self) -> Dict[str, dict]:
        return self._gcs.call("placement_group_table")

    # --------------------------------------------------------- lifecycle
    def shutdown(self) -> None:
        if self._shutdown_done:
            return
        self._shutdown_done = True
        from ..observability import postmortem as _postmortem

        _postmortem.disarm(self._trigger_forward)
        self._free_wake.set()
        self._submit_wake.set()
        self._fastpath.close()
        with self._actor_channels_lock:
            channels = list(self._actor_channels.values())
        for ch in channels:
            ch.close()
        if self._cluster is not None:
            self._cluster.shutdown()
        self._store.close()
        self._gcs.close()
        self._raylet.close()
        for cli in self._raylet_clients.values():
            cli.close()


# ------------------------------------------------------------------ sessions


def session_pointer_path() -> str:
    """The file in which the port's CLI records the session it started last
    (read at each call, so a changed HOME is honoured). The JAX package's
    CLI keeps its own (~/.ray_tpu/latest_session): the port's CLI never
    attaches to a JAX head."""
    return os.path.expanduser("~/.ray_tpu_torch/latest_session")


def resolve_address(address: str) -> str:
    """What `init(address=)` attaches to: a tcp:// head as it is; "auto" the
    session recorded in session_pointer_path(), else $RAY_TPU_ADDRESS; any
    other value must be a session dir that holds a session.json."""
    if address == "auto":
        try:
            with open(session_pointer_path()) as f:
                address = f.read().strip()
        except OSError:
            address = os.environ.get("RAY_TPU_ADDRESS", "")
        if not address or address == "auto":
            raise ConnectionError(
                f"address='auto' found no session: {session_pointer_path()} is missing "
                "and RAY_TPU_ADDRESS is unset (start one with `python -m "
                "ray_tpu_torch.scripts start`)")
    if address.startswith("tcp://"):
        return address
    if not os.path.isfile(os.path.join(address, "session.json")):
        raise ValueError(f"address must be tcp://host:port (a head's GCS), a session dir "
                         f"holding a session.json, or 'auto'; got {address!r}")
    return address


def _node_processes(session_dir: str, node_id: str) -> List[int]:
    """pids of one node's processes on this machine: its raylet and Popen'd
    workers name the raylet's socket on their command line, its zygote and
    the workers forked from it (which keep the zygote's command line) the
    zygote's socket."""
    marks = [os.path.join(session_dir, f"raylet_{node_id}.sock").encode(),
             os.path.join(session_dir, f"zyg_{node_id[:8]}.sock").encode()]
    out = []
    for entry in os.listdir("/proc"):
        if not entry.isdigit() or int(entry) == os.getpid():
            continue
        try:
            with open(f"/proc/{entry}/cmdline", "rb") as f:
                cmd = f.read()
        except OSError:
            continue
        if any(m in cmd for m in marks):
            out.append(int(entry))
    return out


def _running(pid: int) -> bool:
    """Whether `pid` exists and has not exited (a zombie holds no memory)."""
    try:
        with open(f"/proc/{pid}/stat", "rb") as f:
            return f.read().rsplit(b")", 1)[1].split()[0] != b"Z"
    except (OSError, IndexError):
        return False


def _spawn_daemon(log_dir: str, cmd: List[str], name: str,
                  env_extra: Optional[Dict[str, str]] = None) -> subprocess.Popen:
    """Spawns a daemon with stdout/stderr captured under `log_dir`, from the
    directory that holds this package (so that `python -m ray_tpu_torch...`
    finds it whatever the caller's cwd), with this process's environment
    and `env_extra` over it."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = {**os.environ, **(env_extra or {})}
    env["PYTHONPATH"] = root + (os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    with open(os.path.join(log_dir, f"{name}.out"), "ab", buffering=0) as out, \
            open(os.path.join(log_dir, f"{name}.err"), "ab", buffering=0) as err:
        return subprocess.Popen(cmd, stdout=out, stderr=err, env=env)


def _read_announced(path: str, prefix: str, timeout: float = 20.0) -> str:
    """The value of a KEY=value line a daemon printed to its log: an
    ephemeral port is known only after its bind."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            with open(path) as f:
                for line in f:
                    if line.startswith(prefix):
                        return line[len(prefix):].strip()
        except OSError:
            pass
        time.sleep(0.05)
    raise RuntimeError(f"the daemon never announced {prefix} in {path}")


def _lock_path(session_base: str) -> str:
    return f"/dev/shm/{POOL_PREFIX}{session_base}.lock"


def _hold_session_lock(path: str) -> int:
    """Creates the session's lock file and holds its exclusive flock. A sweep
    that took the lock between our open and flock has unlinked the file: then
    the fd holds a lock on a name nobody sees, and we start again."""
    while True:
        fd = os.open(path, os.O_RDWR | os.O_CREAT, 0o600)
        fcntl.flock(fd, fcntl.LOCK_EX)
        try:
            if os.stat(path).st_ino == os.fstat(fd).st_ino:
                return fd
        except FileNotFoundError:
            pass
        os.close(fd)


def sweep_orphaned_pools() -> List[str]:
    """Unlinks the /dev/shm pools (and lock files) of sessions whose driver
    is gone: a SIGKILLed driver runs no cleanup, and tmpfs pages would
    otherwise accumulate. Touches only rtpt_* files, and keeps a pool whose
    session has no lock file. Returns what it removed."""
    sessions: Dict[str, List[str]] = {}
    for path in glob.glob(f"/dev/shm/{POOL_PREFIX}*"):
        if path.endswith(".lock"):
            continue
        base = os.path.basename(path)[len(POOL_PREFIX):].rsplit("_", 1)[0]
        sessions.setdefault(base, []).append(path)
    removed = []
    for base, pools in sessions.items():
        try:
            fd = os.open(_lock_path(base), os.O_RDWR)
        except OSError:
            continue  # no lock file: not a session this sweep can judge
        try:
            fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except OSError:
            os.close(fd)
            continue  # its driver holds the lock: alive
        try:
            for path in pools + [_lock_path(base)]:
                try:
                    os.unlink(path)
                    removed.append(path)
                except OSError:
                    pass
        finally:
            os.close(fd)
    return removed


def _pick_store_path(session_dir: str, node_id: str, capacity: int, claimed: int = 0) -> str:
    """tmpfs when it fits (a disk-backed mmap caps put() at writeback
    speed), else a file in the session dir."""
    if os.path.isdir("/dev/shm"):
        st = os.statvfs("/dev/shm")
        if st.f_bavail * st.f_frsize - claimed > capacity * 1.1:
            return f"/dev/shm/{POOL_PREFIX}{os.path.basename(session_dir)}_{node_id}"
    return os.path.join(session_dir, f"store_{node_id}")


class Cluster:
    """A cluster's head and its nodes on this machine (reference:
    python/ray/cluster_utils.py:135 Cluster, add_node :201, remove_node
    :282): one GCS process, one raylet process per node."""

    def __init__(self, num_cpus: Optional[float] = None, num_gpus: Optional[float] = None,
                 resources: Optional[Dict[str, float]] = None,
                 object_store_memory: Optional[int] = None, num_workers: int = 0,
                 head_port: Optional[int] = None, node_ip: str = "127.0.0.1",
                 labels: Optional[Dict[str, Any]] = None):
        """`num_workers` idle workers are started on the head at boot (the
        raylet's prestart floor); `labels` are the head node's. `head_port` makes a head other hosts can
        join (reference: `ray start --head --port`): the GCS also listens on
        tcp://node_ip:head_port (0: an ephemeral port; `gcs_tcp_address` is
        the bound one), and every raylet serves and advertises a tcp://
        endpoint. TCP needs RAY_TPU_AUTH_TOKEN (core/rpc.py); joiners and
        remote clients must hold the same token."""
        if head_port is not None:
            require_auth_token(f"tcp://{node_ip}:{head_port}")
        sweep_orphaned_pools()
        # The pool library is built here, before any raylet starts its
        # zygote, so no fork races the g++ build.
        shm_pool_lib()
        self.session_dir = tempfile.mkdtemp(prefix=f"{POOL_PREFIX}session_")
        # Liveness: held until shutdown (or this process's death).
        self._lock_file = _lock_path(os.path.basename(self.session_dir))
        self._lock_fd = _hold_session_lock(self._lock_file)
        self.gcs_sock = os.path.join(self.session_dir, "gcs.sock")
        self.log_dir = os.path.join(self.session_dir, "logs")
        os.makedirs(self.log_dir, exist_ok=True)
        self._procs: Dict[str, subprocess.Popen] = {}  # "gcs" or node id -> process
        self._store_paths: Dict[str, str] = {}
        self._shm_claimed = 0
        self._store_capacity = int(object_store_memory or config.OBJECT_STORE_MEMORY)
        self._node_ip = node_ip
        self._tcp_mode = head_port is not None
        self.gcs_tcp_address: Optional[str] = None
        self._down = False
        atexit.register(self.shutdown)
        # The GCS's tables persist here (a snapshot and its write-ahead log):
        # restart_gcs() brings them back.
        self.gcs_snapshot = os.path.join(self.session_dir, "gcs_state.pkl")
        try:
            self._gcs_cmd = [sys.executable, "-m", "ray_tpu_torch.core.gcs", self.gcs_sock,
                             self.gcs_snapshot]
            if self._tcp_mode:
                self._gcs_cmd.append(f"tcp://{node_ip}:{int(head_port)}")
            # The GCS's hot-table shard count (core/gcs_shards.py), fixed for
            # the cluster's life: a restarted GCS gets the same one.
            self.gcs_shards = resolve_shard_count()
            self._gcs_env = {"RAY_TPU_GCS_SHARDS": str(self.gcs_shards)}
            self._procs["gcs"] = _spawn_daemon(self.log_dir, self._gcs_cmd, "gcs",
                                               self._gcs_env)
            self._gcs = RpcClient(self.gcs_sock)
            self._gcs.call("ping")
            if self._tcp_mode:
                self.gcs_tcp_address = _read_announced(
                    os.path.join(self.log_dir, "gcs.out"), "GCS_TCP_ADDRESS=")
                # A restarted GCS must come back on the address joined hosts
                # and remote clients already dial: the port is pinned.
                self._gcs_cmd[-1] = self.gcs_tcp_address
            head_res = dict(resources or {})
            if num_cpus is not None:
                head_res["CPU"] = float(num_cpus)
            head_res.setdefault("CPU", float(os.cpu_count() or 1))
            if num_gpus is None and "GPU" not in head_res:
                from ..accelerators import get_accelerator_manager

                num_gpus = get_accelerator_manager("GPU").get_current_node_num_accelerators()
            if num_gpus:
                head_res["GPU"] = float(num_gpus)
            self.head_node_id = self.add_node(resources=head_res, num_workers=num_workers,
                                              labels=labels)
            info = {
                "gcs_sock": self.gcs_sock,
                "gcs_tcp_address": self.gcs_tcp_address,
                "head_raylet_sock": self._sock_for(self.head_node_id),
                "head_store": self._store_for(self.head_node_id),
                "head_node_id": self.head_node_id,
            }
            with open(os.path.join(self.session_dir, "session.json"), "w") as f:
                json.dump(info, f)
        except BaseException:
            self.shutdown()
            raise

    def restart_gcs(self) -> None:
        """Kills the GCS daemon and starts it again with the same command and
        shard count: its tables come back from the snapshot and every
        segment of the write-ahead log, and
        the raylets' heartbeats find it again (a raylet it lost registers
        anew). Every client (the driver's, the raylets', the workers')
        reconnects on its next call."""
        proc = self._procs.pop("gcs")
        proc.kill()
        proc.wait(timeout=5.0)
        self._procs["gcs"] = _spawn_daemon(self.log_dir, self._gcs_cmd, "gcs", self._gcs_env)
        probe = RpcClient(self.gcs_sock)  # waits out the daemon's boot
        try:
            probe.call("ping")
        finally:
            probe.close()

    def _sock_for(self, node_id: str) -> str:
        return os.path.join(self.session_dir, f"raylet_{node_id}.sock")

    def _store_for(self, node_id: str) -> str:
        path = self._store_paths.get(node_id)
        if path is None:
            path = _pick_store_path(self.session_dir, node_id, self._store_capacity,
                                    self._shm_claimed)
            if path.startswith("/dev/shm/"):
                self._shm_claimed += self._store_capacity
            self._store_paths[node_id] = path
        return path

    def add_node(self, num_cpus: Optional[float] = None,
                 resources: Optional[Dict[str, float]] = None, num_workers: int = 0,
                 num_gpus: Optional[float] = None,
                 labels: Optional[Dict[str, Any]] = None) -> str:
        """Starts a raylet with these resources (CPU 1 unless given) and
        `num_workers` prestarted idle workers. With `num_gpus` the node
        leases that many CUDA device ids ("0".., or the ids this process's
        CUDA_VISIBLE_DEVICES names) and starts each worker with
        CUDA_VISIBLE_DEVICES set to its lease, as the head does; nodes added
        on one machine lease the same ids, so they share its cards. `labels`
        are the node's key/value tags (list_nodes' `Labels`)."""
        node_id = uuid.uuid4().hex[:12]
        res = dict(resources or {})
        if num_cpus is not None:
            res["CPU"] = float(num_cpus)
        if num_gpus is not None:
            res["GPU"] = float(num_gpus)
        res.setdefault("CPU", 1.0)
        cmd = [sys.executable, "-m", "ray_tpu_torch.core.raylet", node_id,
               self._sock_for(node_id), self._store_for(node_id), self.gcs_sock,
               json.dumps(res), str(self._store_capacity), str(int(num_workers)),
               f"tcp://{self._node_ip}:0" if self._tcp_mode else "", json.dumps(labels or {})]
        self._procs[node_id] = _spawn_daemon(self.log_dir, cmd, f"raylet_{node_id}")
        RpcClient(self._sock_for(node_id)).call("ping")
        return node_id

    def remove_node(self, node_id: str) -> None:
        """Simulated node failure (reference: cluster_utils remove_node): the
        node's processes die at once, as a machine's do (the raylet, its
        zygote and every worker; a forked worker would otherwise outlive the
        raylet for up to the zygote's 2 s parent check, holding its CUDA
        context and the card's memory), and the GCS is told."""
        pids = _node_processes(self.session_dir, node_id)
        proc = self._procs.pop(node_id, None)
        if proc is not None:
            proc.kill()
            proc.wait(timeout=5.0)
        for pid in pids:
            try:
                os.kill(pid, signal.SIGKILL)
            except OSError:
                pass
        deadline = time.monotonic() + 5.0
        while any(_running(pid) for pid in pids) and time.monotonic() < deadline:
            time.sleep(0.01)
        self._gcs.call("mark_node_dead", node_id)
        self._unlink_store(node_id)

    def _unlink_store(self, node_id: str) -> None:
        path = self._store_paths.pop(node_id, None)
        if path is not None:
            try:
                os.unlink(path)
            except OSError:
                pass

    def runtime(self) -> ClusterRuntime:
        rt = ClusterRuntime(RpcClient(self.gcs_sock),
                            RpcClient(self._sock_for(self.head_node_id)),
                            SharedMemoryStore(self._store_for(self.head_node_id)),
                            self.head_node_id)
        rt._cluster = self
        return rt

    def shutdown(self) -> None:
        """Stops every raylet (which stops its workers), then the GCS; kills
        what does not exit; unlinks the pools and the session dir."""
        if self._down:
            return
        self._down = True
        nodes = [k for k in self._procs if k != "gcs"]
        threads = []
        for nid in nodes:  # raylets stop their workers in parallel
            def stop(nid=nid):
                try:
                    RpcClient(self._sock_for(nid), connect_timeout=1.0).call("stop", timeout=10.0)
                except Exception:  # lint: swallow-ok(shutdown stop is best-effort; SIGKILL below)
                    pass
            t = threading.Thread(target=stop, daemon=True)
            t.start()
            threads.append(t)
        for t in threads:
            t.join(timeout=12.0)
        gcs = getattr(self, "_gcs", None)
        if gcs is not None:
            try:
                gcs.call("stop", timeout=2.0)
            except Exception:  # lint: swallow-ok(shutdown stop is best-effort; SIGKILL below)
                pass
            gcs.close()
        for p in self._procs.values():
            try:
                p.wait(timeout=3.0)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(timeout=5.0)
        self._procs.clear()
        for node_id in list(self._store_paths):
            self._unlink_store(node_id)
        shutil.rmtree(self.session_dir, ignore_errors=True)
        try:
            os.unlink(self._lock_file)
        except OSError:
            pass
        os.close(self._lock_fd)
        atexit.unregister(self.shutdown)


def start_worker_node(gcs_address: str, node_ip: Optional[str] = None,
                      num_cpus: Optional[float] = None, num_gpus: Optional[float] = None,
                      resources: Optional[Dict[str, float]] = None,
                      object_store_memory: Optional[int] = None,
                      labels: Optional[Dict[str, Any]] = None) -> dict:
    """Starts a raylet on THIS host that joins a head's GCS over TCP
    (reference: `ray start --address=head:port`). The raylet serves its own
    workers over a UDS in a session dir of its own, advertises
    tcp://node_ip:<ephemeral port> to the cluster and holds its own pool.
    node_ip defaults to this host's address on the route to the GCS. The
    caller holds the node's session lock, as a driver holds its cluster's.
    `labels` are the node's key/value tags.
    Returns {node_id, session_dir, sock, proc, shutdown}; `shutdown()` stops
    the raylet (and its workers) and removes the pool and the session dir."""
    import socket

    from .rpc import parse_address

    kind, target = parse_address(gcs_address)
    if kind != "tcp":
        raise ValueError("gcs_address must be tcp://host:port (the head's GCS endpoint)")
    require_auth_token(f"a node joining {gcs_address}")
    if node_ip is None:
        with socket.create_connection(target, timeout=10.0) as probe:
            node_ip = probe.getsockname()[0]
    sweep_orphaned_pools()
    shm_pool_lib()
    session_dir = tempfile.mkdtemp(prefix=f"{POOL_PREFIX}worker_")
    lock_file = _lock_path(os.path.basename(session_dir))
    lock_fd = _hold_session_lock(lock_file)
    log_dir = os.path.join(session_dir, "logs")
    os.makedirs(log_dir, exist_ok=True)
    node_id = uuid.uuid4().hex[:12]
    res = dict(resources or {})
    if num_cpus is not None:
        res["CPU"] = float(num_cpus)
    res.setdefault("CPU", float(os.cpu_count() or 1))
    if num_gpus is None and "GPU" not in res:
        from ..accelerators import get_accelerator_manager

        num_gpus = get_accelerator_manager("GPU").get_current_node_num_accelerators()
    if num_gpus:
        res["GPU"] = float(num_gpus)
    capacity = int(object_store_memory or config.OBJECT_STORE_MEMORY)
    store = _pick_store_path(session_dir, node_id, capacity)
    sock = os.path.join(session_dir, f"raylet_{node_id}.sock")
    proc = _spawn_daemon(log_dir, [sys.executable, "-m", "ray_tpu_torch.core.raylet", node_id,
                                   sock, store, gcs_address, json.dumps(res), str(capacity),
                                   "0", f"tcp://{node_ip}:0", json.dumps(labels or {})],
                         "raylet")
    done = []

    def shutdown() -> None:
        if done:
            return
        done.append(True)
        try:
            RpcClient(sock, connect_timeout=1.0).call("stop", timeout=10.0)
        except Exception:  # lint: swallow-ok(shutdown stop is best-effort; SIGKILL below)
            pass
        try:
            proc.wait(timeout=15.0)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=5.0)
        for path in (store, lock_file):
            try:
                os.unlink(path)
            except OSError:
                pass
        shutil.rmtree(session_dir, ignore_errors=True)
        os.close(lock_fd)
        atexit.unregister(shutdown)

    atexit.register(shutdown)
    try:
        RpcClient(sock).call("ping")
    except BaseException:
        shutdown()
        raise
    return {"node_id": node_id, "session_dir": session_dir, "sock": sock, "proc": proc,
            "shutdown": shutdown}
