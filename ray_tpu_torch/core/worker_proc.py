"""Worker process: long-polls its raylet for tasks and executes them (the
port of ray_tpu/core/worker_proc.py).

Re-design of the reference's worker loop (reference:
python/ray/_private/workers/default_worker.py ->
CoreWorkerProcess::RunTaskExecutionLoop, core_worker_process.h:100; task
execution callback _raylet.pyx:1698 execute_task). The worker owns a full
ClusterRuntime in worker mode, so user tasks can themselves submit tasks,
create actors, and call get/put.

Two ways in: the raylet's mailbox (worker_step long-polls) and the direct
socket that a lease owner or an actor's callers push to (core/fastpath.py).
Actor concurrency (reference: actor_scheduling_queue.h,
concurrency_group_manager.h): an actor with max_concurrency > 1 runs its
methods on a thread pool of that width, one with coroutine methods on a
dedicated asyncio event loop.

The raylet starts this process, forked from its zygote (core/zygote.py) or
else by Popen, with CUDA_VISIBLE_DEVICES naming exactly the devices its task
or actor leased (none for a CPU-only one). A forked worker holds torch
already, imported by the zygote, and creates its CUDA context at its first
use of the device. The worker imports no JAX, so the JAX worker's platform
pin (worker_proc.py:171-180 there) has no counterpart. A worker with a
runtime env finds it resolved in RAY_TPU_RUNTIME_ENV (its env_vars already
in its environment) and applies its working_dir and py_modules at boot. An
actor also answers the collective builtins `__ray_tpu_collective_init__` and
`__ray_tpu_collective_destroy__` (collective.py's create_collective_group
and destroy_collective_group_on).

Observability: `main` binds the flight recorder's crash hooks and its
SIGUSR2 dump first (a forked worker inherits the signal ignored from the
zygote until then), line-buffers stdout and stderr (the raylet's log
monitor tails them), and writes its structured records to
`worker_<id>.jsonl` with user `logging` captured and mirrored to stderr.
Each task, actor method and actor constructor runs in a span re-rooted
under the submitter's `trace_ctx`, on the raylet path and the direct one
alike. The compiled-graph builtins `__ray_dag_setup__`, `_start__` and
`_stop__` host a graph's resident exec loop on a thread of the actor's
process (cgraph/executor.py), so the actor still answers its calls, the
raylet's liveness checks and SIGUSR2 while the loop blocks on a channel.
With RAY_TPU_SAMPLING_PROFILE set the worker samples its own threads
(utils/sampling_profiler.py).
"""

from __future__ import annotations

import inspect
import json
import logging
import os
import pickle
import queue
import signal
import socket as socketlib
import sys
import threading
import time
from typing import Any, Dict, List, Optional

from .. import exceptions as exc
from .. import tracing as _tracing
from ..chaos.controller import kill_now as _chaos_kill
from ..chaos.controller import maybe_inject as _chaos_inject
from . import runtime_base, serialization
from .cluster_runtime import ClusterRuntime
from .ids import ObjectID
from .object_transport import StoredError
from .rpc import RpcClient, _recv_msg, _send_msg
from .shm_store import SharedMemoryStore

INLINE_MAX = 64 * 1024  # results below this ride the completion ack

_log = logging.getLogger("ray_tpu_torch.worker")


def _resolve_args(store, args_blob: bytes, raylet=None):
    from .task_spec import ArgRef

    args, kwargs = serialization.loads(args_blob)

    def fetch(a):
        if isinstance(a, ArgRef):
            try:
                v = store.get(a.object_id, timeout=None)
            except KeyError:
                if raylet is None or not raylet.call("pull_object", a.object_id.hex(), 30.0):
                    raise
                v = store.get(a.object_id, timeout=5.0)
            if isinstance(v, StoredError):
                raise v.error
            return v
        return a

    return tuple(fetch(a) for a in args), {k: fetch(v) for k, v in kwargs.items()}


def _apply_working_dir(runtime_env: dict) -> None:
    """Applies the node-resolved runtime env: the working dir becomes the
    cwd and an import path, and py_modules go on sys.path (reference:
    working_dir.py chdir, py_modules.py sys.path entries; the raylet
    extracted any package before the spawn)."""
    wd = (runtime_env or {}).get("working_dir")
    if wd:
        os.chdir(wd)
        sys.path.insert(0, wd)
    for p in reversed((runtime_env or {}).get("py_modules") or []):
        if isinstance(p, str) and p not in sys.path:
            sys.path.insert(0, p)


def _bind_method(inst, name: str):
    """The user method, or a framework builtin for a reserved name: the
    compiled graph's setup, start and stop (cgraph/executor.py, reference:
    do_exec_tasks being a framework function run as an actor task,
    compiled_dag_node.py:133) and the collective group's join and leave
    ride the actor-task path."""
    if name.startswith("__ray_dag_"):
        from .dag_exec import bind_builtin

        return bind_builtin(inst, name)
    if name == "__ray_tpu_collective_init__":
        from ..collective import init_collective_group

        def _collective_init(ws, rank, gname):
            init_collective_group(ws, rank, gname)
            return True

        return _collective_init
    if name == "__ray_tpu_collective_destroy__":
        from ..collective import destroy_collective_group

        def _collective_destroy(gname):
            destroy_collective_group(gname)
            return True

        return _collective_destroy
    return getattr(inst, name)


class _AsyncLoop:
    """A dedicated asyncio event loop thread for async actors (reference:
    fiber.h / the async actor event loop in _raylet.pyx). Named concurrency
    groups get their own semaphores."""

    def __init__(self, concurrency: int, groups=None):
        import asyncio

        self._asyncio = asyncio
        self.loop = asyncio.new_event_loop()
        self.sem = None
        self.group_sems = {}
        self._groups = dict(groups or {})
        self.concurrency = concurrency
        ready = threading.Event()
        threading.Thread(target=self._run, args=(ready,), daemon=True, name="actor-aio").start()
        ready.wait()

    def _run(self, ready):
        self._asyncio.set_event_loop(self.loop)
        self.sem = self._asyncio.Semaphore(self.concurrency)
        self.group_sems = {k: self._asyncio.Semaphore(max(1, int(v)))
                           for k, v in self._groups.items()}
        ready.set()
        self.loop.run_forever()

    def submit(self, coro_fn, done_cb, group=None):
        async def wrapped():
            async with self.group_sems.get(group) or self.sem:
                return await coro_fn()

        fut = self._asyncio.run_coroutine_threadsafe(wrapped(), self.loop)
        fut.add_done_callback(done_cb)


def _exit_with_raylet() -> None:
    """A worker whose parent is gone exits, even mid-task: its raylet (a
    killed node), or the zygote that forked it, which exits with its
    raylet."""
    parent = os.getppid()

    def watch():
        while True:
            time.sleep(0.5)
            if os.getppid() != parent:
                os._exit(1)

    threading.Thread(target=watch, daemon=True, name="raylet-watch").start()


def main(argv: List[str]) -> None:
    raylet_sock, store_path, gcs_sock, worker_id, node_id = argv
    # First: the SIGUSR2 dump, before anything slow. The raylet's
    # flight_dump signals its workers, and the signal's default action
    # would kill one that has not bound it.
    from ..observability.flight_recorder import install_crash_hooks

    install_crash_hooks("worker")
    # stdout and stderr are the capture files the raylet's log monitor
    # tails: a print must reach it when its line completes.
    for stream in (sys.stdout, sys.stderr):
        try:
            stream.reconfigure(line_buffering=True)
        except (AttributeError, ValueError, OSError):
            pass
    from ..observability import logs as _logs

    # Records land in worker_<id>.jsonl beside the captured output; user
    # `logging` joins them (capture_root), and INFO+ records mirror a line
    # to stderr, so they reach the driver as prints do.
    _logs.configure("worker", node_id=node_id, worker_id=worker_id, mirror_stderr=True,
                    capture_root=True)
    from ..utils.sampling_profiler import maybe_start_from_env

    maybe_start_from_env("worker")
    _exit_with_raylet()
    _apply_working_dir(json.loads(os.environ.get("RAY_TPU_RUNTIME_ENV", "{}") or "{}"))

    store = SharedMemoryStore(store_path)
    raylet = RpcClient(raylet_sock)
    runtime = ClusterRuntime.attach(gcs_sock=gcs_sock, raylet_sock=raylet_sock,
                                    store_path=store_path, node_id=node_id, driver=False)
    runtime._worker_id = worker_id
    runtime_base.set_runtime(runtime)
    from ..utils import internal_metrics as imet

    imet.configure(node_id=node_id, reporter=worker_id)

    actor_instance: Dict[str, Any] = {}
    fn_cache: Dict[str, Any] = {}

    # SIGINT is the cancel signal: it interrupts the main-thread task only.
    executing_main = threading.Event()
    pending_interrupt = threading.Event()

    def _sigint(signum, frame):
        if executing_main.is_set():
            raise KeyboardInterrupt
        pending_interrupt.set()

    signal.signal(signal.SIGINT, _sigint)

    def load_fn(entry: dict):
        fh = entry["func_hash"]
        fn = fn_cache.get(fh)
        if fn is None:
            fn = fn_cache[fh] = serialization.loads(entry["func_blob"])
        return fn

    def _put_value(entry: dict, rid: ObjectID, value: Any, sealed: List[str]):
        """Stores one return value; returns {hex: blob} when it rides the ack."""
        if entry.get("_inline") is not None:
            blob = serialization.pack(value)
            if len(blob) <= INLINE_MAX:
                return {rid.hex(): blob}
            try:
                store.put_raw(rid, blob)
                sealed.append(rid.hex())
                return None
            except exc.ObjectStoreFullError:
                pass
        store.put_with_pressure(rid, value, raylet, pre_pressure=runtime.flush_local_frees)
        sealed.append(rid.hex())
        return None

    def _store_stream(entry: dict, result: Any, sealed: List[str]) -> None:
        """Streaming returns: yielded value i becomes return index i+1, sent
        to the owner as produced; the header at index 0 carries the count. A
        mid-stream exception is stored at its item index."""
        from .ids import TaskID
        from .object_ref import STREAM_COUNT_KEY

        tid = TaskID.from_hex(entry["task_id"])
        report = entry.get("_stream_report")
        it = iter(result)
        count = 0
        while True:
            try:
                item = next(it)
            except StopIteration:
                break
            except BaseException as e:  # noqa: BLE001 - stored at its item index
                item = StoredError(e if isinstance(e, exc.RayTpuError)
                                   else exc.TaskError(e, task_desc=entry.get("desc", "")),
                                   entry.get("desc", ""))
                it = iter(())
            item_sealed: List[str] = []
            inline_d = _put_value(entry, tid.object_id_for_return(count + 1), item, item_sealed)
            if report is not None:
                report(item_sealed, inline_d)
            if item_sealed:
                fp_report(item_sealed, None)
            count += 1
        header = _put_value(entry, tid.object_id_for_return(0), {STREAM_COUNT_KEY: count}, sealed)
        if header:
            entry["_inline"].update(header)

    def store_returns(entry: dict, result: Any, sealed: List[str]) -> None:
        if entry.get("streaming"):
            _store_stream(entry, result, sealed)
            return
        rids = [ObjectID.from_hex(h) for h in entry["return_ids"]]
        values = [result] if len(rids) == 1 else list(result)
        if len(values) != len(rids):
            raise ValueError(f"task returned {len(values)} values, expected {len(rids)}")
        for rid, v in zip(rids, values):
            inline = _put_value(entry, rid, v, sealed)
            if inline:
                entry["_inline"].update(inline)

    # Uncaught task exceptions go to the GCS error table, one-way and at most
    # 200 per process, so a tight failure loop cannot flood the GCS.
    error_report_budget = [200]

    def _report_task_error(entry: dict, err: BaseException) -> None:
        if isinstance(err, (exc.TaskCancelledError, SystemExit)) or error_report_budget[0] <= 0:
            return
        error_report_budget[0] -= 1
        import traceback

        try:
            runtime._gcs.notify("report_error", {
                "type": "task_error", "node_id": node_id, "worker_id": worker_id,
                "task_id": entry.get("task_id"), "actor_id": entry.get("actor_id"),
                "task": entry.get("desc", ""), "error": repr(err),
                "traceback": traceback.format_exc()[-4000:]})
        except Exception as e:  # noqa: BLE001 - the stored error is the contract
            _log.warning("error report for %s failed: %r", entry.get("desc", "task"), e)

    def store_error(entry: dict, err: BaseException, sealed: List[str]) -> None:
        if not isinstance(err, exc.RayTpuError):
            err = exc.TaskError(err, task_desc=entry.get("desc", ""))
        _report_task_error(entry, err)
        stored = StoredError(err, entry.get("desc", ""))
        inline = entry.get("_inline")
        if inline is not None:
            try:
                blob = serialization.pack(stored)
                if len(blob) <= INLINE_MAX:
                    for h in entry["return_ids"]:
                        inline[h] = blob
                    return
            except Exception:
                pass  # lint: swallow-ok(inline pack failed; store path below is the fallback)
        for h in entry["return_ids"]:
            rid = ObjectID.from_hex(h)
            try:
                store.put_with_pressure(rid, stored, raylet, deadline_s=5.0,
                                        pre_pressure=runtime.flush_local_frees)
                sealed.append(rid.hex())
            except Exception as store_err:  # noqa: BLE001
                _log.warning("failed to store error object %s: %r", rid.hex()[:8], store_err)

    def run_body(entry: dict, sealed: List[str]) -> bool:
        """Executes one task or actor-method entry (any thread)."""
        from .runtime_context import reset_task_context, set_task_context

        kind = entry["type"]
        entry["_t0"] = time.time()  # the RUNNING edge of a direct call's span
        token = set_task_context(entry.get("task_id"), entry.get("actor_id"))
        try:
            rule = _chaos_inject("task.exec",
                                 f"{entry.get('desc') or kind}@{entry.get('attempt', 0)}")
            if rule is not None:
                if rule.action == "kill":
                    _chaos_kill("task.exec", entry.get("desc", ""))
                elif rule.action == "delay":
                    time.sleep(rule.delay_s)
                elif rule.action == "raise":
                    raise RuntimeError(f"chaos: injected task failure in {entry.get('desc', kind)}")
            # The execution span, parented to the submitter's through the
            # propagated context.
            with _tracing.continue_context(entry.get("trace_ctx"),
                                           f"run {entry.get('desc') or kind}",
                                           {"task_id": entry.get("task_id", "")}):
                if kind == "task":
                    fn = load_fn(entry)
                else:
                    inst = actor_instance.get(entry["actor_id"])
                    if inst is None:
                        raise RuntimeError("actor instance missing in worker")
                    fn = _bind_method(inst, entry["method_name"])
                args, kwargs = _resolve_args(store, entry["args_blob"], raylet)
                result = fn(*args, **kwargs)
                if inspect.iscoroutine(result):
                    import asyncio

                    result = asyncio.run(result)
                store_returns(entry, result, sealed)
            return True
        except SystemExit:
            store_returns(entry, None, sealed)
            raise
        except KeyboardInterrupt:
            store_error(entry, exc.TaskCancelledError(
                f"{entry.get('desc', 'task')} was cancelled"), sealed)
            return False
        except BaseException as e:  # noqa: BLE001 - stored for the caller's get
            store_error(entry, e, sealed)
            return False
        finally:
            reset_task_context(token)

    def done(entry: dict, ok: bool, sealed: List[str]) -> None:
        raylet.notify("worker_done", worker_id, ok, sealed, entry.get("task_id"))

    direct_sock_path = os.path.join(os.path.dirname(raylet_sock) or ".",
                                    f"wkr_{worker_id}.sock")
    direct_inbox: "queue.Queue" = queue.Queue()
    direct_conns: set = set()
    accept_count = [0]
    exec_lock = threading.Lock()  # serial execution across the two ways in
    notify_q: "queue.Queue" = queue.Queue()

    def _notify_loop() -> None:
        """Coalesces direct-path completions into fastpath_done messages."""
        cli = RpcClient(raylet_sock)
        while True:
            batch = [notify_q.get()]
            time.sleep(0.001)
            while True:
                try:
                    batch.append(notify_q.get_nowait())
                except queue.Empty:
                    break
            try:
                cli.notify("fastpath_done", worker_id, [h for s, _ in batch for h in s],
                           [e for _, e in batch if e is not None])
            except Exception:  # noqa: BLE001 - the raylet is gone; so is this worker soon
                return

    threading.Thread(target=_notify_loop, daemon=True, name="fp-notify").start()

    def fp_report(sealed: List[str], event) -> None:
        notify_q.put((sealed, event))

    def _done_event(entry: dict, ok: bool) -> tuple:
        """A direct call's task event: its state and its span on this clock."""
        return (entry["task_id"], "FINISHED" if ok else "FAILED", entry.get("_t0"),
                time.time(), entry.get("desc", ""))

    pool: Optional[Any] = None
    group_pools: Dict[str, Any] = {}
    aio: Optional[_AsyncLoop] = None

    def create_actor(entry: dict, sealed: List[str]) -> bool:
        nonlocal pool, aio
        from .runtime_context import set_task_context

        set_task_context(entry.get("task_id"), entry.get("actor_id"))
        try:
            cls = load_fn(entry)
            args, kwargs = _resolve_args(store, entry["args_blob"], raylet)
            # The last phase of the actor's launch: its constructor, under
            # the driver's actor_launch span.
            with _tracing.continue_context(entry.get("trace_ctx"), "actor_launch.init",
                                           {"actor_id": entry.get("actor_id", "")}):
                inst = cls(*args, **kwargs)
            actor_instance[entry["actor_id"]] = inst
            mc = int(entry.get("max_concurrency", 1) or 1)
            cgroups = entry.get("concurrency_groups") or {}
            has_async = any(inspect.iscoroutinefunction(getattr(type(inst), m, None))
                            for m in dir(type(inst)) if not m.startswith("_"))
            if has_async:
                aio = _AsyncLoop(max(1, mc), groups=cgroups)
            elif mc > 1 or cgroups:
                import concurrent.futures

                pool = concurrent.futures.ThreadPoolExecutor(max_workers=max(1, mc),
                                                             thread_name_prefix="actor")
                for gname, width in cgroups.items():
                    group_pools[gname] = concurrent.futures.ThreadPoolExecutor(
                        max_workers=max(1, int(width)), thread_name_prefix=f"cg-{gname}")
            store_returns(entry, None, sealed)
            return True
        except SystemExit:
            store_returns(entry, None, sealed)
            raise
        except BaseException as e:  # noqa: BLE001 - stored for the creator's get
            store_error(entry, e, sealed)
            return False

    def _group_for(entry: dict):
        g = entry.get("concurrency_group")
        if g:
            return g
        inst = actor_instance.get(entry.get("actor_id") or "")
        if inst is None or not entry.get("method_name"):
            return None
        m = getattr(type(inst), entry["method_name"], None)
        return getattr(m, "__ray_tpu_method_options__", {}).get("concurrency_group")

    def exec_actor_task_async(entry: dict, report=None) -> None:
        """Runs an async actor method on the actor's event loop."""
        report = report or done
        inst = actor_instance.get(entry["actor_id"])

        async def coro():
            import asyncio

            from .runtime_context import set_task_context

            set_task_context(entry.get("task_id"), entry.get("actor_id"))
            args, kwargs = await asyncio.get_running_loop().run_in_executor(
                None, _resolve_args, store, entry["args_blob"], raylet)
            result = _bind_method(inst, entry["method_name"])(*args, **kwargs)
            if inspect.iscoroutine(result):
                result = await result
            return result

        def finish(fut):
            sealed: List[str] = []
            try:
                store_returns(entry, fut.result(), sealed)
                report(entry, True, sealed)
            except BaseException as e:  # noqa: BLE001 - stored for the caller's get
                store_error(entry, e, sealed)
                report(entry, False, sealed)

        aio.submit(coro, lambda fut: threading.Thread(target=finish, args=(fut,),
                                                      daemon=True).start(), _group_for(entry))

    def exec_threaded(entry: dict, report=None) -> None:
        report = report or done
        target_pool = group_pools.get(_group_for(entry)) or pool

        def run():
            sealed: List[str] = []
            try:
                ok = run_body(entry, sealed)
            except SystemExit:
                report(entry, True, sealed)
                os._exit(0)
            report(entry, ok, sealed)

        target_pool.submit(run)

    def _exec_direct_actor(entry: dict, send_done) -> None:
        """An actor call on the direct socket: serial actors run inline on the
        connection thread (per-connection FIFO is the per-caller order);
        concurrent actors dispatch as on the raylet path."""

        def report(e: dict, ok: bool, sealed: List[str]) -> None:
            send_done(e["task_id"], ok, sealed, e.get("_inline"))
            fp_report(sealed, _done_event(e, ok))

        if aio is not None:
            exec_actor_task_async(entry, report)
            return
        if pool is not None:
            exec_threaded(entry, report)
            return
        sealed: List[str] = []
        with exec_lock:
            try:
                ok = run_body(entry, sealed)
            except SystemExit:
                report(entry, True, sealed)
                os._exit(0)
        report(entry, ok, sealed)

    def _make_stream_report(send_raw):
        def report(sealed: List[str], inline) -> None:
            try:
                send_raw(("si", sealed, inline))
            except OSError:
                pass  # the consumer is gone; the items are stored regardless

        return report

    conn_senders: Dict[Any, Any] = {}
    lease_revoked = [False]

    def _conn_loop(conn) -> None:
        wlock = threading.Lock()

        def send_raw(frame: tuple) -> None:
            with wlock:
                _send_msg(conn, pickle.dumps(frame))

        conn_senders[conn] = send_raw
        if lease_revoked[0]:
            try:
                send_raw(("r",))
            except OSError:
                pass

        def send_done(tid: str, ok: bool, sealed: List[str], inline=None) -> None:
            try:
                send_raw(("d", tid, ok, sealed, inline or None))
            except OSError:
                pass  # the owner is gone; the results are stored regardless

        try:
            while True:
                try:
                    frame = pickle.loads(_recv_msg(conn))
                except (ConnectionError, OSError, EOFError):
                    break
                kind = frame[0]
                if kind == "t":
                    _, tid, fh, fb, ab, rids, desc, streaming = frame[:8]
                    entry = {"type": "task", "task_id": tid, "func_hash": fh, "func_blob": fb,
                             "args_blob": ab, "return_ids": rids, "desc": desc,
                             "streaming": streaming, "_inline": {},
                             "trace_ctx": frame[8] if len(frame) > 8 else None}
                    if streaming:
                        entry["_stream_report"] = _make_stream_report(send_raw)
                    direct_inbox.put((entry, send_done))
                elif kind == "a":
                    _, tid, aid, method, ab, rids, desc, streaming, cgroup = frame[:9]
                    entry = {"type": "actor_task", "task_id": tid, "actor_id": aid,
                             "method_name": method, "args_blob": ab, "return_ids": rids,
                             "desc": desc, "streaming": streaming, "concurrency_group": cgroup,
                             "_inline": {},
                             "trace_ctx": frame[9] if len(frame) > 9 else None}
                    if streaming:
                        entry["_stream_report"] = _make_stream_report(send_raw)
                    _exec_direct_actor(entry, send_done)
                elif kind == "rv":
                    # The raylet revoked the lease: tell every owner to drain.
                    lease_revoked[0] = True
                    for sender in list(conn_senders.values()):
                        try:
                            sender(("r",))
                        except OSError:
                            pass
        finally:
            conn_senders.pop(conn, None)
            direct_conns.discard(conn)
            try:
                conn.close()
            except OSError:
                pass

    def _serve_direct() -> None:
        srv = socketlib.socket(socketlib.AF_UNIX, socketlib.SOCK_STREAM)
        try:
            os.unlink(direct_sock_path)
        except OSError:
            pass
        srv.bind(direct_sock_path)
        srv.listen(128)
        while True:
            try:
                conn, _ = srv.accept()
            except OSError:
                return
            direct_conns.add(conn)
            accept_count[0] += 1
            threading.Thread(target=_conn_loop, args=(conn,), daemon=True,
                             name="direct-conn").start()

    threading.Thread(target=_serve_direct, daemon=True, name="direct-srv").start()

    def _cancel_error(entry: dict) -> BaseException:
        return exc.TaskCancelledError(f"{entry.get('desc', 'task')} was cancelled")

    def _run_direct_mode(lease_token=None) -> None:
        """Lease mode: runs direct-pushed tasks on the main thread until the
        lease owner disconnects, then returns the worker to the raylet's
        pool (reference: normal_task_submitter.cc ReturnWorker)."""
        entered = time.monotonic()
        epoch_accepts = accept_count[0]
        last_lease_check = time.monotonic()
        while True:
            try:
                entry, send_done = direct_inbox.get(timeout=0.25)
            except queue.Empty:
                if not direct_conns and (accept_count[0] > epoch_accepts or lease_revoked[0]
                                         or time.monotonic() - entered > 10.0):
                    while True:  # finish what was queued before the owner left
                        try:
                            entry, send_done = direct_inbox.get_nowait()
                        except queue.Empty:
                            break
                        sealed: List[str] = []
                        ok = run_body(entry, sealed)
                        send_done(entry["task_id"], ok, sealed, entry.get("_inline"))
                        fp_report(sealed, _done_event(entry, ok))
                    lease_revoked[0] = False
                    return
                now = time.monotonic()
                if now - last_lease_check > 5.0:
                    last_lease_check = now
                    try:
                        if not raylet.call("lease_active", worker_id, timeout=5.0):
                            lease_revoked[0] = True
                            for sender in list(conn_senders.values()):
                                try:
                                    sender(("r",))
                                except OSError:
                                    pass
                    except Exception:  # lint: swallow-ok(lease check; the next check retries)
                        pass
                continue
            sealed = []
            ok = False
            executing_main.set()
            try:
                if pending_interrupt.is_set():
                    pending_interrupt.clear()
                    if raylet.call("is_cancelled", entry["task_id"]):
                        raise KeyboardInterrupt
                with exec_lock:
                    ok = run_body(entry, sealed)
            except KeyboardInterrupt:
                store_error(entry, _cancel_error(entry), sealed)
            except SystemExit:
                executing_main.clear()
                send_done(entry["task_id"], True, sealed, entry.get("_inline"))
                fp_report(sealed, _done_event(entry, True))
                raylet.notify("return_worker_lease", worker_id, lease_token)
                os._exit(0)
            finally:
                executing_main.clear()
            send_done(entry["task_id"], ok, sealed, entry.get("_inline"))
            fp_report(sealed, _done_event(entry, ok))

    step_done: Optional[dict] = None
    while True:
        try:
            msg = raylet.call("worker_step", worker_id, step_done, timeout=60.0)
        except Exception:  # noqa: BLE001 - the raylet is gone
            return
        step_done = None
        kind = msg.get("type")
        if kind == "stop":
            return
        if kind == "direct" or (kind == "noop" and not direct_inbox.empty()):
            token = msg.get("token")
            _run_direct_mode(token)
            raylet.notify("return_worker_lease", worker_id, token)
            continue
        if kind != "task":
            continue
        entry = msg["entry"]
        if entry["type"] == "actor_creation":
            sealed: List[str] = []
            try:
                ok = create_actor(entry, sealed)
            except SystemExit:
                done(entry, True, sealed)
                return
            done(entry, ok, sealed)
            continue
        if entry["type"] == "actor_task" and aio is not None:
            exec_actor_task_async(entry)
            continue
        if entry["type"] == "actor_task" and pool is not None:
            exec_threaded(entry)
            continue
        sealed = []
        ok = False
        executing_main.set()
        try:
            if pending_interrupt.is_set():
                pending_interrupt.clear()
                if raylet.call("is_cancelled", entry["task_id"]):
                    raise KeyboardInterrupt
            with exec_lock:
                ok = run_body(entry, sealed)
        except KeyboardInterrupt:
            store_error(entry, _cancel_error(entry), sealed)
        except SystemExit:
            executing_main.clear()
            done(entry, True, sealed)
            return
        finally:
            executing_main.clear()
        step_done = {"ok": ok, "sealed": sealed, "task_id": entry.get("task_id")}


if __name__ == "__main__":
    main(sys.argv[1:])
