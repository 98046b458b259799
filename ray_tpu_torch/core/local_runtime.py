"""In-process runtime: tasks on a thread pool, actors on dedicated threads
(copy of ray_tpu/core/local_runtime.py for the PyTorch port).

This is the analogue of the reference's local mode
(reference: python/ray/_private/worker.py local_mode) but kept truly
concurrent — tasks run on a thread pool and actors keep FIFO ordering via a
single-threaded executor — so scheduling/interleaving bugs surface in unit
tests. The API layer cannot tell this runtime apart from the multi-process
ClusterRuntime.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import inspect
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .. import exceptions as exc
from .ids import ActorID, ObjectID, TaskID
from .resources import ResourceSet, detect_node_resources
from .runtime_base import Runtime
from .task_spec import GLOBAL_FUNCTION_TABLE, ArgRef, TaskSpec, TaskType

_OK = 0
_ERR = 1


def _declared_group(instance, method_name: str) -> Optional[str]:
    """The method's decorator-declared concurrency group — the fallback
    when the caller's handle (e.g. get_actor's dynamic handle) didn't
    carry one."""
    if instance is None or not method_name:
        return None
    m = getattr(type(instance), method_name, None)
    return getattr(m, "__ray_tpu_method_options__", {}).get("concurrency_group")


class _ActorState:
    def __init__(
        self,
        actor_id: ActorID,
        max_concurrency: int,
        name: Optional[str],
        namespace: str = "default",
        concurrency_groups: Optional[Dict[str, int]] = None,
    ):
        self.actor_id = actor_id
        self.instance: Any = None
        self.pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=max(1, max_concurrency), thread_name_prefix=f"actor-{actor_id.hex()[:6]}"
        )
        # Named concurrency groups: independent executors (reference:
        # concurrency_group_manager.h:34).
        self.group_pools = {
            g: concurrent.futures.ThreadPoolExecutor(
                max_workers=max(1, int(w)), thread_name_prefix=f"cg-{g}"
            )
            for g, w in (concurrency_groups or {}).items()
        }
        self.name = name
        self.namespace = namespace
        self.dead = False
        self.death_reason = ""
        # Return ids of submitted-but-unfinished calls; resolved to
        # ActorDiedError if the actor is killed while they are queued.
        self.pending: set = set()
        self.pending_lock = threading.Lock()
        # Completed once the constructor has run (methods are gated on it).
        self.ready_future: concurrent.futures.Future = concurrent.futures.Future()

    def executor_for(self, group: Optional[str]):
        return self.group_pools.get(group, self.pool) if group else self.pool


class LocalRuntime(Runtime):
    def __init__(self, resources: Optional[Dict[str, float]] = None,
                 num_cpus: Optional[float] = None, num_gpus: Optional[float] = None):
        self._objects: Dict[ObjectID, Tuple[int, Any]] = {}
        self._futures: Dict[ObjectID, concurrent.futures.Future] = {}
        self._obj_lock = threading.Lock()
        self._actors: Dict[ActorID, _ActorState] = {}
        self._named_actors: Dict[Tuple[str, str], ActorID] = {}
        self._actor_lock = threading.Lock()
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=64, thread_name_prefix="task"
        )
        self._total_resources = dict(
            resources if resources is not None
            else detect_node_resources(num_cpus=num_cpus, num_gpus=num_gpus)
        )
        self._local_refs: Dict[ObjectID, int] = {}
        self._freed: set = set()  # dropped before the producing task stored
        self._shutdown = False

    # ------------------------------------------------------ refcounting
    def add_local_ref(self, object_id: ObjectID) -> None:
        with self._obj_lock:
            self._local_refs[object_id] = self._local_refs.get(object_id, 0) + 1
            self._freed.discard(object_id)

    def remove_local_ref(self, object_id: ObjectID) -> None:
        """Frees the stored value when the last ObjectRef drops (the local
        analogue of owner-side reference counting, reference:
        reference_count.h:64)."""
        with self._obj_lock:
            c = self._local_refs.get(object_id, 0) - 1
            if c > 0:
                self._local_refs[object_id] = c
                return
            self._local_refs.pop(object_id, None)
            stored = self._objects.pop(object_id, None)
            if stored is None:
                # Not stored yet (fire-and-forget): mark so the producing
                # task's _store skips the value instead of leaking it.
                self._freed.add(object_id)
            fut = self._futures.pop(object_id, None)
        # A value may hold ObjectRefs, whose __del__ re-enters this method:
        # let it go only once the lock is released (the JAX package frees
        # it under the lock and deadlocks).
        del stored, fut

    # ------------------------------------------------------------- objects
    def _future_for(self, oid: ObjectID) -> concurrent.futures.Future:
        with self._obj_lock:
            fut = self._futures.get(oid)
            if fut is None:
                fut = concurrent.futures.Future()
                self._futures[oid] = fut
                if oid in self._objects:
                    fut.set_result(self._objects[oid])
            return fut

    def _store(self, oid: ObjectID, status: int, value: Any) -> None:
        with self._obj_lock:
            if oid in self._freed:
                self._freed.discard(oid)  # all refs dropped pre-completion
                return
            self._objects[oid] = (status, value)
            fut = self._futures.get(oid)
            if fut is None:
                fut = concurrent.futures.Future()
                self._futures[oid] = fut
        if not fut.done():
            fut.set_result((status, value))

    def put(self, value: Any) -> ObjectID:
        oid = TaskID.for_task().object_id_for_return(0)
        self._store(oid, _OK, value)
        return oid

    def get(self, object_ids: Sequence[ObjectID], timeout: Optional[float] = None) -> List[Any]:
        deadline = None if timeout is None else time.monotonic() + timeout
        out = []
        for oid in object_ids:
            fut = self._future_for(oid)
            remaining = None if deadline is None else max(0.0, deadline - time.monotonic())
            try:
                status, value = fut.result(timeout=remaining)
            except concurrent.futures.TimeoutError:
                raise exc.GetTimeoutError(f"get() timed out waiting for {oid.hex()[:12]}")
            if status == _ERR:
                raise value
            out.append(value)
        return out

    def wait(self, object_ids, num_returns, timeout):
        futs = [self._future_for(oid) for oid in object_ids]
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            not_done = [f for f in futs if not f.done()]
            n_ready = len(futs) - len(not_done)
            if n_ready >= num_returns or not not_done:
                break
            remaining = None if deadline is None else deadline - time.monotonic()
            if remaining is not None and remaining <= 0:
                break
            concurrent.futures.wait(
                not_done, timeout=remaining, return_when=concurrent.futures.FIRST_COMPLETED
            )
        ready_idx = [i for i, f in enumerate(futs) if f.done()][:num_returns]
        ready_set = set(ready_idx)
        pending_idx = [i for i in range(len(futs)) if i not in ready_set]
        return ready_idx, pending_idx

    def object_future(self, object_id: ObjectID) -> concurrent.futures.Future:
        out: concurrent.futures.Future = concurrent.futures.Future()

        def _done(f: concurrent.futures.Future):
            status, value = f.result()
            if status == _ERR:
                out.set_exception(value)
            else:
                out.set_result(value)

        self._future_for(object_id).add_done_callback(_done)
        return out

    # ------------------------------------------------------------- helpers
    def _collect_deps(self, spec: TaskSpec) -> List[ObjectID]:
        deps = [a.object_id for a in spec.args if isinstance(a, ArgRef)]
        deps += [v.object_id for v in spec.kwargs.values() if isinstance(v, ArgRef)]
        return deps

    def _resolve_args(self, spec: TaskSpec):
        def fetch(a):
            if isinstance(a, ArgRef):
                status, value = self._objects[a.object_id]
                if status == _ERR:
                    raise value
                return value
            return a

        args = tuple(fetch(a) for a in spec.args)
        kwargs = {k: fetch(v) for k, v in spec.kwargs.items()}
        return args, kwargs

    def _store_returns(self, spec: TaskSpec, result: Any) -> None:
        n = spec.num_returns
        if n == "streaming":
            self._store_stream(spec, result)
            return
        if n == 1:
            self._store(spec.return_ids[0], _OK, result)
        else:
            vals = list(result)
            if len(vals) != n:
                err = exc.TaskError(
                    ValueError(f"task returned {len(vals)} values, expected {n}"),
                    task_desc=spec.description(),
                )
                for rid in spec.return_ids:
                    self._store(rid, _ERR, err)
                return
            for rid, v in zip(spec.return_ids, vals):
                self._store(rid, _OK, v)

    def _store_stream(self, spec: TaskSpec, result: Any) -> None:
        """Streaming returns (num_returns="streaming"): item i at return
        index i+1 as produced, header (count) at index 0 on completion —
        same layout as the cluster runtime."""
        from .object_ref import STREAM_COUNT_KEY

        if inspect.isasyncgen(result):
            agen = result

            def _sync_iter():
                loop = asyncio.new_event_loop()
                try:
                    while True:
                        try:
                            yield loop.run_until_complete(agen.__anext__())
                        except StopAsyncIteration:
                            return
                finally:
                    loop.close()

            result = _sync_iter()
        it = iter(result)
        count = 0
        while True:
            try:
                item = next(it)
            except StopIteration:
                break
            except BaseException as e:  # noqa: BLE001
                err = e if isinstance(e, exc.RayTpuError) else exc.TaskError(
                    e, task_desc=spec.description()
                )
                self._store(spec.task_id.object_id_for_return(count + 1), _ERR, err)
                count += 1
                break
            self._store(spec.task_id.object_id_for_return(count + 1), _OK, item)
            count += 1
        self._store(
            spec.task_id.object_id_for_return(0), _OK, {STREAM_COUNT_KEY: count}
        )

    def stream_next(self, task_id, index: int, timeout: Optional[float] = None):
        from .object_ref import STREAM_COUNT_KEY

        header = task_id.object_id_for_return(0)
        item = task_id.object_id_for_return(index + 1)
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            with self._obj_lock:
                if item in self._objects:
                    return item  # errors surface at get()
                hdr = self._objects.get(header)
            if hdr is not None:
                status, value = hdr
                if status == _ERR:
                    raise value
                if index >= value.get(STREAM_COUNT_KEY, 0):
                    with self._obj_lock:
                        self._futures.pop(item, None)  # never materializes
                    return None
            if deadline is not None and time.monotonic() >= deadline:
                raise exc.GetTimeoutError(
                    f"stream item {index} of {task_id.hex()[:12]} timed out"
                )
            concurrent.futures.wait(
                [self._future_for(item), self._future_for(header)],
                timeout=0.1,
                return_when=concurrent.futures.FIRST_COMPLETED,
            )

    def stream_done(self, task_id) -> None:
        """Frees never-consumed stream items (the consumer's ObjectRefs
        free the consumed ones; the generator's header ref frees the
        header)."""
        from .object_ref import STREAM_COUNT_KEY

        with self._obj_lock:
            hdr = self._objects.get(task_id.object_id_for_return(0))
        if not hdr or hdr[0] != _OK:
            return
        for i in range(int(hdr[1].get(STREAM_COUNT_KEY, 0))):
            oid = task_id.object_id_for_return(i + 1)
            with self._obj_lock:
                if oid in self._local_refs:
                    continue
                # Dropped after the lock, as in remove_local_ref.
                item = (self._objects.pop(oid, None), self._futures.pop(oid, None))
            del item

    def _store_error(self, spec: TaskSpec, err: BaseException) -> None:
        if not isinstance(err, exc.RayTpuError):
            err = exc.TaskError(err, task_desc=spec.description())
        for rid in spec.return_ids:
            self._store(rid, _ERR, err)

    def _after_deps(self, spec: TaskSpec, run) -> None:
        deps = self._collect_deps(spec)
        if not deps:
            run()
            return
        remaining = [len(deps)]
        lock = threading.Lock()

        def on_dep(_f):
            with lock:
                remaining[0] -= 1
                last = remaining[0] == 0
            if last:
                run()

        for d in deps:
            self._future_for(d).add_done_callback(on_dep)

    def _pin_deps(self, spec: TaskSpec) -> List[ObjectID]:
        """Pins argument objects for the task's flight time so a caller
        dropping its ObjectRef cannot free an in-flight dependency
        (reference: reference_count.h submitted-task-count pinning)."""
        deps = self._collect_deps(spec)
        for d in deps:
            self.add_local_ref(d)
        return deps

    def _unpin_deps(self, deps: List[ObjectID]) -> None:
        for d in deps:
            self.remove_local_ref(d)

    # ------------------------------------------------------------- tasks
    def submit_task(self, spec: TaskSpec) -> List[ObjectID]:
        spec.return_ids = (
            [spec.task_id.object_id_for_return(0)]
            if spec.num_returns == "streaming"
            else [
                spec.task_id.object_id_for_return(i)
                for i in range(spec.num_returns)
            ]
        )
        deps = self._pin_deps(spec)

        def execute():
            try:
                fn = GLOBAL_FUNCTION_TABLE.loads(spec.func_blob, spec.func_hash)
                args, kwargs = self._resolve_args(spec)
                result = fn(*args, **kwargs)
                if inspect.iscoroutine(result):
                    result = asyncio.run(result)
                self._store_returns(spec, result)
            except BaseException as e:  # noqa: BLE001
                self._store_error(spec, e)
            finally:
                self._unpin_deps(deps)

        self._after_deps(spec, lambda: self._pool.submit(execute))
        return spec.return_ids

    # ------------------------------------------------------------- actors
    def create_actor(self, spec: TaskSpec) -> ActorID:
        actor_id = spec.actor_id or ActorID.from_random()
        spec.actor_id = actor_id
        namespace = spec.options.namespace or "default"
        state = _ActorState(
            actor_id,
            spec.options.max_concurrency,
            spec.options.name,
            namespace,
            spec.options.concurrency_groups,
        )
        with self._actor_lock:
            if spec.options.name:
                key = (namespace, spec.options.name)
                if key in self._named_actors:
                    raise exc.ActorNameTakenError(
                        f"actor name {spec.options.name!r} already taken")
                self._named_actors[key] = actor_id
            self._actors[actor_id] = state
        spec.return_ids = [spec.task_id.object_id_for_return(0)]
        deps = self._pin_deps(spec)

        def construct():
            try:
                cls = GLOBAL_FUNCTION_TABLE.loads(spec.func_blob, spec.func_hash)
                args, kwargs = self._resolve_args(spec)
                state.instance = cls(*args, **kwargs)
                self._store(spec.return_ids[0], _OK, None)
            except BaseException as e:  # noqa: BLE001
                state.dead = True
                state.death_reason = f"constructor failed: {e!r}"
                self._store_error(spec, e)
            finally:
                self._unpin_deps(deps)
                state.ready_future.set_result(None)

        self._after_deps(spec, lambda: state.pool.submit(construct))
        return actor_id

    def submit_actor_task(self, spec: TaskSpec) -> List[ObjectID]:
        spec.return_ids = (
            [spec.task_id.object_id_for_return(0)]
            if spec.num_returns == "streaming"
            else [
                spec.task_id.object_id_for_return(i)
                for i in range(spec.num_returns)
            ]
        )
        with self._actor_lock:
            state = self._actors.get(spec.actor_id)
        if state is None or state.dead:
            reason = state.death_reason if state else "no such actor"
            err = exc.ActorDiedError(spec.actor_id.hex() if spec.actor_id else "", reason)
            for rid in spec.return_ids:
                self._store(rid, _ERR, err)
            return spec.return_ids

        with state.pending_lock:
            state.pending.update(spec.return_ids)
        deps = self._pin_deps(spec)

        def finish():
            self._unpin_deps(deps)
            with state.pending_lock:
                state.pending.difference_update(spec.return_ids)

        def execute():
            if state.dead or state.instance is None:
                self._store_error(
                    spec, exc.ActorDiedError(state.actor_id.hex(), state.death_reason or "not constructed")
                )
                finish()
                return
            try:
                method = getattr(state.instance, spec.method_name)
                args, kwargs = self._resolve_args(spec)
                result = method(*args, **kwargs)
                if inspect.iscoroutine(result):
                    result = asyncio.run(result)
                self._store_returns(spec, result)
            except BaseException as e:  # noqa: BLE001
                if isinstance(e, SystemExit):
                    state.dead = True
                    state.death_reason = "exit_actor"
                    for rid in spec.return_ids:
                        self._store(rid, _OK, None)
                else:
                    self._store_error(spec, e)
            finally:
                finish()

        # Gate on constructor completion so methods never observe a
        # half-constructed instance (even with max_concurrency > 1).
        self._after_deps(
            spec,
            lambda: state.ready_future.add_done_callback(
                lambda _f: state.executor_for(
                    spec.concurrency_group
                    or _declared_group(state.instance, spec.method_name)
                ).submit(execute)
            ),
        )
        return spec.return_ids

    def cancel(self, object_id: ObjectID, force: bool = False) -> None:
        # Honest surface: thread-pool tasks cannot be interrupted safely.
        raise NotImplementedError(
            "cancel() is not supported in local mode; use cluster mode"
        )

    def kill_actor(self, actor_id: ActorID, no_restart: bool = True) -> None:
        with self._actor_lock:
            state = self._actors.get(actor_id)
            if state is None:
                return
            state.dead = True
            state.death_reason = "killed via kill()"
            if state.name:
                self._named_actors.pop((state.namespace, state.name), None)
        state.pool.shutdown(wait=False, cancel_futures=True)
        for gp in state.group_pools.values():
            gp.shutdown(wait=False, cancel_futures=True)
        # Resolve queued-but-cancelled calls so get() on them raises instead
        # of hanging (reference parity: RayActorError on killed actors).
        with state.pending_lock:
            pending = list(state.pending)
            state.pending.clear()
        err = exc.ActorDiedError(actor_id.hex(), state.death_reason)
        for rid in pending:
            with self._obj_lock:
                done = rid in self._objects
            if not done:
                self._store(rid, _ERR, err)

    def get_named_actor(self, name: str, namespace: Optional[str]) -> ActorID:
        with self._actor_lock:
            aid = self._named_actors.get((namespace or "default", name))
        if aid is None:
            raise ValueError(f"Failed to look up actor with name {name!r}")
        return aid

    # ------------------------------------------------------------- cluster
    def cluster_resources(self) -> Dict[str, float]:
        return dict(self._total_resources)

    def available_resources(self) -> Dict[str, float]:
        return dict(self._total_resources)

    def nodes(self) -> List[dict]:
        return [
            {
                "NodeID": "local",
                "Alive": True,
                "Resources": dict(self._total_resources),
            }
        ]

    # ------------------------------------------------------- placement gr.
    def create_placement_group(self, bundles, strategy, name=""):
        from .placement_group import PlacementGroupHandle

        pg_id = TaskID.for_task().object_id_for_return(0)
        return PlacementGroupHandle(pg_id.hex(), bundles, strategy)

    def remove_placement_group(self, pg_id) -> None:
        pass

    def placement_group_ready(self, pg_id, timeout=None) -> bool:
        return True

    def shutdown(self) -> None:
        if self._shutdown:
            return
        self._shutdown = True
        self._pool.shutdown(wait=False, cancel_futures=True)
        with self._actor_lock:
            actors = list(self._actors.values())
        for a in actors:
            a.pool.shutdown(wait=False, cancel_futures=True)
            for gp in a.group_pools.values():
                gp.shutdown(wait=False, cancel_futures=True)
