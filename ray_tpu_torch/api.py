"""Public core API: init/shutdown, @remote tasks and actors, get/put/wait
(copy of ray_tpu/api.py for the PyTorch port).

The surface mirrors the JAX package's, so call sites port mechanically:

    import ray_tpu_torch as rt
    rt.init(local_mode=True)

    @rt.remote(num_cpus=1)
    def f(x): return x + 1

    rt.get(f.remote(1))

Only the in-process runtime is ported (`init(local_mode=True)`, the JAX
package's ray_tpu/api.py:115-118): tasks run on a thread pool, actors on
their own threads, and nothing is pickled. `init()` without local_mode
raises NotImplementedError until the cluster runtime is ported. Left out
with it: DAG authoring (`bind`, InputNode), `broadcast` and runtime_env.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional, Sequence, Union

from . import exceptions as exc
from .core import runtime_base
from .core.ids import ActorID, TaskID
from .core.object_ref import ObjectRef
from .core.placement_group import (
    NodeAffinitySchedulingStrategy,
    PlacementGroupHandle,
    PlacementGroupSchedulingStrategy,
)
from .core.resources import task_resources
from .core.runtime_base import current_runtime, is_initialized
from .core.task_spec import ArgRef, FunctionTable, SchedulingOptions, TaskSpec, TaskType

__all__ = [
    "init",
    "shutdown",
    "is_initialized",
    "remote",
    "method",
    "get",
    "put",
    "wait",
    "kill",
    "cancel",
    "get_actor",
    "cluster_resources",
    "available_resources",
    "nodes",
    "ObjectRef",
]


_VALID_OPTIONS = {
    "num_cpus",
    "num_tpus",
    "num_gpus",
    "memory",
    "resources",
    "num_returns",
    "max_retries",
    "retry_exceptions",
    "max_concurrency",
    "max_restarts",
    "max_task_retries",
    "name",
    "namespace",
    "lifetime",
    "scheduling_strategy",
    "placement_group",
    "placement_group_bundle_index",
    "concurrency_groups",
}


def init(
    address: Optional[str] = None,
    *,
    num_cpus: Optional[float] = None,
    num_gpus: Optional[float] = None,
    resources: Optional[Dict[str, float]] = None,
    local_mode: bool = False,
    ignore_reinit_error: bool = False,
    **_kwargs,
):
    """Initializes the per-process runtime. Only the in-process runtime is
    ported: `local_mode=True` is required, and anything else raises
    NotImplementedError, as the JAX package does without its cluster
    runtime (ray_tpu/api.py:120-126)."""
    if runtime_base.is_initialized():
        if ignore_reinit_error:
            return
        raise RuntimeError("ray_tpu_torch.init() called twice; pass ignore_reinit_error=True")
    if not local_mode or address is not None:
        raise NotImplementedError(
            "the cluster runtime is not ported yet; use ray_tpu_torch.init(local_mode=True)"
        )
    from .core.local_runtime import LocalRuntime

    rt = LocalRuntime(resources=resources, num_cpus=num_cpus, num_gpus=num_gpus)
    runtime_base.set_runtime(rt)
    return rt


def shutdown():
    rt = runtime_base.maybe_runtime()
    if rt is not None:
        rt.shutdown()
        runtime_base.set_runtime(None)


# --------------------------------------------------------------------- args


def _process_args(args, kwargs):
    """ObjectRefs in args become ArgRef dependencies resolved executor-side
    (marked escaped, as serializing the ref would)."""
    def conv(a):
        if isinstance(a, ObjectRef):
            if a._runtime is not None:
                a._runtime.mark_escaped(a._id)
            return ArgRef(a.id())
        return a

    return tuple(conv(a) for a in args), {k: conv(v) for k, v in (kwargs or {}).items()}


def _validate_concurrency_groups(groups):
    if groups is None:
        return None
    if not isinstance(groups, dict):
        raise TypeError("concurrency_groups must be a Dict[str, int]")
    for name, width in groups.items():
        if not isinstance(name, str) or not name:
            raise ValueError(f"concurrency group name {name!r} must be a non-empty string")
        if not isinstance(width, int) or width <= 0:
            raise ValueError(
                f"concurrency group {name!r} width must be a positive int, got {width!r}"
            )
    return dict(groups)


def _build_sched_options(opts: Dict[str, Any], for_actor: bool = False) -> SchedulingOptions:
    bad = set(opts) - _VALID_OPTIONS
    if bad:
        raise ValueError(f"invalid option(s) {sorted(bad)}; valid: {sorted(_VALID_OPTIONS)}")
    strategy = opts.get("scheduling_strategy") or "DEFAULT"
    pg_id = None
    bundle_index = opts.get("placement_group_bundle_index", -1)
    if isinstance(strategy, PlacementGroupSchedulingStrategy):
        pg = strategy.placement_group
        bundle_index = strategy.placement_group_bundle_index
        pg_id = pg.id_hex
        strategy = "PLACEMENT_GROUP"
    elif isinstance(strategy, NodeAffinitySchedulingStrategy):
        from .core.placement_group import encode_node_affinity

        strategy = encode_node_affinity(strategy.node_id, strategy.soft)
    elif isinstance(opts.get("placement_group"), PlacementGroupHandle):
        pg_id = opts["placement_group"].id_hex
        strategy = "PLACEMENT_GROUP"
    elif strategy not in ("DEFAULT", "SPREAD"):
        raise ValueError(f"unknown scheduling_strategy {strategy!r}")
    return SchedulingOptions(
        resources=task_resources(
            num_cpus=opts.get("num_cpus"),
            num_tpus=opts.get("num_tpus"),
            num_gpus=opts.get("num_gpus"),
            memory=opts.get("memory"),
            resources=opts.get("resources"),
            # Actors hold 0 CPUs while alive unless num_cpus is explicit
            # (reference: actor resource defaults, python/ray/actor.py —
            # 1 CPU biases placement only, 0 is held at runtime); without
            # this, every idle actor pins a core and a handful of utility
            # actors starves task workers.
            default_num_cpus=0.0 if for_actor else 1.0,
        ),
        placement_group_id=pg_id,
        bundle_index=bundle_index,
        # Tasks default to 3 system-failure retries like the reference
        # (python/ray/remote_function.py DEFAULT_TASK_MAX_RETRIES).
        max_retries=opts.get("max_retries", opts.get("max_task_retries", 3)) or 0,
        retry_exceptions=bool(opts.get("retry_exceptions", False)),
        scheduling_strategy=strategy if isinstance(strategy, str) else "DEFAULT",
        max_concurrency=opts.get("max_concurrency", 1),
        concurrency_groups=_validate_concurrency_groups(opts.get("concurrency_groups")),
        max_restarts=opts.get("max_restarts", 0),
        name=opts.get("name"),
        namespace=opts.get("namespace"),
        lifetime=opts.get("lifetime"),
        actor_placement_bias=for_actor and opts.get("num_cpus") is None,
    )


# --------------------------------------------------------------------- tasks


class RemoteFunction:
    """Handle produced by @remote on a function
    (reference: python/ray/remote_function.py:40)."""

    def __init__(self, fn, options: Dict[str, Any]):
        self._fn = fn
        self._options = options
        self._blob = None
        self._hash = None
        functools.update_wrapper(self, fn)

    def _materialize(self):
        if self._blob is None:
            self._blob, self._hash = FunctionTable.dumps(self._fn)
        return self._blob, self._hash

    def options(self, **opts) -> "RemoteFunction":
        merged = {**self._options, **opts}
        rf = RemoteFunction(self._fn, merged)
        rf._blob, rf._hash = self._blob, self._hash
        return rf

    def remote(self, *args, **kwargs):
        rt = current_runtime()
        blob, fhash = self._materialize()
        pargs, pkwargs = _process_args(args, kwargs)
        num_returns = self._options.get("num_returns", 1)
        spec = TaskSpec(
            task_id=TaskID.for_task(),
            task_type=TaskType.NORMAL_TASK,
            func_blob=blob,
            func_hash=fhash,
            method_name=getattr(self._fn, "__name__", "fn"),
            args=pargs,
            kwargs=pkwargs,
            num_returns=num_returns,
            options=_build_sched_options(self._options),
        )
        return_ids = rt.submit_task(spec)
        if num_returns == "streaming":
            from .core.object_ref import ObjectRefGenerator

            return ObjectRefGenerator(spec.task_id, rt)
        refs = [ObjectRef(oid, rt) for oid in return_ids]
        return refs[0] if num_returns == 1 else refs

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Remote function {self.__name__!r} cannot be called directly; "
            f"use {self.__name__}.remote()."
        )


# --------------------------------------------------------------------- actors


class ActorMethod:
    def __init__(
        self,
        handle: "ActorHandle",
        method_name: str,
        num_returns: int = 1,
        concurrency_group: Optional[str] = None,
    ):
        self._handle = handle
        self._method_name = method_name
        self._num_returns = num_returns
        self._concurrency_group = concurrency_group

    def options(self, **opts) -> "ActorMethod":
        m = ActorMethod(
            self._handle,
            self._method_name,
            opts.get("num_returns", self._num_returns),
            opts.get("concurrency_group", self._concurrency_group),
        )
        return m

    def remote(self, *args, **kwargs):
        return self._handle._invoke(
            self._method_name, args, kwargs, self._num_returns,
            concurrency_group=self._concurrency_group,
        )

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Actor method {self._method_name!r} cannot be called directly; use .remote()."
        )


class ActorHandle:
    """Reference to a running actor (reference: python/ray/actor.py ActorHandle)."""

    def __init__(self, actor_id: ActorID, method_meta: Dict[str, Dict[str, Any]]):
        self._actor_id = actor_id
        self._method_meta = method_meta

    @property
    def _id(self) -> ActorID:
        return self._actor_id

    def _invoke(
        self, method_name: str, args, kwargs, num_returns: int,
        concurrency_group: Optional[str] = None,
    ):
        rt = current_runtime()
        pargs, pkwargs = _process_args(args, kwargs)
        spec = TaskSpec(
            task_id=TaskID.for_task(),
            task_type=TaskType.ACTOR_TASK,
            func_blob=b"",
            func_hash="",
            method_name=method_name,
            args=pargs,
            kwargs=pkwargs,
            num_returns=num_returns,
            options=SchedulingOptions(),
            actor_id=self._actor_id,
            concurrency_group=concurrency_group,
        )
        return_ids = rt.submit_actor_task(spec)
        if num_returns == "streaming":
            from .core.object_ref import ObjectRefGenerator

            return ObjectRefGenerator(spec.task_id, rt)
        refs = [ObjectRef(oid, rt) for oid in return_ids]
        return refs[0] if num_returns == 1 else refs

    def __getattr__(self, name: str) -> ActorMethod:
        if name.startswith("_"):
            raise AttributeError(name)
        meta = self._method_meta.get(name)
        if meta is None:
            raise AttributeError(f"actor has no method {name!r}")
        return ActorMethod(
            self, name, meta.get("num_returns", 1), meta.get("concurrency_group")
        )

    def __reduce__(self):
        return (ActorHandle, (self._actor_id, self._method_meta))

    def __repr__(self):
        return f"ActorHandle({self._actor_id.hex()[:12]})"


class ActorClass:
    """Handle produced by @remote on a class (reference: python/ray/actor.py:581)."""

    def __init__(self, cls, options: Dict[str, Any]):
        self._cls = cls
        self._options = options
        self._blob = None
        self._hash = None
        self._method_meta = self._scan_methods(cls)
        functools.update_wrapper(self, cls, updated=[])

    @staticmethod
    def _scan_methods(cls) -> Dict[str, Dict[str, Any]]:
        meta = {}
        for name in dir(cls):
            if name.startswith("__"):
                continue
            attr = getattr(cls, name, None)
            if callable(attr):
                meta[name] = dict(getattr(attr, "__ray_tpu_method_options__", {}))
        return meta

    def options(self, **opts) -> "ActorClass":
        ac = ActorClass(self._cls, {**self._options, **opts})
        ac._blob, ac._hash = self._blob, self._hash
        return ac

    def remote(self, *args, **kwargs) -> ActorHandle:
        rt = current_runtime()
        if self._blob is None:
            self._blob, self._hash = FunctionTable.dumps(self._cls)
        pargs, pkwargs = _process_args(args, kwargs)
        opts = _build_sched_options(self._options, for_actor=True)
        spec = TaskSpec(
            task_id=TaskID.for_task(),
            task_type=TaskType.ACTOR_CREATION,
            func_blob=self._blob,
            func_hash=self._hash,
            method_name="__init__",
            args=pargs,
            kwargs=pkwargs,
            num_returns=1,
            options=opts,
            actor_id=ActorID.from_random(),
        )
        declared = set((opts.concurrency_groups or {}).keys())
        for mname, meta in self._method_meta.items():
            g = meta.get("concurrency_group")
            if g and g not in declared:
                raise ValueError(
                    f"method {mname!r} targets undeclared concurrency group {g!r}; "
                    f"declared: {sorted(declared)}"
                )
        actor_id = rt.create_actor(spec)
        return ActorHandle(actor_id, self._method_meta)

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Actor class {self._cls.__name__!r} cannot be instantiated directly; "
            f"use {self._cls.__name__}.remote()."
        )


def method(**opts):
    """Per-method options, e.g. @method(num_returns=2)
    (reference: python/ray/actor.py method decorator)."""

    def decorator(fn):
        fn.__ray_tpu_method_options__ = opts
        return fn

    return decorator


# ----------------------------------------------------------------- decorator


def remote(*args, **options):
    """@remote or @remote(num_cpus=..., num_tpus=..., ...)."""
    if len(args) == 1 and not options and (callable(args[0]) or isinstance(args[0], type)):
        target = args[0]
        return ActorClass(target, {}) if isinstance(target, type) else RemoteFunction(target, {})
    if args:
        raise TypeError("remote() takes keyword options only")
    bad = set(options) - _VALID_OPTIONS
    if bad:
        raise ValueError(f"invalid option(s) {sorted(bad)}")

    def decorator(target):
        return ActorClass(target, options) if isinstance(target, type) else RemoteFunction(target, options)

    return decorator


# ----------------------------------------------------------------- get/put


def get(refs: Union[ObjectRef, Sequence[ObjectRef]], *, timeout: Optional[float] = None):
    """Blocks until object values are available (reference:
    python/ray/_private/worker.py:2619)."""
    rt = current_runtime()
    single = isinstance(refs, ObjectRef)
    ref_list = [refs] if single else list(refs)
    for r in ref_list:
        if not isinstance(r, ObjectRef):
            raise TypeError(f"get() expects ObjectRef(s), got {type(r).__name__}")
    values = rt.get([r.id() for r in ref_list], timeout=timeout)
    return values[0] if single else values


def put(value: Any) -> ObjectRef:
    """Stores a value in the object store (reference: worker.py:2787)."""
    if isinstance(value, ObjectRef):
        raise TypeError("put() of an ObjectRef is not allowed")
    rt = current_runtime()
    return ObjectRef(rt.put(value), rt)


def wait(
    refs: Sequence[ObjectRef],
    *,
    num_returns: int = 1,
    timeout: Optional[float] = None,
):
    """Returns (ready, not_ready) lists (reference: worker.py ray.wait)."""
    refs = list(refs)
    if num_returns > len(refs):
        raise ValueError("num_returns exceeds the number of refs")
    rt = current_runtime()
    ready_idx, pending_idx = rt.wait([r.id() for r in refs], num_returns, timeout)
    return [refs[i] for i in ready_idx], [refs[i] for i in pending_idx]


def kill(actor: ActorHandle, *, no_restart: bool = True):
    current_runtime().kill_actor(actor._id, no_restart=no_restart)


def cancel(ref: ObjectRef, *, force: bool = False):
    current_runtime().cancel(ref.id(), force=force)


def get_actor(name: str, namespace: Optional[str] = None) -> ActorHandle:
    rt = current_runtime()
    actor_id = rt.get_named_actor(name, namespace)
    meta = getattr(rt, "actor_method_meta", lambda _aid: None)(actor_id)
    if meta is None:
        meta = {}
    return ActorHandle(actor_id, meta) if meta else _DynamicActorHandle(actor_id)


class _DynamicActorHandle(ActorHandle):
    """Handle with unknown method table (named-actor lookup path): permits
    any method name; errors surface at call time."""

    def __init__(self, actor_id: ActorID):
        super().__init__(actor_id, {})

    def __getattr__(self, name: str) -> ActorMethod:
        if name.startswith("_"):
            raise AttributeError(name)
        return ActorMethod(self, name, 1)


def cluster_resources() -> Dict[str, float]:
    return current_runtime().cluster_resources()


def available_resources() -> Dict[str, float]:
    return current_runtime().available_resources()


def nodes() -> List[dict]:
    return current_runtime().nodes()


def get_runtime_context():
    """Introspects the current driver/worker/task context (reference:
    python/ray/runtime_context.py get_runtime_context)."""
    from .core.runtime_context import get_runtime_context as _grc

    return _grc()
