"""Task and actor specifications passed from caller to executor (copy of
ray_tpu/core/task_spec.py for the PyTorch port).

Condensed re-design of the reference's TaskSpecification
(reference: src/ray/common/task/task_spec.h, protobuf common.proto TaskSpec):
one dataclass covers normal tasks, actor creation, and actor calls. The spec
carries the callable itself. The in-process runtime runs it as is; the
cluster runtime pickles it once per process with core/serialization.py
(by reference when the worker can import it, by value otherwise: the
port's own reducer, where the JAX package uses cloudpickle) and ships the
bytes keyed by their hash (core/cluster_runtime.py `_entry_from_spec`).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from .ids import ActorID, ObjectID, PlacementGroupID, TaskID
from .resources import ResourceSet


class TaskType(enum.Enum):
    NORMAL_TASK = 0
    ACTOR_CREATION = 1
    ACTOR_TASK = 2


@dataclass
class SchedulingOptions:
    resources: ResourceSet = field(default_factory=ResourceSet)
    placement_group_id: Optional[PlacementGroupID] = None
    bundle_index: int = -1
    max_retries: int = 0
    retry_exceptions: bool = False
    scheduling_strategy: str = "DEFAULT"   # DEFAULT | SPREAD | NODE:<id>
    max_concurrency: int = 1               # actors only
    max_restarts: int = 0                  # actors only
    # Named method groups with independent concurrency limits (reference:
    # src/ray/core_worker/transport/concurrency_group_manager.h:34) —
    # {"io": 4, "compute": 1}; methods opt in via @method(concurrency_group=...).
    concurrency_groups: Optional[Dict[str, int]] = None
    name: Optional[str] = None             # named actor
    namespace: Optional[str] = None
    lifetime: Optional[str] = None         # None | "detached"
    runtime_env: Optional[dict] = None
    # Actors: True when num_cpus was defaulted (hold 0, but PLACE as if 1
    # CPU); False when the user set it explicitly — even to 0.
    actor_placement_bias: bool = False


@dataclass
class TaskSpec:
    task_id: TaskID
    task_type: TaskType
    func_blob: Any                        # the fn / actor class itself (pickled on the wire)
    func_hash: str
    method_name: str                      # "" for normal tasks; "__init__" for creation
    args: Tuple[Any, ...]                 # values or ObjectID placeholders (see ArgRef)
    kwargs: Dict[str, Any]
    num_returns: int
    options: SchedulingOptions
    actor_id: Optional[ActorID] = None
    return_ids: List[ObjectID] = field(default_factory=list)
    attempt: int = 0
    concurrency_group: Optional[str] = None  # actor calls: target group

    def description(self) -> str:
        if self.task_type == TaskType.ACTOR_TASK:
            return f"actor task {self.method_name} ({self.task_id.hex()[:8]})"
        if self.task_type == TaskType.ACTOR_CREATION:
            return f"actor creation ({self.actor_id.hex()[:8] if self.actor_id else '?'})"
        return f"task {self.method_name or 'fn'} ({self.task_id.hex()[:8]})"


@dataclass(frozen=True)
class ArgRef:
    """Placeholder inside TaskSpec.args/kwargs marking an ObjectID dependency
    to be resolved by the executor (reference: DependencyResolver,
    src/ray/core_worker/transport/dependency_resolver.h)."""

    object_id: ObjectID


class FunctionTable:
    """The JAX package's content-addressed function cache, reduced to what
    the API layer needs: `dumps` hands back the callable with an identity
    key and `loads` returns it unchanged. The cluster runtime pickles the
    callable itself when it builds the wire entry."""

    @staticmethod
    def dumps(fn: Any) -> Tuple[Any, str]:
        return fn, f"{id(fn):x}"

    def loads(self, blob: Any, func_hash: str) -> Any:
        return blob


GLOBAL_FUNCTION_TABLE = FunctionTable()
