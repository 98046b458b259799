"""Runtime interface + global runtime registry (copy of
ray_tpu/core/runtime_base.py for the PyTorch port).

The Runtime is the TPU-native analogue of the reference's CoreWorker
(reference: src/ray/core_worker/core_worker.h:271): one per driver/worker
process, owning object resolution, task submission, and actor management.
Two implementations, as in the JAX package: LocalRuntime (in-process
threads, the analogue of the reference's local_mode) and ClusterRuntime
(multi-process nodes on one machine with a shared-memory store and socket
RPC, core/cluster_runtime.py).
"""

from __future__ import annotations

import concurrent.futures
import threading
from abc import ABC, abstractmethod
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .ids import ActorID, ObjectID
from .task_spec import TaskSpec

_runtime_lock = threading.Lock()
_runtime: Optional["Runtime"] = None


def set_runtime(rt: Optional["Runtime"]) -> None:
    global _runtime
    with _runtime_lock:
        _runtime = rt


def maybe_runtime() -> Optional["Runtime"]:
    return _runtime


def current_runtime() -> "Runtime":
    rt = _runtime
    if rt is None:
        raise RuntimeError(
            "ray_tpu_torch has not been initialized; call ray_tpu_torch.init() "
            "(or init(local_mode=True)) first."
        )
    return rt


def is_initialized() -> bool:
    return _runtime is not None


class Runtime(ABC):
    """Per-process runtime services used by the public API layer."""

    # ---- objects ----
    @abstractmethod
    def put(self, value: Any) -> ObjectID: ...

    @abstractmethod
    def get(self, object_ids: Sequence[ObjectID], timeout: Optional[float] = None) -> List[Any]: ...

    @abstractmethod
    def wait(
        self, object_ids: Sequence[ObjectID], num_returns: int, timeout: Optional[float]
    ) -> Tuple[List[int], List[int]]:
        """Returns (ready_indices, pending_indices) preserving input order."""

    @abstractmethod
    def object_future(self, object_id: ObjectID) -> concurrent.futures.Future: ...

    def add_local_ref(self, object_id: ObjectID) -> None:  # refcounting optional
        pass

    def remove_local_ref(self, object_id: ObjectID) -> None:
        pass

    def mark_escaped(self, object_id: ObjectID) -> None:
        """Records that a ref to this object was serialized out of this
        process (so another process may borrow it)."""
        pass

    # ---- tasks ----
    @abstractmethod
    def submit_task(self, spec: TaskSpec) -> List[ObjectID]: ...

    @abstractmethod
    def create_actor(self, spec: TaskSpec) -> ActorID: ...

    @abstractmethod
    def submit_actor_task(self, spec: TaskSpec) -> List[ObjectID]: ...

    @abstractmethod
    def kill_actor(self, actor_id: ActorID, no_restart: bool = True) -> None: ...

    def cancel(self, object_id: ObjectID, force: bool = False) -> None:
        pass

    # ---- naming / cluster ----
    @abstractmethod
    def get_named_actor(self, name: str, namespace: Optional[str]) -> ActorID: ...

    @abstractmethod
    def cluster_resources(self) -> Dict[str, float]: ...

    @abstractmethod
    def available_resources(self) -> Dict[str, float]: ...

    def nodes(self) -> List[dict]:
        return []

    # ---- placement groups ----
    def create_placement_group(self, bundles, strategy, name="") -> Any:
        raise NotImplementedError

    def remove_placement_group(self, pg_id) -> None:
        raise NotImplementedError

    def placement_group_ready(self, pg_id, timeout=None) -> bool:
        raise NotImplementedError

    def placement_group_table(self) -> Dict[str, dict]:
        return {}

    # ---- lifecycle ----
    @abstractmethod
    def shutdown(self) -> None: ...

    # Context info
    def node_id(self) -> str:
        return "local"

    def is_driver(self) -> bool:
        return True

    # ----- streaming generator returns (num_returns="streaming") ---------
    def stream_next(self, task_id, index: int, timeout: Optional[float] = None):
        """Blocks until item `index` of a streaming task exists; returns
        its ObjectID, or None when the stream ended before `index`."""
        raise NotImplementedError(
            f"{type(self).__name__} does not support streaming returns"
        )

    def stream_done(self, task_id) -> None:
        """Consumer finished/abandoned the stream: release tracking."""
