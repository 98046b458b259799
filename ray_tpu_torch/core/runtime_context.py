"""Execution context introspection: ray.get_runtime_context() equivalent
(copy of ray_tpu/core/runtime_context.py for the PyTorch port).

Re-design of the reference's RuntimeContext (reference:
python/ray/runtime_context.py RuntimeContext.get_node_id/get_task_id/
get_actor_id): a contextvar carries the currently-executing task's ids —
contextvars propagate correctly into both the threaded-actor pool and the
async-actor event loop, unlike a bare thread-local.
"""

from __future__ import annotations

import contextvars
from dataclasses import dataclass
from typing import Optional

_current_task: contextvars.ContextVar = contextvars.ContextVar(
    "ray_tpu_torch_current_task", default=None
)


def set_task_context(task_id: Optional[str], actor_id: Optional[str]) -> object:
    """Worker-side: marks the task being executed. Returns a token for reset."""
    return _current_task.set({"task_id": task_id, "actor_id": actor_id})


def reset_task_context(token: object) -> None:
    _current_task.reset(token)


@dataclass
class RuntimeContext:
    """Snapshot of this process's execution context."""

    node_id: Optional[str]
    worker_id: Optional[str]
    namespace: Optional[str]

    def get_node_id(self) -> Optional[str]:
        return self.node_id

    def get_worker_id(self) -> Optional[str]:
        return self.worker_id

    def get_task_id(self) -> Optional[str]:
        ctx = _current_task.get()
        return ctx["task_id"] if ctx else None

    def get_actor_id(self) -> Optional[str]:
        ctx = _current_task.get()
        return ctx["actor_id"] if ctx else None

    @property
    def was_current_actor_reconstructed(self) -> bool:
        return False  # restart counts live in the GCS actor table


def get_runtime_context() -> RuntimeContext:
    from .runtime_base import maybe_runtime

    rt = maybe_runtime()
    return RuntimeContext(
        node_id=getattr(rt, "_node_id", None) if rt is not None else None,
        worker_id=getattr(rt, "_worker_id", None) if rt is not None else None,
        namespace=getattr(rt, "_namespace", None) if rt is not None else None,
    )
