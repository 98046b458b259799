"""The worker's entry to the compiled-graph executor (the port of
ray_tpu/core/dag_exec.py): core/worker_proc.py dispatches the reserved
`__ray_dag_*__` method names through `bind_builtin`; the executor itself
is ray_tpu_torch.cgraph.executor.
"""

from __future__ import annotations

from ..cgraph.executor import DagError, GraphExecutor, bind_builtin  # noqa: F401

__all__ = ["DagError", "GraphExecutor", "bind_builtin"]
