"""Lazy task/actor DAGs: bind() graphs executed over the object plane (the
port of ray_tpu/dag.py).

Re-design of the reference's DAG API (reference: python/ray/dag/dag_node.py
DAGNode.bind/execute; function_node.py, class_node.py;
compiled_dag_node.py:664 experimental_compile). The authoring surface
matches: `fn.bind(x)`, `actor.method.bind(node)`, `MultiOutputNode`,
`dag.execute(input)`.

Two compilation tiers:

- `compile()` caches the topological plan so repeated execute() calls
  skip graph traversal; intermediate results flow by ObjectRef (zero
  serialization of values through the driver) but every hop still pays
  task submission.
- `experimental_compile()` hands the graph to the compiled-graph
  subsystem (cgraph/: one persistent channel per edge, a resident exec
  loop per actor, on the cluster runtime).
"""

from __future__ import annotations

import itertools
from typing import Any, Dict, List, Tuple


class DAGNode:
    """A lazily-bound call in the graph (reference: dag_node.py)."""

    _counter = itertools.count()

    def __init__(self, args: Tuple[Any, ...], kwargs: Dict[str, Any]):
        self._bound_args = args
        self._bound_kwargs = kwargs
        self._id = next(DAGNode._counter)

    # ---- graph structure ----
    def _upstream(self) -> List["DAGNode"]:
        ups = [a for a in self._bound_args if isinstance(a, DAGNode)]
        ups += [v for v in self._bound_kwargs.values() if isinstance(v, DAGNode)]
        return ups

    def _topo(self) -> List["DAGNode"]:
        order: List[DAGNode] = []
        seen = set()

        def visit(node: "DAGNode"):
            if node._id in seen:
                return
            seen.add(node._id)
            for up in node._upstream():
                visit(up)
            order.append(node)

        visit(self)
        return order

    # ---- execution ----
    def _submit(self, resolved_args, resolved_kwargs):
        raise NotImplementedError

    def execute(self, *input_values) -> Any:
        """Executes the DAG; returns ObjectRef(s) for this node's output
        (reference: dag_node.py execute). Intermediate values never pass
        through the driver — they flow as ObjectRefs between tasks."""
        return self.compile().execute(*input_values)

    def compile(self) -> "CompiledDAG":
        """Pre-plans the submission order (reference:
        experimental_compile — here the plan cache; the data plane is
        already the shared-memory object store)."""
        return CompiledDAG(self)

    def experimental_compile(self, buffer_size_bytes: int = 8 << 20, max_inflight: int = 32,
                             max_message_bytes: int = 0):
        """Compiles an actor-method DAG onto the compiled-graph data plane:
        preallocated channels, a resident exec loop on every participating
        actor, bounded pipeline depth; `execute()` in steady state is a
        channel write and a read, no task submitted (reference:
        compiled_dag_node.py:664 experimental_compile, execute:2118)."""
        from .cgraph.compile import CompiledGraph

        return CompiledGraph(self, capacity=buffer_size_bytes, max_inflight=max_inflight,
                             max_message=max_message_bytes)


class InputNode(DAGNode):
    """The DAG's runtime input placeholder (reference: input_node.py)."""

    def __init__(self):
        super().__init__((), {})

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


class FunctionNode(DAGNode):
    def __init__(self, remote_fn, args, kwargs):
        super().__init__(args, kwargs)
        self._fn = remote_fn

    def _submit(self, args, kwargs):
        return self._fn.remote(*args, **kwargs)


class ClassMethodNode(DAGNode):
    def __init__(self, actor_method, args, kwargs):
        super().__init__(args, kwargs)
        self._method = actor_method

    def _submit(self, args, kwargs):
        return self._method.remote(*args, **kwargs)


class MultiOutputNode(DAGNode):
    """Bundles several leaves as the DAG output (reference:
    output_node.py MultiOutputNode)."""

    def __init__(self, outputs: List[DAGNode]):
        super().__init__(tuple(outputs), {})

    def _submit(self, args, kwargs):
        return list(args)


class CompiledDAG:
    """A cached topological plan over the graph."""

    def __init__(self, root: DAGNode):
        self._root = root
        self._plan = root._topo()
        self._inputs = [n for n in self._plan if isinstance(n, InputNode)]

    def execute(self, *input_values) -> Any:
        if len(input_values) != len(self._inputs):
            raise ValueError(
                f"DAG takes {len(self._inputs)} input(s), got {len(input_values)}"
            )
        results: Dict[int, Any] = {
            node._id: val for node, val in zip(self._inputs, input_values)
        }

        def resolve(a):
            return results[a._id] if isinstance(a, DAGNode) else a

        for node in self._plan:
            if isinstance(node, InputNode):
                continue
            args = tuple(resolve(a) for a in node._bound_args)
            kwargs = {k: resolve(v) for k, v in node._bound_kwargs.items()}
            results[node._id] = node._submit(args, kwargs)
        return results[self._root._id]


def __getattr__(name: str):
    # The compiled-graph classes live in cgraph/ and resolve lazily (a
    # module-level import would cycle: cgraph.compile imports this module
    # for the node types).
    if name in ("CompiledGraph", "CompiledRef"):
        from .cgraph.compile import CompiledGraph, CompiledRef

        return {"CompiledGraph": CompiledGraph, "CompiledRef": CompiledRef}[name]
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
