"""Collective edges and the gang communicator for compiled graphs (the port
of ray_tpu/cgraph/communicator.py).

Re-design of the reference's collective aDAG operations (reference:
python/ray/experimental/collective/allreduce.py AllReduceWrapper.bind: one
output node per input node, all members running the collective inside
their resident exec loop over an out-of-band communicator).

`Communicator` (the JAX package's `TpuCommunicator`) is the compile-time
binding of a collective.py group to an ordered actor gang. Between gangs,
the compiled-graph case, arrays move over the out-of-band collective plane:
collective.py's TCP socket ring. The communicator only brokers the group's
lifecycle (init on every member, destroy at teardown); the data never
touches the driver, the GCS or the object store.

What an edge hands the next node: collective.py stages a torch tensor to
host memory and returns numpy, so an allreduce or reduce_scatter of a CUDA
tensor gives a float32 (a bf16 input widened) or same-dtype numpy array on
the host, and a p2p edge the array (bf16 as float32). The consuming node
moves it back onto its device itself (`torch.from_numpy(x).to("cuda")`).
There is no NCCL edge (ROADMAP Queue 1 item 9).
"""

from __future__ import annotations

import itertools
from typing import Any, List, Optional

from ..dag import DAGNode

_REDUCE_OPS = ("sum", "prod", "max", "min")


class _Gang:
    """One collective op instance shared by its member nodes (the unit a
    communicator is bound to at compile time)."""

    _counter = itertools.count()

    def __init__(self, kind: str, reduce_op: Optional[str]):
        self.kind = kind
        self.reduce_op = reduce_op
        self.members: List["CollectiveNode"] = []
        self.gang_id = next(_Gang._counter)


class CollectiveNode(DAGNode):
    """A collective edge in the graph: consumes one upstream node per gang
    member and produces the collective's result ON THE SAME ACTOR (p2p:
    on the destination actor). Compiled onto the gang's communicator, not
    onto a channel."""

    def __init__(
        self,
        upstream: DAGNode,
        gang: _Gang,
        rank: int,
        dst_handle: Any = None,
    ):
        super().__init__((upstream,), {})
        self._gang = gang
        self._rank = rank
        self._dst_handle = dst_handle  # p2p only: receiving actor

    @property
    def _upstream_node(self) -> DAGNode:
        return self._bound_args[0]

    def _submit(self, args, kwargs):
        raise TypeError(
            "collective nodes only execute inside a compiled graph; call "
            "cgraph.compile(dag) (they have no eager task-submission form)"
        )


class _AllReduceOp:
    """`cgraph.allreduce.bind([n0, n1, ...], op="sum") -> [CollectiveNode]`
    (reference: ray.experimental.collective.allreduce.bind)."""

    kind = "allreduce"

    def bind(self, nodes: List[DAGNode], op: str = "sum") -> List[CollectiveNode]:
        nodes = list(nodes)
        if len(nodes) < 1:
            raise ValueError(f"{self.kind}.bind needs at least one input node")
        if op not in _REDUCE_OPS:
            raise ValueError(f"unknown reduce op {op!r}; one of {_REDUCE_OPS}")
        for n in nodes:
            if not isinstance(n, DAGNode):
                raise TypeError(
                    f"{self.kind}.bind takes DAG nodes, got {type(n).__name__}"
                )
        gang = _Gang(self.kind, op)
        outs = [CollectiveNode(n, gang, i) for i, n in enumerate(nodes)]
        gang.members = outs
        return outs


class _ReduceScatterOp(_AllReduceOp):
    """Each member receives one fully-reduced 1/world_size slice."""

    kind = "reduce_scatter"


class _P2POp:
    """`cgraph.p2p.bind(src_node, dst_actor) -> CollectiveNode` — a
    point-to-point edge carried by a dedicated 2-member communicator
    instead of a serialized channel record. The returned node lives on
    `dst_actor` and yields the transferred value there."""

    kind = "p2p"

    def bind(self, src_node: DAGNode, dst_actor: Any) -> CollectiveNode:
        if not isinstance(src_node, DAGNode):
            raise TypeError("p2p.bind source must be a DAG node")
        if not hasattr(dst_actor, "_actor_id"):
            raise TypeError("p2p.bind destination must be an actor handle")
        gang = _Gang(self.kind, None)
        node = CollectiveNode(src_node, gang, 1, dst_handle=dst_actor)
        gang.members = [node]
        return node


allreduce = _AllReduceOp()
reduce_scatter = _ReduceScatterOp()
p2p = _P2POp()


class Communicator:
    """Binds one collective.py group to an ordered actor gang.

    Created by the compiler (one per gang), initialized before the exec
    loops start, destroyed at teardown. The group rides the reserved
    `__ray_tpu_collective_*__` actor builtins (core/worker_proc.py), so
    membership lives inside each member's worker process, exactly where
    the exec loop runs the collective."""

    def __init__(self, group_name: str, handles: List[Any]):
        self.group_name = group_name
        self.handles = list(handles)  # rank == position
        self._initialized = False

    @property
    def world_size(self) -> int:
        return len(self.handles)

    def ensure_initialized(self, timeout: float = 120.0) -> None:
        if self._initialized:
            return
        from .. import api

        ws = self.world_size
        refs = [
            h._invoke("__ray_tpu_collective_init__", (ws, i, self.group_name), {}, 1)
            for i, h in enumerate(self.handles)
        ]
        api.get(refs, timeout=timeout)
        self._initialized = True

    def destroy(self) -> None:
        if not self._initialized:
            return
        self._initialized = False
        from ..collective import destroy_collective_group_on

        # Fires every member's destroy concurrently and sweeps stale GCS
        # keys; dead members are tolerated (their state died with them).
        destroy_collective_group_on(self.handles, self.group_name)
