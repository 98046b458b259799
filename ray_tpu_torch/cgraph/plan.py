"""Static plan construction (the port of ray_tpu/cgraph/plan.py):
type-check and topologically compile a DAG of bound actor-method calls once
into per-actor execution plans.

Re-design of the reference's compiled-DAG preprocessing (reference:
compiled_dag_node.py _preprocess:904: node and actor assignment, channel
edge discovery, type validation), producing the static structures the
exec loops run. The wire format each actor receives is a plain dict (it
pickles through the normal actor-task path without importing this module
in the worker):

    {
      "dag_id": ..., "capacity": ..., "max_message": ...,
      "nodes": [  # global topo order, restricted to this actor
        {"node_id", "method" (None => collective), "desc",
         "reads":  [{"edge_id", "src_node"}],   # channel in-edges
         "writes": [edge_id, ...],              # channel out-edges
         "args"/"kwargs" with ("__dag_ref__", nid) placeholders,
         "collective": {"kind", "group", "reduce_op", "src_rank"}?,
         "coll_sends": [{"group", "dst_rank"}]?}
      ],
      "in_edges": [...], "out_edges": [...],
    }

Ring capacities are checked up front against a declared message size
(core/channel.py `validate_capacity`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

from ..dag import ClassMethodNode, DAGNode, InputNode, MultiOutputNode
from .communicator import CollectiveNode, Communicator


@dataclasses.dataclass
class CommPlan:
    """One gang's communicator binding: group name + members by rank."""

    group_name: str
    member_actors: List[str]  # actor id hex, rank == position

    def build(self, handles: Dict[str, Any]) -> Communicator:
        return Communicator(
            self.group_name, [handles[a] for a in self.member_actors]
        )


@dataclasses.dataclass
class GraphPlan:
    """The compiled-once static plan the driver wires channels from."""

    dag_id: str
    capacity: int
    max_message: int
    inputs: List[DAGNode]  # InputNode objects, execute() arg order
    input_edges: List[Tuple[str, int]]  # (edge_id, input_node_id) driver writes
    output_order: List[int]  # node ids, one per DAG output position
    out_edge_ids: Dict[int, str]  # distinct output node -> driver edge
    is_multi_output: bool
    actor_plans: Dict[str, dict]  # actor hex -> wire dict
    handles: Dict[str, Any]  # actor hex -> handle
    comms: List[CommPlan]

    def edge_label(self, edge_id: str) -> str:
        """Short per-edge label for metrics (bounded cardinality per run)."""
        return edge_label(self.dag_id, edge_id)


def edge_label(dag_id: str, edge_id: str) -> str:
    """THE per-edge metrics label. Single definition: driver-side writers
    (compile.py) and actor-side writers (wire plans' `edge_labels`) must
    emit identical `channel` tag values or one physical edge splits into
    two series."""
    return edge_id.replace(dag_id, dag_id[:6], 1) if dag_id else edge_id


def _resolve_actor(
    n: DAGNode, node_actor: Dict[int, str], handles: Dict[str, Any]
) -> str:
    """Assigns node `n` to its hosting actor (topo order guarantees
    upstreams are already assigned)."""
    if isinstance(n, ClassMethodNode):
        ahex = n._method._handle._actor_id.hex()
        handles.setdefault(ahex, n._method._handle)
        return ahex
    if isinstance(n, CollectiveNode):
        if n._gang.kind == "p2p":
            ahex = n._dst_handle._actor_id.hex()
            handles.setdefault(ahex, n._dst_handle)
            return ahex
        up = n._upstream_node
        if up._id not in node_actor:
            raise ValueError(
                f"{n._gang.kind} input must be an actor-resident node "
                "(InputNode cannot feed a collective edge directly)"
            )
        return node_actor[up._id]
    raise ValueError(
        "compiled graphs require every compute node to be an actor method "
        "or a collective edge (plain @remote functions have no resident "
        "process to host an exec loop); use .compile() for those"
    )


def build_plan(
    root: DAGNode,
    dag_id: str,
    capacity: int,
    max_message: int = 0,
) -> GraphPlan:
    """Walks the graph once: validates every node, assigns actors, interns
    channel edges, groups collective gangs, and emits per-actor plans."""
    from ..core.channel import validate_capacity

    validate_capacity(capacity, max_message)
    topo = root._topo()
    inputs = [n for n in topo if isinstance(n, InputNode)]

    # ---- node -> actor assignment (the type check pass) -------------------
    node_actor: Dict[int, str] = {}
    handles: Dict[str, Any] = {}
    for n in topo:
        if isinstance(n, InputNode):
            continue
        if isinstance(n, MultiOutputNode):
            if n is not root:
                raise ValueError("MultiOutputNode is only valid as the DAG root")
            continue
        node_actor[n._id] = _resolve_actor(n, node_actor, handles)
    if not handles:
        raise ValueError("DAG has no actor-method nodes to compile")

    # ---- collective gangs -> communicator plans ---------------------------
    gangs: Dict[int, List[CollectiveNode]] = {}
    gang_obj: Dict[int, Any] = {}
    for n in topo:
        if isinstance(n, CollectiveNode):
            gangs.setdefault(n._gang.gang_id, []).append(n)
            gang_obj[n._gang.gang_id] = n._gang
    comms: List[CommPlan] = []
    gang_group: Dict[int, str] = {}
    for k, (gid, members) in enumerate(sorted(gangs.items())):
        gang = gang_obj[gid]
        if len(members) != len(gang.members):
            missing = len(gang.members) - len(members)
            raise ValueError(
                f"{gang.kind} gang is only partially bound into the graph "
                f"({missing} member node(s) unreachable from the root); a "
                "partial gang would deadlock its peers at the collective"
            )
        group_name = f"__cgraph__{dag_id[:8]}_g{k}"
        if gang.kind == "p2p":
            (node,) = members
            up = node._upstream_node
            if up._id not in node_actor:
                raise ValueError(
                    "p2p source must be an actor-resident compute node "
                    "(InputNode cannot feed a p2p edge directly)"
                )
            src_actor = node_actor[up._id]
            dst_actor = node_actor[node._id]
            if src_actor == dst_actor:
                raise ValueError(
                    "p2p edge endpoints are on the same actor; pass the "
                    "value directly instead"
                )
            member_actors = [src_actor, dst_actor]  # src rank 0, dst rank 1
        else:
            member_actors = [node_actor[m._id] for m in gang.members]
            if len(set(member_actors)) != len(member_actors):
                raise ValueError(
                    f"{gang.kind} gang members must live on distinct actors "
                    "(one rank per process); got a repeated actor"
                )
        gang_group[gid] = group_name
        comms.append(CommPlan(group_name, member_actors))

    # ---- per-actor plans + channel edge interning -------------------------
    plans: Dict[str, dict] = {
        a: {
            "dag_id": dag_id,
            "nodes": [],
            "in_edges": [],
            "out_edges": [],
            "capacity": capacity,
            "max_message": max_message,
        }
        for a in handles
    }
    edge_seen: Dict[Tuple[int, str], str] = {}
    input_edges: List[Tuple[str, int]] = []
    entry_by_nid: Dict[int, dict] = {}

    def intern_edge(src: DAGNode, dst_actor: str, node_plan: dict) -> None:
        # One physical channel per (producer, consumer actor): the FIRST
        # consuming node on the actor owns the read (one record per
        # iteration); later consumers resolve the same vals[] slot.
        key = (src._id, dst_actor)
        if key in edge_seen:
            return
        eid = f"{dag_id}:{src._id}->{dst_actor[:8]}"
        edge_seen[key] = eid
        plans[dst_actor]["in_edges"].append({"edge_id": eid, "src_node": src._id})
        node_plan["reads"].append({"edge_id": eid, "src_node": src._id})
        if isinstance(src, InputNode):
            input_edges.append((eid, src._id))

    for n in topo:
        if isinstance(n, (InputNode, MultiOutputNode)):
            continue
        a = node_actor[n._id]
        if isinstance(n, CollectiveNode):
            gang = n._gang
            node_plan = {
                "node_id": n._id,
                "method": None,
                "desc": gang.kind,
                "reads": [],
                "writes": [],
                "args": [],
                "kwargs": {},
            }
            up = n._upstream_node
            if gang.kind == "p2p":
                # The value rides the gang's communicator, not a channel:
                # the producing node sends after compute, this node recvs.
                src_entry = entry_by_nid.get(up._id)
                if src_entry is None:
                    raise ValueError(
                        "p2p source must be an actor-resident compute node"
                    )
                src_entry.setdefault("coll_sends", []).append(
                    {"group": gang_group[gang.gang_id], "dst_rank": 1}
                )
                node_plan["collective"] = {
                    "kind": "p2p_recv",
                    "group": gang_group[gang.gang_id],
                    "src_rank": 0,
                }
            else:
                node_plan["args"] = [("__dag_ref__", up._id)]
                node_plan["collective"] = {
                    "kind": gang.kind,
                    "group": gang_group[gang.gang_id],
                    "reduce_op": gang.reduce_op,
                }
            plans[a]["nodes"].append(node_plan)
            entry_by_nid[n._id] = node_plan
            continue

        node_plan = {
            "node_id": n._id,
            "method": n._method._method_name,
            "desc": n._method._method_name,
            "reads": [],
            "writes": [],
            "args": [],
            "kwargs": {},
        }

        def mark(v):
            if isinstance(v, MultiOutputNode):
                raise ValueError("MultiOutputNode cannot feed another node")
            if isinstance(v, DAGNode):
                if isinstance(v, InputNode) or node_actor[v._id] != a:
                    intern_edge(v, a, node_plan)
                return ("__dag_ref__", v._id)
            return v

        node_plan["args"] = [mark(x) for x in n._bound_args]
        node_plan["kwargs"] = {k: mark(v) for k, v in n._bound_kwargs.items()}
        if not any(
            isinstance(v, DAGNode)
            for v in list(n._bound_args) + list(n._bound_kwargs.values())
        ):
            # An ungated node has no channel read pacing its loop
            # iteration — it would free-run (execute unboundedly, not
            # once per execute()). The reference rejects these too.
            raise ValueError(
                f"node {node_plan['method']!r} consumes no InputNode or "
                "upstream output; every compiled-graph node must be gated "
                "by at least one dataflow edge"
            )
        plans[a]["nodes"].append(node_plan)
        entry_by_nid[n._id] = node_plan

    # ---- DAG outputs: one driver-hosted reader per distinct output --------
    outputs = (
        [x for x in root._bound_args] if isinstance(root, MultiOutputNode) else [root]
    )
    for out in outputs:
        if not isinstance(out, (ClassMethodNode, CollectiveNode)):
            raise ValueError(
                "DAG outputs must be actor-method or collective nodes"
            )
    output_order = [out._id for out in outputs]
    out_edge_ids: Dict[int, str] = {}
    for out in outputs:
        if out._id not in out_edge_ids:
            out_edge_ids[out._id] = f"{dag_id}:{out._id}->driver"

    # Producer-side writes: cross-actor edges + output edges, attached to
    # the producing node so the loop writes right after it runs.
    for a, plan in plans.items():
        for node_plan in plan["nodes"]:
            nid = node_plan["node_id"]
            for (src, dst_actor), eid in edge_seen.items():
                if src == nid:
                    node_plan["writes"].append(eid)
                    plan["out_edges"].append({"edge_id": eid, "src_node": nid})
            if nid in out_edge_ids:
                eid = out_edge_ids[nid]
                node_plan["writes"].append(eid)
                plan["out_edges"].append({"edge_id": eid, "src_node": nid})
        plan["edge_labels"] = {
            e["edge_id"]: edge_label(dag_id, e["edge_id"])
            for e in plan["out_edges"]
        }

    return GraphPlan(
        dag_id=dag_id,
        capacity=capacity,
        max_message=max_message,
        inputs=inputs,
        input_edges=input_edges,
        output_order=output_order,
        out_edge_ids=out_edge_ids,
        is_multi_output=isinstance(root, MultiOutputNode),
        actor_plans=plans,
        handles=handles,
        comms=comms,
    )
