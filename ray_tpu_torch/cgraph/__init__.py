"""Compiled graphs: the channel data plane between actor gangs (the port
of ray_tpu/cgraph/).

Re-design of the reference's Compiled Graphs subsystem (reference:
python/ray/dag/compiled_dag_node.py:664 experimental_compile,
python/ray/experimental/channel/* for the channel plane,
python/ray/experimental/collective/* for collective edges). A DAG of bound
actor-method calls is type-checked and topologically compiled once into a
static plan; every cross-process edge gets one persistent channel (the
shared-memory ring of core/channel.py); each participating actor hosts a
resident exec loop; and `compiled.execute(*args)` in steady state is a
channel write plus a channel read, with no GCS round trip and no object-
store traffic per iteration.

Out-of-band collective edges bind a collective group (collective.py) to an
actor gang at compile time through a `Communicator`:
`cgraph.allreduce.bind([...])` / `cgraph.reduce_scatter.bind([...])` /
`cgraph.p2p.bind(node, dst_actor)` move arrays over the collective
transport, collective.py's TCP socket ring (a CUDA tensor staged to host;
numpy comes out), instead of through the driver.

    import ray_tpu_torch as rt
    from ray_tpu_torch.dag import InputNode, MultiOutputNode
    from ray_tpu_torch import cgraph

    with InputNode() as inp:
        shards = [w.grad.bind(inp) for w in workers]
        reduced = cgraph.allreduce.bind(shards)
        dag = MultiOutputNode([w.apply.bind(g) for w, g in zip(workers, reduced)])
    compiled = cgraph.compile(dag, max_inflight=4)
    ref = compiled.execute(batch)
    out = ref.get()
    compiled.teardown()

Compiled graphs run on the cluster runtime (`init()`): the in-process
runtime has no worker process to host an exec loop.
"""

from .compile import CompiledGraph, CompiledRef, compile  # noqa: F401
from .communicator import (  # noqa: F401
    CollectiveNode,
    Communicator,
    allreduce,
    p2p,
    reduce_scatter,
)
from .elastic import ElasticGraph, GangTooSmallError  # noqa: F401
from .plan import GraphPlan, build_plan  # noqa: F401

__all__ = [
    "CompiledGraph",
    "CompiledRef",
    "compile",
    "CollectiveNode",
    "Communicator",
    "allreduce",
    "reduce_scatter",
    "p2p",
    "ElasticGraph",
    "GangTooSmallError",
    "GraphPlan",
    "build_plan",
]
