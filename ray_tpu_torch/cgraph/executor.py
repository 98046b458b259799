"""Actor-side compiled-graph execution: channels in, user methods (or
collective ops), channels out (the port of ray_tpu/cgraph/executor.py).

Re-design of the reference's worker exec loop for compiled graphs
(reference: python/ray/dag/compiled_dag_node.py:133 do_exec_tasks, a
long-running framework task on each participating actor that loops {read
input channels, run the bound method, write output channels}, so a graph
in steady state submits no task). Here the loop runs on a daemon thread
inside the actor's worker process, so the actor stays responsive to normal
calls, and the worker's main thread keeps answering the raylet and binding
SIGUSR2 while the loop blocks on a channel. The framework entry points ride
the normal actor-task path under the reserved `__ray_dag_*__` method names,
which the worker dispatches to this module (`bind_builtin`) instead of the
user instance.

Collective nodes (plan entries with a "collective" spec) run their op on
the gang's collective group: arrays move over collective.py's socket ring,
never through a channel record (cgraph/communicator.py says what comes out
of such an edge). A tensor written to a channel travels by the object
plane's rule (core/channel.py).
"""

from __future__ import annotations

import contextlib
import tempfile
import threading
import traceback
from typing import Any, Dict

from .. import tracing as _tracing
from ..core.channel import ChannelClosed, ChannelReader, ChannelWriter
from ..observability import flight_recorder as _frec


class DagError:
    """An exception captured at one node, forwarded through downstream
    channels so every consumer (and finally the driver) sees it without
    wedging the pipeline (reference: compiled_dag_node.py error
    propagation via channel writes)."""

    __slots__ = ("error", "node_desc", "tb")

    def __init__(self, error: BaseException, node_desc: str, tb: str):
        self.error = error
        self.node_desc = node_desc
        self.tb = tb


def _run_gang_collective(coll: dict, args, err, desc: str) -> Any:
    """allreduce / reduce_scatter with an error-status lap first.

    A member whose upstream failed cannot simply skip the collective —
    its peers would block in the ring exchange forever. So every
    iteration first allreduces a 1-element error flag (op=max): if ANY
    member saw a DagError, ALL members skip the data collective in
    lockstep and forward an error instead (the original on the failing
    member; a peer-failure marker elsewhere). One tiny extra lap per
    gang iteration buys deadlock-freedom."""
    import numpy as np

    from .. import collective

    flag = collective.allreduce(
        np.array([1.0 if err is not None else 0.0]),
        group_name=coll["group"],
        op="max",
    )
    if float(flag[0]) > 0.0:
        return err or DagError(
            RuntimeError(
                f"a {coll['kind']} gang peer failed upstream; its node's "
                "error is on that member's output edge"
            ),
            desc,
            "",
        )
    op = (
        collective.allreduce
        if coll["kind"] == "allreduce"
        else collective.reduce_scatter
    )
    return op(args[0], group_name=coll["group"], op=coll["reduce_op"])


def _run_p2p_recv(coll: dict) -> Any:
    from .. import collective

    v = collective.recv(coll["src_rank"], group_name=coll["group"])
    # collective.send wraps arbitrary objects (e.g. a forwarded
    # DagError) in a 0-d object array; unwrap transparently.
    import numpy as np

    if isinstance(v, np.ndarray) and v.dtype == object and v.ndim == 0:
        return v.item()
    return v


class GraphExecutor:
    """One compiled graph's state inside one actor process."""

    def __init__(self, inst: Any, plan: dict):
        self.inst = inst
        self.plan = plan
        self.readers: Dict[str, ChannelReader] = {}
        self.writers: Dict[str, ChannelWriter] = {}
        self.stop = threading.Event()
        self.thread: threading.Thread = None

    def setup(self) -> Dict[str, Any]:
        """Hosts a reader channel per in-edge; returns their specs."""
        tmp = tempfile.gettempdir()
        specs = {}
        for e in self.plan["in_edges"]:
            r = ChannelReader(
                tmp,
                capacity=self.plan["capacity"],
                max_message=self.plan.get("max_message", 0),
            )
            self.readers[e["edge_id"]] = r
            specs[e["edge_id"]] = r.spec()
        return specs

    def start(self, writer_specs: Dict[str, Any]) -> None:
        labels = self.plan.get("edge_labels", {})
        self.writers = {
            e["edge_id"]: ChannelWriter(
                writer_specs[e["edge_id"]],
                metrics_label=labels.get(e["edge_id"], e["edge_id"]),
            )
            for e in self.plan["out_edges"]
        }
        self.thread = threading.Thread(
            target=self._loop, daemon=True, name=f"cgraph-{self.plan['dag_id'][:8]}"
        )
        self.thread.start()

    def teardown(self) -> None:
        self.stop.set()
        for r in self.readers.values():
            r.close()
        for w in self.writers.values():
            w.close()

    # ------------------------------------------------------------- the loop
    def _loop(self) -> None:
        """One iteration = one DAG execution. Reads/writes interleave PER
        NODE in topo order (not read-all-then-run-all): an actor whose
        later node consumes a value derived from its earlier node's output
        via another actor (A->B->A) would deadlock under phase-batched
        reads. All channels are FIFO, so iteration k's values line up
        across the whole DAG without sequence numbers."""
        nodes = self.plan["nodes"]
        dag8 = self.plan["dag_id"][:8]
        trace_ctx = self.plan.get("trace_ctx")
        seq = 0
        while not self.stop.is_set():
            # Iteration span (channel-wait / compute / collective
            # sub-spans inside _iterate), sharing the graph's compile-time
            # trace_id and stepping the per-iteration flow chain. Tracing
            # off = one None check per iteration.
            traced = trace_ctx is not None and _tracing.is_enabled()
            iter_cm = (
                _tracing.continue_context(
                    trace_ctx,
                    f"cgraph.iter {dag8}",
                    {"dag": dag8, "seq": seq, "flow_step": f"cg:{dag8}:{seq}"},
                )
                if traced
                else contextlib.nullcontext()
            )
            try:
                with iter_cm:
                    self._iterate(nodes, traced)
            except (ChannelClosed, OSError):
                break  # teardown raced a blocked read/write
            except Exception:  # noqa: BLE001
                # Unexpected framework-side failure (malformed plan, pickle
                # bug, ...): the cascade below surfaces only ChannelClosed
                # to the driver, so record the real cause where an operator
                # can find it before breaking — and dump the flight ring:
                # the last recorded events name the node/channel involved.
                from ..observability.logs import get_logger

                get_logger("cgraph").error(
                    "[cgraph %s] exec loop died:\n%s",
                    self.plan["dag_id"][:8],
                    traceback.format_exc(),
                )
                _frec.dump(
                    reason=f"cgraph exec loop crash (dag {dag8}, seq {seq})"
                )
                from ..observability.postmortem import publish_trigger

                publish_trigger(
                    "cgraph.crash",
                    {"dag": dag8, "seq": seq},
                    source="cgraph",
                )
                break
            seq += 1
        # Cascade the shutdown: whatever ended this loop (teardown, a dead
        # upstream actor, a severed collective ring), downstream consumers
        # and ultimately the driver must observe ChannelClosed instead of
        # blocking forever on edges this actor will never write again.
        self.teardown()

    def _iterate(self, nodes, traced: bool) -> None:
        """One DAG iteration; sub-spans split the time into channel-wait
        vs compute vs collective when tracing is on."""
        span = _tracing.span if traced else _tracing.null_span
        vals: Dict[int, Any] = {}
        for node in nodes:
            if node["reads"]:
                with span(
                    "cgraph.channel_wait", {"node": node.get("desc", "")}
                ):
                    for r in node["reads"]:
                        vals[r["src_node"]] = self.readers[r["edge_id"]].read()
            _frec.record("cgraph.node", node.get("desc") or node.get("method"))
            kind = (
                f"cgraph.collective {node['collective']['kind']}"
                if node.get("collective")
                else f"cgraph.compute {node.get('method', '?')}"
            )
            with span(kind, {"node": node.get("desc", "")}):
                out = self._run_node(node, vals)
            vals[node["node_id"]] = out
            for cs in node.get("coll_sends", ()):
                with span("cgraph.collective send", {"dst_rank": cs["dst_rank"]}):
                    self._coll_send(cs, out)
            for eid in node["writes"]:
                try:
                    self.writers[eid].write(out)
                except (ChannelClosed, OSError):
                    raise
                except Exception as e:  # noqa: BLE001
                    # Oversize record / unpicklable result: the
                    # execution must still produce SOMETHING on
                    # this edge or the whole DAG wedges — forward
                    # a DagError instead (it is small and
                    # picklable).
                    self.writers[eid].write(
                        DagError(e, node.get("desc", ""), traceback.format_exc())
                    )

    def _coll_send(self, cs: dict, out: Any) -> None:
        from .. import collective

        collective.send(out, cs["dst_rank"], group_name=cs["group"])

    def _run_node(self, node: dict, vals: Dict[int, Any]) -> Any:
        def resolve(a):
            if isinstance(a, tuple) and len(a) == 2 and a[0] == "__dag_ref__":
                return vals[a[1]]
            return a

        args = [resolve(a) for a in node["args"]]
        kwargs = {k: resolve(v) for k, v in node["kwargs"].items()}
        err = next(
            (v for v in list(args) + list(kwargs.values()) if isinstance(v, DagError)),
            None,
        )
        coll = node.get("collective")
        try:
            if coll is not None and coll["kind"] in ("allreduce", "reduce_scatter"):
                # Gang ops run even on error input (status lap keeps the
                # gang in lockstep) — see _run_gang_collective.
                return _run_gang_collective(coll, args, err, node.get("desc", ""))
            if err is not None:
                # An upstream failure short-circuits this node and forwards.
                return err
            if coll is not None:
                return _run_p2p_recv(coll)
            method = getattr(self.inst, node["method"])
            return method(*args, **kwargs)
        except BaseException as e:  # noqa: BLE001
            return DagError(
                e, node.get("desc", node.get("method") or "?"), traceback.format_exc()
            )


# Per-worker-process registry: dag_id -> executor.
_CONTEXTS: Dict[str, GraphExecutor] = {}
_LOCK = threading.Lock()


def bind_builtin(inst: Any, name: str):
    """Resolves a reserved `__ray_dag_*__` method name to a framework
    callable bound to this actor instance (the worker's dispatch calls
    this instead of getattr on the user object)."""

    def _setup(dag_id: str, plan: dict):
        ctx = GraphExecutor(inst, plan)
        with _LOCK:
            old = _CONTEXTS.pop(dag_id, None)
            _CONTEXTS[dag_id] = ctx
        if old is not None:
            old.teardown()
        return ctx.setup()

    def _start(dag_id: str, writer_specs: dict):
        with _LOCK:
            ctx = _CONTEXTS.get(dag_id)
        if ctx is None:
            raise RuntimeError(f"dag {dag_id} was never set up on this actor")
        ctx.start(writer_specs)
        return True

    def _stop(dag_id: str):
        with _LOCK:
            ctx = _CONTEXTS.pop(dag_id, None)
        if ctx is not None:
            ctx.teardown()
        return True

    table = {
        "__ray_dag_setup__": _setup,
        "__ray_dag_start__": _start,
        "__ray_dag_stop__": _stop,
    }
    try:
        return table[name]
    except KeyError:
        raise AttributeError(f"unknown DAG builtin {name!r}")
