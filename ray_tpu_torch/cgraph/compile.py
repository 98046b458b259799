"""Driver half of the compiled-graph data plane (the port of
ray_tpu/cgraph/compile.py).

Re-design of the reference's CompiledDAG driver object (reference:
compiled_dag_node.py:664 experimental_compile, execute:2118,
CompiledDAGRef; channels shared_memory_channel.py:159). Compilation happens
once: the plan is built (cgraph/plan.py), every cross-process edge gets a
persistent channel, gang communicators initialize on their members, and
each participating actor starts a resident exec loop (cgraph/executor.py).
After that, `execute()` is a channel write and `CompiledRef.get()` a
channel read: no task submission, no GCS round trip and no object-store
traffic per iteration.

`max_inflight` bounds the pipeline depth: execute() reclaims a completed
round before admitting a new one once that many iterations are in the
channels (backpressure against an unbounded producer). Each iteration
counts in `raytpu_cgraph_executions_total` and its execute-to-fetch time in
`raytpu_cgraph_execute_latency_ms` (the `cgraph_execute_p99` watchdog
rule's signal). With tracing on, the graph's one compile-time trace context
rides the wire plan, and the driver's execute and round spans and every
actor's iteration spans share it, chained per iteration by `cg:<dag>:<seq>`
flow ids. A get that times out dumps the flight ring naming the blocked
channel and raises a `cgraph.timeout` trigger. `auto_rebuild=True` rewires
the graph against restarted actors on the next execute after a break.
"""

from __future__ import annotations

import contextlib
import tempfile
import time
import uuid
from typing import Any, Dict, List, Optional, Tuple

from .. import api
from .. import tracing as _tracing
from ..core.channel import ChannelClosed, ChannelReader, ChannelWriter
from ..observability import flight_recorder as _frec
from ..dag import DAGNode
from ..utils import internal_metrics as imet
from .communicator import Communicator
from .executor import DagError
from .plan import GraphPlan, build_plan

DEFAULT_MAX_INFLIGHT = 32


class CompiledRef:
    """Handle to one in-flight compiled-graph execution (reference:
    compiled_dag_node.py CompiledDAGRef). `rt.get(ref)` / `ref.get()`
    blocks on the output channel; results may be fetched out of order
    (later seqs buffer earlier arrivals)."""

    _is_channel_dag_ref = True

    def __init__(self, graph: "CompiledGraph", seq: int, gen: int = 0):
        self._graph = graph
        self._seq = seq
        self._gen = gen

    def get(self, timeout: Optional[float] = None) -> Any:
        return self._graph._fetch(self._seq, timeout, gen=self._gen)


class CompiledGraph:
    """A DAG compiled onto persistent channels + collective edges.

    compile-time: build_plan() type-checks and topologically compiles the
    graph into per-actor plans; actors host readers for their in-edges;
    the driver hosts readers for DAG outputs; gang communicators bind to
    their members; exec loops start; writers attach. Values between nodes
    on the SAME actor never touch a channel; values across a collective
    edge never touch a channel at all.

    Caveat (same as the reference): while compiled, participating actors'
    DAG methods run on the exec-loop thread, outside the actor's normal
    concurrency serialization.
    """

    def __init__(
        self,
        root: DAGNode,
        capacity: int = 8 << 20,
        max_inflight: int = DEFAULT_MAX_INFLIGHT,
        max_message: int = 0,
        auto_rebuild: bool = False,
    ):
        if max_inflight is not None and max_inflight < 1:
            raise ValueError(f"max_inflight must be >= 1, got {max_inflight}")
        self._dag_id = uuid.uuid4().hex
        self._plan: GraphPlan = build_plan(
            root, self._dag_id, int(capacity), int(max_message)
        )
        self._max_inflight = max_inflight
        self._auto_rebuild = bool(auto_rebuild)
        self._gen = 0  # incarnation counter: bumped by every recompile
        self._seq = 0
        self._next_read = 0
        self._buffer: Dict[int, Any] = {}
        self._partial_round: Dict[int, Any] = {}
        self._t0: Dict[int, float] = {}
        self._torn_down = False
        self._broken: Optional[str] = None
        self._handles = self._plan.handles
        # Per-graph labels: cardinality grows with compiles per process
        # lifetime (compiled graphs are long-lived by design — one per
        # pipeline, thousands of iterations each). A driver that churns
        # compiles should reuse graphs, not recompile per iteration.
        self._m_latency = imet.CGRAPH_EXECUTE_LATENCY.labels(graph=self._dag_id[:8])
        self._m_execs = imet.CGRAPH_EXECUTIONS.labels(graph=self._dag_id[:8])
        # Graph trace identity: the exec loops are resident threads — no
        # per-iteration task entry carries a trace_ctx — so the ONE
        # context minted at compile time rides the wire plan instead, and
        # every process's iteration spans share this trace_id. Flow ids
        # are derived per iteration (`cg:<dag>:<seq>`) on both sides.
        self._trace_ctx: Optional[dict] = None
        if _tracing.is_enabled():
            ctx = _tracing.current_context()
            self._trace_ctx = {
                "trace_id": ctx["trace_id"] if ctx else uuid.uuid4().hex,
                "span_id": ctx["span_id"] if ctx else None,
            }

        self._out_readers: List[Tuple[int, ChannelReader]] = []
        self._in_writers: List[Tuple[int, ChannelWriter]] = []
        self._comms: List[Communicator] = []
        self._wire()

    def _wire(self) -> None:
        """Wire up one incarnation: setup (actors host in-edge readers) ->
        driver readers -> communicators -> start (actors attach writers +
        loops) -> driver writers. Called at construction and again by
        recompile() against restarted actors."""
        specs: Dict[str, Any] = {}
        self._out_readers = []
        self._in_writers = []
        self._comms = []
        set_up: List[Any] = []  # actors whose contexts need undo on failure
        try:
            for a, h in self._handles.items():
                actor_plan = self._plan.actor_plans[a]
                if self._trace_ctx is not None:
                    actor_plan = dict(actor_plan, trace_ctx=self._trace_ctx)
                ref = h._invoke(
                    "__ray_dag_setup__",
                    (self._dag_id, actor_plan),
                    {},
                    1,
                )
                set_up.append(h)
                specs.update(api.get(ref, timeout=60))
            tmp = tempfile.gettempdir()
            for nid, eid in self._plan.out_edge_ids.items():
                r = ChannelReader(
                    tmp, capacity=self._plan.capacity, max_message=self._plan.max_message
                )
                specs[eid] = r.spec()
                self._out_readers.append((nid, r))
            for cp in self._plan.comms:
                comm = cp.build(self._handles)
                self._comms.append(comm)
                comm.ensure_initialized()
            for a, h in self._handles.items():
                mine = {
                    e["edge_id"]: specs[e["edge_id"]]
                    for e in self._plan.actor_plans[a]["out_edges"]
                }
                api.get(
                    h._invoke("__ray_dag_start__", (self._dag_id, mine), {}, 1),
                    timeout=60,
                )
            self._in_writers = [
                (
                    input_nid,
                    ChannelWriter(
                        specs[eid], metrics_label=self._plan.edge_label(eid)
                    ),
                )
                for eid, input_nid in self._plan.input_edges
            ]
        except BaseException:
            # A partial compile must not leak contexts/exec threads/ring
            # files on the actors that DID set up (or driver readers).
            for h in set_up:
                try:
                    api.get(
                        h._invoke("__ray_dag_stop__", (self._dag_id,), {}, 1),
                        timeout=10,
                    )
                except Exception:
                    pass  # lint: swallow-ok(unwinding a failed compile; actors may be half-started)
            for comm in self._comms:
                comm.destroy()
            for _, r in self._out_readers:
                r.close()
            raise

    # ------------------------------------------------------------ execution
    @property
    def inflight(self) -> int:
        """Iterations written but not yet drained from the output channels."""
        return self._seq - self._next_read

    def execute(self, *input_values) -> CompiledRef:
        if self._broken and self._auto_rebuild:
            # A participating actor died and the graph tore itself down;
            # with auto-rebuild the next execute() transparently rewires
            # against the restarted actors (max_restarts must cover the
            # death, or recompile fails with the actor's death reason).
            self.recompile()
        if self._torn_down:
            raise RuntimeError("compiled graph was torn down")
        if self._broken:
            raise ChannelClosed(self._broken)
        if len(input_values) != len(self._plan.inputs):
            raise ValueError(
                f"DAG takes {len(self._plan.inputs)} input(s), "
                f"got {len(input_values)}"
            )
        # Pipeline-depth backpressure: reclaim completed rounds into the
        # driver buffer before admitting a new iteration.
        while self._max_inflight is not None and self.inflight >= self._max_inflight:
            self._read_round(timeout=60.0)
        by_input = {
            n._id: v for n, v in zip(self._plan.inputs, input_values)
        }
        span_cm = (
            _tracing.continue_context(
                self._trace_ctx,
                f"cgraph.execute {self._dag_id[:8]}",
                {
                    "dag": self._dag_id[:8],
                    "seq": self._seq,
                    # Tail of the per-iteration flow chain; the actors'
                    # iteration spans step it, the driver's round read
                    # ends it.
                    "flow_out": f"cg:{self._dag_id[:8]}:{self._seq}",
                },
            )
            if self._trace_ctx is not None and _tracing.is_enabled()
            else contextlib.nullcontext()
        )
        with span_cm:
            self._write_inputs(by_input)
        ref = CompiledRef(self, self._seq, self._gen)
        self._t0[self._seq] = time.perf_counter()
        self._m_execs.inc()
        self._seq += 1
        return ref

    def _write_inputs(self, by_input: Dict[int, Any]) -> None:
        for i, (input_nid, w) in enumerate(self._in_writers):
            try:
                w.write(by_input[input_nid], timeout=60.0)
            except ChannelClosed:
                self._broken = (
                    f"compiled graph {self._dag_id[:8]}: input channel closed "
                    "(a participating actor died or the graph was torn down)"
                )
                self.teardown()
                raise ChannelClosed(self._broken)
            except BaseException:
                if i > 0:
                    # Earlier edges were written: actors are now one
                    # iteration out of step — every future result would be
                    # silently mispaired. Fail the DAG loudly (marking it
                    # broken, so auto_rebuild graphs recompile on the
                    # next execute instead of staying dead forever).
                    self._broken = (
                        f"compiled graph {self._dag_id[:8]}: input write "
                        "failed after a partial write; the pipeline is "
                        "desynchronized"
                    )
                    self.teardown()
                    raise RuntimeError(
                        "compiled graph input write failed after a partial "
                        "write; the pipeline is desynchronized and has "
                        "been torn down — recompile the DAG"
                    )
                raise

    def _read_round(self, timeout: Optional[float]) -> None:
        """Drains one full output round (one value per output channel)
        into the driver buffer."""
        # Partial-round state persists across calls: a timeout after
        # reading some output channels must NOT discard those values,
        # or a retried get() would pair channel A's iteration k+1 with
        # channel B's iteration k forever after.
        vals = self._partial_round
        seq = self._next_read
        span_cm = (
            _tracing.continue_context(
                self._trace_ctx,
                f"cgraph.round {self._dag_id[:8]}",
                {
                    "dag": self._dag_id[:8],
                    "seq": seq,
                    # Head of the iteration's flow chain (tail at
                    # execute(), steps at each actor's iteration span).
                    "flow_in": f"cg:{self._dag_id[:8]}:{seq}",
                },
            )
            if self._trace_ctx is not None and _tracing.is_enabled()
            else contextlib.nullcontext()
        )
        try:
            with span_cm:
                for nid, r in self._out_readers:
                    if nid not in vals:
                        vals[nid] = r.read(timeout=timeout)  # None blocks
        except TimeoutError:
            # A stuck execute is exactly what the flight recorder exists
            # for: dump the ring NOW, naming the blocked channel, so the
            # hang is post-mortem-able even if the caller just retries.
            blocked = next(
                (
                    self._plan.edge_label(self._plan.out_edge_ids[nid])
                    for nid, _r in self._out_readers
                    if nid not in vals
                ),
                "?",
            )
            dump_path = _frec.dump(
                reason=(
                    f"cgraph execute timeout: dag {self._dag_id[:8]} seq "
                    f"{seq} blocked on output channel {blocked}"
                ),
                extra={"dag": self._dag_id, "seq": seq, "blocked_channel": blocked},
            )
            dump_note = (
                f"; flight-recorder dump written to {dump_path}"
                if dump_path
                else ""
            )
            from ..observability.postmortem import publish_trigger

            publish_trigger(
                "cgraph.timeout",
                {
                    "dag": self._dag_id[:8],
                    "seq": seq,
                    "blocked_channel": blocked,
                    "dump": dump_path,
                },
                source="cgraph",
            )
            raise TimeoutError(
                f"compiled graph {self._dag_id[:8]}: execute() result for "
                f"seq {seq} not ready after {timeout}s (blocked on channel "
                f"{blocked}{dump_note})"
            )
        except ChannelClosed:
            broken = (
                f"compiled graph {self._dag_id[:8]}: output channel closed "
                "(a participating actor died or the graph was torn down)"
            )
            if self._broken is None:
                self._broken = broken
                # Tear down NOW, not at the user's leisure: surviving
                # actors' exec threads may be wedged inside a gang
                # collective waiting on the dead member — only
                # comm.destroy() (severing the ring) releases them, and
                # the __cgraph__ GCS rank keys must not leak.
                self.teardown()
            raise ChannelClosed(broken)
        self._partial_round = {}
        assembled = [vals[nid] for nid in self._plan.output_order]
        result = assembled if self._plan.is_multi_output else assembled[0]
        t0 = self._t0.pop(self._next_read, None)
        if t0 is not None:
            self._m_latency.observe((time.perf_counter() - t0) * 1e3)
        self._buffer[self._next_read] = result
        self._next_read += 1

    def _fetch(self, seq: int, timeout: Optional[float], gen: int = 0) -> Any:
        if gen != self._gen:
            # The graph was recompiled since this ref was minted: its
            # iteration died with the previous incarnation's channels.
            raise ChannelClosed(
                f"compiled graph {self._dag_id[:8]}: ref from a previous "
                "incarnation (the graph was recompiled after a failure); "
                "re-execute to get a fresh ref"
            )
        while seq not in self._buffer:
            if self._broken and seq >= self._next_read:
                raise ChannelClosed(self._broken)
            self._read_round(timeout)
        result = self._buffer.pop(seq)
        err = None
        if isinstance(result, DagError):
            err = result
        elif isinstance(result, list):
            err = next((v for v in result if isinstance(v, DagError)), None)
        if err is not None:
            raise err.error
        return result

    def teardown(self) -> None:
        if self._torn_down:
            return
        self._torn_down = True
        for h in self._handles.values():
            try:
                api.get(h._invoke("__ray_dag_stop__", (self._dag_id,), {}, 1), timeout=30)
            except Exception:  # lint: swallow-ok(actor may already be dead)
                pass
        for comm in self._comms:
            try:
                comm.destroy()
            except Exception:  # lint: swallow-ok(gang lost a member; teardown must finish)
                pass
        for _, w in self._in_writers:
            w.close()
        for _, r in self._out_readers:
            r.close()

    def recompile(self, timeout: float = 60.0) -> "CompiledGraph":
        """Rebuilds the graph's data plane against the CURRENT actor
        incarnations: fresh channels, fresh communicators, fresh exec
        loops — the same plan, recompiled. This is the recovery path
        after a participating actor died and was restored by
        `max_restarts` (the idempotent teardown already ran, or runs
        here). Pending CompiledRefs from the previous incarnation raise
        ChannelClosed on get(); retried wiring waits up to `timeout` for
        restarting actors to come back."""
        self.teardown()  # idempotent; usually already ran on the failure
        deadline = time.monotonic() + timeout
        last: Optional[BaseException] = None
        while True:
            # Reset iteration state: the new incarnation starts at seq 0
            # (actor-side executors restart their loops from scratch).
            self._torn_down = False
            self._broken = None
            self._seq = 0
            self._next_read = 0
            self._buffer.clear()
            self._partial_round = {}
            self._t0.clear()
            try:
                self._wire()  # cleans up its own partial state on failure
            except BaseException as e:  # noqa: BLE001
                self._torn_down = True
                last = e
                if time.monotonic() >= deadline:
                    # Keep _broken set: an auto_rebuild graph must stay
                    # eligible for another recompile attempt on the next
                    # execute() (e.g. the actor's restore outlived this
                    # timeout), not be dead forever.
                    self._broken = (
                        f"compiled graph {self._dag_id[:8]}: recompile "
                        f"failed: {last!r}"
                    )
                    raise RuntimeError(
                        f"compiled graph {self._dag_id[:8]}: recompile failed "
                        f"after {timeout}s (actors not back?): {last!r}"
                    ) from last
                time.sleep(0.25)
                continue
            self._gen += 1
            _frec.record("cgraph.recompile", (self._dag_id[:8], self._gen))
            return self

    def __enter__(self) -> "CompiledGraph":
        return self

    def __exit__(self, *exc) -> bool:
        self.teardown()
        return False


def compile(
    dag: DAGNode,
    *,
    buffer_size_bytes: int = 8 << 20,
    max_inflight: int = DEFAULT_MAX_INFLIGHT,
    max_message_bytes: int = 0,
    auto_rebuild: bool = False,
) -> CompiledGraph:
    """Compiles a bound actor-method DAG onto the channel data plane
    (reference: dag.experimental_compile). `buffer_size_bytes` sizes each
    ring; `max_message_bytes` (optional) fails compilation up front if a
    declared message could not fit; `max_inflight` bounds pipeline depth;
    `auto_rebuild=True` makes execute() transparently recompile() the
    data plane after a participating actor dies and restarts
    (max_restarts) instead of raising ChannelClosed forever."""
    return CompiledGraph(
        dag,
        capacity=buffer_size_bytes,
        max_inflight=max_inflight,
        max_message=max_message_bytes,
        auto_rebuild=auto_rebuild,
    )
