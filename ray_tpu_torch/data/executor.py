"""Streaming executor v2: operator actor pools + per-op byte budgets (the
port of ray_tpu/data/executor.py).

The generational successor to `data/streaming.py` (which remains as the
`RAY_TPU_DATA_EXECUTOR=v1` fallback and the bench baseline). Same core
contract — a dedicated scheduling thread, per-operator queues, seq-ordered
block release, furthest-downstream-first scheduling (reference:
python/ray/data/_internal/execution/streaming_executor.py:48,
streaming_executor_state.py:527) — with three structural changes:

- **Operator actor pools.** Each non-fused operator owns an
  `op_pool.OperatorPool` sized dynamically between its declared
  [min, max]: scale-up on sustained "backlogged upstream + starved
  downstream" pressure (the forecast-first ladder in op_pool.py — warm
  worker pools pre-size during the sustain window), scale-down on
  sustained idleness. Fused task stages keep v1's stateless submission.

- **Per-operator byte budgets.** Every operator carries a bounded
  object-store byte budget over its INPUT queue
  (`RAY_TPU_DATA_OP_BUDGET_BYTES`, default 64 MiB). An upstream operator
  may not submit new work while its downstream's input queue is over
  budget — the skewed-operator failure mode (slow middle op, fast
  source) backpressures block production at the source instead of
  accumulating blocks until the store spills. Unknown block sizes count
  at the stream's observed mean (streaming.BlockSizeEstimator), never 0.

- **Drain-first over-budget scheduling.** The optional GLOBAL budget
  keeps v1's drain-only semantics: over budget, only the furthest-
  downstream operator with input may submit — one task — so queued
  bytes drain toward the consumer while progress is still guaranteed.

Consumer stall remains the final backpressure: the bounded output queue
stalls the scheduler, which stops source pulls, which stops read-task
submission — propagation to the source is a test invariant
(tests/test_torch_data.py runs tests/test_data_plane.py's cases on both
packages).
"""

from __future__ import annotations

import queue
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, Iterator, List, Optional

from .. import api
from ..utils import internal_metrics as imet
from ..utils import config
from . import streaming
from .op_pool import OperatorPool, _flight_record
from .streaming import BlockSizeEstimator

_DONE = object()
_GAUGE_INTERVAL_S = 0.5


class PipelineOp:
    """One v2 pipeline stage: either a stateless task stage (`submit`) or
    an actor-pool stage (`pool` + `make_call`)."""

    def __init__(
        self,
        name: str,
        submit: Optional[Callable[[Any], Any]] = None,
        pool: Optional[OperatorPool] = None,
        make_call: Optional[Callable[[Any, Any], Any]] = None,
        cap: int = 4,
        budget_bytes: Optional[int] = None,
    ):
        assert (submit is None) != (pool is None), "exactly one of submit/pool"
        self.name = name
        self._submit = submit
        self.pool = pool
        self._make_call = make_call
        self._cap = max(1, cap)
        self.budget_bytes = (
            config.DATA_OP_BUDGET_BYTES if budget_bytes is None else budget_bytes
        )
        self.inqueue: deque = deque()
        # Seq-ordered release (v1 invariant kept): blocks hand off
        # downstream in input order even when tasks complete out of order.
        self.pending: Dict[int, Any] = {}
        self.done: Dict[int, Any] = {}
        self.next_seq = 0
        self.next_out = 0
        self.outqueue: deque = deque()
        # Bytes currently queued at this op (inqueue + outqueue),
        # maintained INCREMENTALLY by the executor's charge/discharge at
        # queue transitions — a per-tick scan of every queued ref was the
        # v1 global-budget cost this plane must not pay per operator.
        self.queued_bytes = 0
        self.started = False
        self.tasks_started = 0
        self.tasks_finished = 0
        self.backpressure_events = 0
        self._blocked = False  # transition edge for the backpressure counter

    @property
    def cap(self) -> int:
        return self.pool.capacity if self.pool is not None else self._cap

    @property
    def inflight(self) -> List[Any]:
        return list(self.pending.values())

    def start(self) -> None:
        if self.pool is not None:
            self.pool.start()
        self.started = True

    def submit_one(self) -> None:
        ref = self.inqueue.popleft()
        if self.pool is not None:
            out = self.pool.submit(lambda a, r=ref: self._make_call(a, r))
        else:
            out = self._submit(ref)
        self.pending[self.next_seq] = out
        self.next_seq += 1
        self.tasks_started += 1
        imet.DATA_OP_TASKS.inc(operator=self.name)

    def task_done(self, ref: Any) -> None:
        if self.pool is not None:
            self.pool.task_done(ref)

    def end(self) -> None:
        if self.pool is not None:
            self.pool.shutdown(inflight=self.inflight)

    def note_blocked(self, blocked: bool) -> None:
        """Counts ENTRIES into the blocked-on-downstream-budget state (one
        event per stall, not one per scheduler tick)."""
        if blocked and not self._blocked:
            self.backpressure_events += 1
            imet.DATA_BACKPRESSURE.inc(operator=self.name)
            _flight_record("data.backpressure", self.name)
        self._blocked = blocked


class PipelineExecutor:
    """Runs a chain of PipelineOps over a lazy source of block refs."""

    def __init__(
        self,
        source: Iterator[Any],
        ops: List[PipelineOp],
        prefetch: int = 8,
        memory_budget: Optional[int] = None,
    ):
        self._source = source
        self._source_done = False
        self._ops = ops
        self._prefetch = max(1, prefetch)
        self._budget = memory_budget
        self._sizer = BlockSizeEstimator()
        # Sizing capability, probed ONCE: with the stock nbytes helper and
        # no sizable store (local mode), no ref can EVER resolve a size —
        # every charge would be 0 and the budget gates vacuous — so the
        # whole accounting path is skipped rather than paying a failing
        # probe chain per queued ref per tick. A monkeypatched
        # streaming.block_nbytes (tests injecting synthetic sizes)
        # re-enables it.
        self._sizing = (
            streaming.block_nbytes is not streaming._BLOCK_NBYTES_DEFAULT
            or streaming.store_sizer() is not None
        )
        # id(ref) -> known size: each block's size is observed ONCE
        # (repeat lookups would also skew the observed mean).
        self._size_cache: Dict[int, int] = {}
        # id(ref) -> bytes charged to the op currently holding it.
        self._charged: Dict[int, int] = {}
        self._queued_total = 0
        # Pools get pressure ticks only if any op HAS a pool — fused-only
        # pipelines (the common case) skip the pass entirely.
        self._has_pools = any(op.pool is not None for op in ops)
        self._out: "queue.Queue" = queue.Queue(maxsize=self._prefetch)
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        self._last_gauge = 0.0
        self.stats: Dict[str, Any] = {"peak_queued_bytes": 0, "source_pulled": 0}
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="data-pipeline-exec"
        )

    # ---------------------------------------------------------------- public
    def run_iter(self) -> Iterator[Any]:
        """Starts the scheduling thread; yields output block refs. Closing
        the generator (consumer stops early) stops the executor and tears
        down stage resources (operator pools)."""
        self._thread.start()
        try:
            while True:
                item = self._out.get()
                if item is _DONE:
                    if self._error is not None:
                        raise self._error
                    return
                yield item
        finally:
            self._stop.set()
            try:
                while True:
                    self._out.get_nowait()
            except queue.Empty:
                pass

    # ------------------------------------------------------------ accounting
    def _ref_size(self, ref: Any) -> int:
        key = id(ref)
        size = self._size_cache.get(key)
        if size is not None:
            return size
        # Module-attr lookup (not a bound reference): a block_nbytes
        # monkeypatch applied mid-iteration must still take effect.
        known = streaming.block_nbytes(ref)
        if known:
            self._sizer.observe(known)
            if len(self._size_cache) > 4096:
                self._size_cache.clear()
            self._size_cache[key] = known
            return known
        return self._sizer.mean

    def _charge(self, op: PipelineOp, ref: Any) -> None:
        """Accounts `ref` against `op`'s queues as it enters one. The
        estimate at ENTRY time is what the matching discharge reverses —
        and since every stage hand-off re-charges, an unknown size
        (charged at the observed mean, never 0) self-corrects once the
        store learns the real one."""
        if not self._sizing:
            return
        size = self._ref_size(ref)
        if size:
            self._charged[id(ref)] = size
            op.queued_bytes += size
            self._queued_total += size
            if self._queued_total > self.stats["peak_queued_bytes"]:
                self.stats["peak_queued_bytes"] = self._queued_total

    def _discharge(self, op: PipelineOp, ref: Any) -> None:
        if not self._charged:
            return
        size = self._charged.pop(id(ref), 0)
        if size:
            op.queued_bytes -= size
            self._queued_total -= size

    # ------------------------------------------------------------- the loop
    def _run(self) -> None:
        ops = self._ops
        try:
            for op in ops:
                op.start()
            # Start the gauge clock NOW, not at 0.0 — otherwise the first
            # tick of every pipeline (even sub-interval ones) pays a full
            # gauge pass on top of the forced final one.
            self._last_gauge = time.monotonic()
            # A pipeline using NONE of the v2 machinery (no sizable
            # store, no pool ops — the trivial-pipeline case the overhead
            # bench pins) runs the v1-shape tick with zero extra calls.
            plain = not self._sizing and not self._has_pools
            while not self._stop.is_set():
                progressed = self._poll_completions()
                self._transfer()
                progressed |= self._emit_outputs(block=plain)
                progressed |= self._schedule()
                if not plain:
                    self._update_pools()
                    self._maybe_gauge()
                if self._all_done():
                    break
                if not progressed:
                    self._wait_any()
            self._put_out(_DONE)
        except BaseException as e:  # noqa: BLE001
            self._error = e
            self._put_out(_DONE)
        finally:
            for op in ops:
                if op.started:
                    try:
                        op.end()
                    except Exception:
                        from ..observability.logs import get_logger

                        get_logger("data").warning(
                            "pipeline operator teardown failed", exc_info=True
                        )
            self._maybe_gauge(force=True)

    def _pull_source(self, want: int) -> None:
        first = self._ops[0]
        sizing = self._sizing
        pulled = 0
        while not self._source_done and want > pulled:
            try:
                ref = next(self._source)
            except StopIteration:
                self._source_done = True
                break
            first.inqueue.append(ref)
            if sizing:
                self._charge(first, ref)
            pulled += 1
        if pulled:
            self.stats["source_pulled"] += pulled

    def _poll_completions(self) -> bool:
        moved = False
        sizing = self._sizing
        for op in self._ops:
            if not op.pending:
                continue
            refs = list(op.pending.values())
            done, _ = api.wait(refs, num_returns=len(refs), timeout=0)
            if done:
                done_ids = {id(r) for r in done}
                pooled = op.pool is not None
                for seq in [s for s, r in op.pending.items() if id(r) in done_ids]:
                    ref = op.pending.pop(seq)
                    op.done[seq] = ref
                    if pooled:
                        op.task_done(ref)
                op.tasks_finished += len(done)
            released = 0
            while op.next_out in op.done:
                out_ref = op.done.pop(op.next_out)
                op.outqueue.append(out_ref)
                if sizing:
                    self._charge(op, out_ref)
                op.next_out += 1
                released += 1
                moved = True
            if released:
                imet.DATA_OP_BLOCKS.inc(released, operator=op.name)
        return moved

    def _transfer(self) -> None:
        sizing = self._sizing
        for i, op in enumerate(self._ops[:-1]):
            nxt = self._ops[i + 1]
            while op.outqueue:
                ref = op.outqueue.popleft()
                nxt.inqueue.append(ref)
                if sizing:
                    # Discharge + re-charge (not a counter move): the
                    # re-charge re-estimates, picking up sizes the store
                    # has since learned for blocks first charged at the
                    # mean.
                    self._discharge(op, ref)
                    self._charge(nxt, ref)

    def _put_out(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._out.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _emit_outputs(self, block: bool = True) -> bool:
        emitted = False
        last = self._ops[-1]
        sizing = self._sizing
        while last.outqueue:
            ref = last.outqueue[0]
            if block:
                if not self._put_out(ref):
                    return emitted
            else:
                # Non-wedging emit: a slow consumer must not trap the
                # scheduler inside a blocking put — pool idle-decay and
                # gauge ticks have to keep running exactly when the
                # pipeline is consumer-bound (the pool IS idle then).
                try:
                    self._out.put(ref, timeout=0.05)
                except queue.Full:
                    return emitted
            last.outqueue.popleft()
            if sizing:
                self._discharge(last, ref)
            emitted = True
        return emitted

    def _schedule(self) -> bool:
        """Furthest-downstream-first with two gates on every submission:

        - per-op budget: op i may not submit while op i+1's input queue
          is over op i+1's byte budget (its output would land there);
        - global drain-only mode (optional total budget): over budget,
          only the furthest-downstream op with input submits one task.
        """
        drain_only = bool(self._budget) and self._queued_total > self._budget
        # With sizing off every queued_bytes is 0, so no budget gate can
        # ever close — skip the per-op gating arithmetic entirely.
        sizing = self._sizing
        submitted = False
        for idx in range(len(self._ops) - 1, -1, -1):
            op = self._ops[idx]
            cap = op.cap
            if sizing:
                downstream = (
                    self._ops[idx + 1] if idx + 1 < len(self._ops) else None
                )
                gated = (
                    downstream is not None
                    and downstream.queued_bytes > downstream.budget_bytes
                )
            else:
                gated = False
            if idx == 0 and not drain_only:
                room = cap - len(op.inqueue) - len(op.pending)
                if not sizing or op.queued_bytes <= op.budget_bytes:
                    self._pull_source(room)
            if sizing:
                op.note_blocked(
                    gated and bool(op.inqueue) and len(op.pending) < cap
                )
            if gated:
                continue
            while op.inqueue and len(op.pending) < cap:
                if sizing:
                    self._discharge(op, op.inqueue[0])
                op.submit_one()
                submitted = True
                if drain_only:
                    return True
            if drain_only and submitted:
                return True
        if drain_only and not submitted and not any(
            op.pending or op.inqueue for op in self._ops
        ):
            # Everything queued is outqueue bytes waiting on the consumer;
            # admit fresh source work only if stage 0 can hold it
            # (progress guarantee — v1 semantics).
            first = self._ops[0]
            self._pull_source(1 if not first.inqueue else 0)
            if first.inqueue and len(first.pending) < first.cap:
                self._discharge(first, first.inqueue[0])
                first.submit_one()
                submitted = True
        return submitted

    def _update_pools(self) -> None:
        """Feeds each pool its tick pressure pair (see op_pool.py)."""
        if not self._has_pools:
            return
        n = len(self._ops)
        for idx, op in enumerate(self._ops):
            if op.pool is None:
                continue
            backlogged = bool(op.inqueue) and len(op.pending) >= op.cap
            if idx + 1 < n:
                nxt = self._ops[idx + 1]
                starved = not nxt.inqueue and not nxt.pending
            else:
                starved = self._out.qsize() == 0
            op.pool.update_pressure(backlogged, starved)

    def _maybe_gauge(self, force: bool = False) -> None:
        if not self._sizing and not self._has_pools:
            return  # nothing was ever charged; every gauge would be 0
        now = time.monotonic()
        if not force and now - self._last_gauge < _GAUGE_INTERVAL_S:
            return
        self._last_gauge = now
        try:
            for op in self._ops:
                imet.DATA_OP_QUEUED_BYTES.set(
                    float(op.queued_bytes), operator=op.name
                )
        except Exception:  # lint: swallow-ok(metrics must not break the data plane)
            pass

    def _all_done(self) -> bool:
        if not self._source_done:
            return False
        return all(
            not op.inqueue and not op.pending and not op.done and not op.outqueue
            for op in self._ops
        )

    def _wait_any(self) -> None:
        all_inflight = [r for op in self._ops for r in op.pending.values()]
        if not all_inflight:
            if self._ops[-1].outqueue:
                # Consumer-bound endgame under non-blocking emit: nothing
                # in flight, outputs parked on a full consumer queue. Pace
                # the tick loop instead of spinning.
                time.sleep(0.05)
            return
        try:
            api.wait(all_inflight, num_returns=1, timeout=0.2)
        except Exception:  # lint: swallow-ok(bounded idle wait; completion poll follows)
            pass
