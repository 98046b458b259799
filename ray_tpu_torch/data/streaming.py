"""Pull-based streaming executor: per-op state machine with backpressure
(the port of ray_tpu/data/streaming.py, the `RAY_TPU_DATA_EXECUTOR=v1`
generation).

Re-design of the reference's streaming execution core (reference:
python/ray/data/_internal/execution/streaming_executor.py:48 — the
dedicated scheduling thread; streaming_executor_state.py:527
select_operator_to_run and :165 OpState; resource_manager.py:285
ReservationOpResourceAllocator; backpressure_policy/
concurrency_cap_backpressure_policy.py). The loop keeps every stage of
the pipeline running concurrently on different blocks:

  - each operator owns an input queue, an in-flight task set (bounded by
    its concurrency cap), and an output queue;
  - completed blocks hand off to the next operator's input queue;
  - scheduling prefers the FURTHEST-DOWNSTREAM runnable operator, which
    drains the pipeline and bounds queued bytes (the reference's policy);
  - a global memory budget over queued block bytes gates upstream
    submission — when exceeded, only the last operator may submit
    (drain-only mode), which is the backpressure half of the reference's
    reservation allocator, sized to this executor's simpler accounting.

The consumer pulls from a bounded output queue; a full output queue
stalls the scheduling thread, so consumer speed backpressures the whole
pipeline transparently.
"""

from __future__ import annotations

import queue
import threading
from collections import deque
from typing import Any, Callable, Dict, Iterator, List, Optional

from .. import api
from ..utils import internal_metrics as imet

# Sentinel marking end-of-stream on the consumer queue.
_DONE = object()


class StreamOp:
    """One pipeline stage: wraps `submit(ref) -> ref` with queue state."""

    def __init__(
        self,
        name: str,
        submit: Callable[[Any], Any],
        cap: int = 4,
        on_start: Optional[Callable[[], None]] = None,
        on_end: Optional[Callable[[], None]] = None,
    ):
        self.name = name
        self.submit = submit
        self.cap = max(1, cap)
        self.on_start = on_start
        self.on_end = on_end
        self.inqueue: deque = deque()
        # In-flight bookkeeping is SEQ-ORDERED: blocks hand off downstream
        # in input order even when tasks complete out of order — the
        # pipeline preserves block order end to end (sort -> map -> take
        # stays sorted; limit takes the FIRST n rows).
        self.pending: Dict[int, Any] = {}  # seq -> out ref, not yet done
        self.done: Dict[int, Any] = {}  # seq -> out ref, completed
        self.next_seq = 0  # next submit's seq
        self.next_out = 0  # next seq to hand downstream
        self.outqueue: deque = deque()
        self.started = False
        self.tasks_started = 0
        self.tasks_finished = 0

    @property
    def inflight(self) -> List[Any]:
        return list(self.pending.values())


def store_sizer() -> Optional[Callable[[Any], Optional[int]]]:
    """The live runtime's bound `raw_size` lookup, or None when the
    runtime cannot size blocks at all (local mode, whose `_store` is a
    method rather than a store object; or no runtime). Executor v2 probes
    this ONCE per pipeline to skip byte accounting entirely on runtimes
    where no ref can ever resolve a size — the probe chain below is too
    expensive to repeat per queued ref per scheduler tick."""
    from ..core import runtime_base

    rt = runtime_base.maybe_runtime()
    return getattr(getattr(rt, "_store", None), "raw_size", None)


def block_nbytes(ref) -> Optional[int]:
    """Size of a locally-present block's framed payload (None if remote or
    still in flight) — the cheap signal the byte budgets adapt on. The ONE
    nbytes helper for the whole data plane (dataset._windowed, this
    executor, and executor-v2 all account through it)."""
    raw_size = store_sizer()
    ref_id = getattr(ref, "id", None)
    if raw_size is None or ref_id is None:
        return None
    try:
        return raw_size(ref_id())
    except Exception:
        return None


# Identity marker for the stock helper: executor v2 compares against this
# to tell a monkeypatched block_nbytes (tests injecting synthetic sizes)
# from the real one, which is provably useless without a sizable store.
_BLOCK_NBYTES_DEFAULT = block_nbytes


class BlockSizeEstimator:
    """Byte accounting that never counts an unknown-size block as free.

    The old `_ref_nbytes` returned 0 for any block whose payload is not
    locally sealed yet (in flight, or on another node) — under a memory
    budget the executor happily queued unbounded "0-byte" work. Unknown
    sizes now fall back to the OBSERVED MEAN block size of the stream
    (the `dataset._windowed` adaptation, kept as a running mean rather
    than last-seen so one outlier block doesn't swing the budget)."""

    def __init__(self):
        self._total = 0
        self._count = 0

    def observe(self, nbytes: int) -> None:
        self._total += int(nbytes)
        self._count += 1

    @property
    def mean(self) -> int:
        return self._total // self._count if self._count else 0

    def estimate(self, ref) -> int:
        size = block_nbytes(ref)
        if size:
            self.observe(size)
            return size
        return self.mean


class StreamingExecutor:
    """Runs a chain of StreamOps over a lazy source of block refs."""

    def __init__(
        self,
        source: Iterator[Any],
        ops: List[StreamOp],
        prefetch: int = 8,
        memory_budget: Optional[int] = None,
    ):
        self._source = source
        self._source_done = False
        self._ops = ops
        self._prefetch = max(1, prefetch)
        self._budget = memory_budget
        self._sizer = BlockSizeEstimator()
        self._out: "queue.Queue" = queue.Queue(maxsize=self._prefetch)
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="data-streaming-exec"
        )

    # ---------------------------------------------------------------- public
    def run_iter(self) -> Iterator[Any]:
        """Starts the scheduling thread; yields output block refs. Closing
        the generator (consumer stops early) stops the executor and tears
        down stage resources (actor pools)."""
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
            # Unblock a scheduler stuck on a full output queue.
            try:
                while True:
                    self._out.get_nowait()
            except queue.Empty:
                pass

    # ------------------------------------------------------------- the loop
    def _pull_source(self, want: int) -> None:
        """Feeds up to `want` source refs into stage 0 (submitting read
        tasks lazily — the source iterator is the read-task submitter)."""
        first = self._ops[0]
        while not self._source_done and want > 0:
            try:
                first.inqueue.append(next(self._source))
                want -= 1
            except StopIteration:
                self._source_done = True

    def _queued_bytes(self) -> int:
        total = 0
        for op in self._ops:
            for q in (op.inqueue, op.outqueue):
                for r in q:
                    total += self._sizer.estimate(r)
        return total

    def _drain_only(self) -> bool:
        return bool(self._budget) and self._queued_bytes() > self._budget

    def _run(self) -> None:
        ops = self._ops
        try:
            for op in ops:
                if op.on_start:
                    op.on_start()
                op.started = True
            while not self._stop.is_set():
                progressed = self._poll_completions()
                self._transfer()
                progressed |= self._emit_outputs()
                progressed |= self._schedule()
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
                if op.started and op.on_end:
                    try:
                        op.on_end()
                    except Exception:
                        # A failing user end-hook must not mask the
                        # pipeline result, but silence hides leaks (the
                        # hook usually releases actors/files).
                        from ..observability.logs import get_logger

                        get_logger("data").warning(
                            "stream operator on_end hook failed", exc_info=True
                        )

    def _poll_completions(self) -> bool:
        moved = False
        for op in self._ops:
            if not op.pending:
                continue
            refs = list(op.pending.values())
            done, _ = api.wait(refs, num_returns=len(refs), timeout=0)
            if done:
                done_ids = {id(r) for r in done}
                for seq in [s for s, r in op.pending.items() if id(r) in done_ids]:
                    op.done[seq] = op.pending.pop(seq)
                op.tasks_finished += len(done)
            # Release strictly in input order.
            released = 0
            while op.next_out in op.done:
                op.outqueue.append(op.done.pop(op.next_out))
                op.next_out += 1
                released += 1
                moved = True
            if released:
                imet.DATA_OP_BLOCKS.inc(released, operator=op.name)
        return moved

    def _transfer(self) -> None:
        """Hands completed blocks to the next stage's input queue."""
        for i, op in enumerate(self._ops[:-1]):
            nxt = self._ops[i + 1]
            while op.outqueue:
                nxt.inqueue.append(op.outqueue.popleft())

    def _put_out(self, item) -> bool:
        """Bounded put that aborts on stop — a consumer that walked away
        must not wedge the scheduler on a full queue forever."""
        while not self._stop.is_set():
            try:
                self._out.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _emit_outputs(self) -> bool:
        emitted = False
        last = self._ops[-1]
        while last.outqueue:
            # Blocks when the consumer lags `prefetch` behind — consumer
            # speed IS the final backpressure (output throttling).
            if not self._put_out(last.outqueue.popleft()):
                return emitted
            emitted = True
        return emitted

    def _schedule(self) -> bool:
        """select_operator_to_run: furthest-downstream runnable op first
        (reference: streaming_executor_state.py:527 — preferring ops with
        more downstream capacity starves nothing and drains memory). Over
        budget, only the furthest-downstream op that actually HAS input
        work may submit — and only one task — a progress guarantee (the
        reference reserves a minimum per op for the same reason), since
        blocking every op would livelock when all queued bytes sit
        upstream."""
        drain_only = self._drain_only()
        submitted = False
        for idx in range(len(self._ops) - 1, -1, -1):
            op = self._ops[idx]
            if idx == 0 and not drain_only:
                self._pull_source(op.cap - len(op.inqueue) - len(op.pending))
            while op.inqueue and len(op.pending) < op.cap:
                self._submit_one(op)
                submitted = True
                if drain_only:
                    return True
            if drain_only and submitted:
                return True
        if drain_only and not submitted and not any(
            op.pending or op.inqueue for op in self._ops
        ):
            # Everything queued is outqueue bytes waiting on the consumer;
            # admit fresh source work only if stage 0 can hold it.
            first = self._ops[0]
            self._pull_source(1 if not first.inqueue else 0)
            if first.inqueue and len(first.pending) < first.cap:
                self._submit_one(first)
                submitted = True
        return submitted

    @staticmethod
    def _submit_one(op: StreamOp) -> None:
        ref = op.inqueue.popleft()
        op.pending[op.next_seq] = op.submit(ref)
        op.next_seq += 1
        op.tasks_started += 1
        imet.DATA_OP_TASKS.inc(operator=op.name)

    def _all_done(self) -> bool:
        if not self._source_done:
            return False
        return all(
            not op.inqueue and not op.pending and not op.done and not op.outqueue
            for op in self._ops
        )

    def _wait_any(self) -> None:
        """Nothing runnable: block until some in-flight task completes."""
        all_inflight = [r for op in self._ops for r in op.pending.values()]
        if not all_inflight:
            return
        try:
            api.wait(all_inflight, num_returns=1, timeout=0.2)
        except Exception:  # lint: swallow-ok(bounded idle wait; completion poll follows)
            pass
