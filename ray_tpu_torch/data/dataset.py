"""Dataset: lazy logical plan + streaming distributed execution (the port
of ray_tpu/data/dataset.py).

Re-design of the reference's Ray Data core (reference:
python/ray/data/dataset.py Dataset:141, map_batches:391,
iter_batches:3844, streaming_split:1387; logical plan
_internal/logical/*, streaming executor _internal/execution/
streaming_executor.py:48). Key simplification: the unit of
streaming is the block task — adjacent row/batch transforms FUSE into one
task per block (the reference's zero-copy map fusion rule,
_internal/logical/rules/operator_fusion.py), so a block is read,
transformed and returned in a single remote call with no intermediate
materialization. Barrier ops (repartition, shuffle, sort) materialize.

Execution is pull-based and windowed: `iter_batches` keeps at most
`prefetch` block-tasks in flight — backpressure falls out of the pull loop
(the reference needs a dedicated resource-budget state machine,
streaming_executor_state.py:527; here the window IS the budget).

Functions given to map, filter, map_batches and groupby travel to worker
processes through core/serialization.py, which pickles lambdas, closures and
the functions of a module registered by value by value (the JAX package uses
cloudpickle).
"""

from __future__ import annotations

import itertools
import random
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional, Tuple, Union

import numpy as np

from .. import api
from ..core import serialization
from ..utils import config
from .block import Block, BlockAccessor, block_from_batch, block_from_rows, concat_blocks
from .datasource import (
    CSVDatasource,
    Datasource,
    ItemsDatasource,
    JSONDatasource,
    NumpyDatasource,
    ParquetDatasource,
    RangeDatasource,
    ReadTask,
    write_parquet_block,
)

# One nbytes helper for the whole data plane (satellite fix: this used to
# be duplicated here and in streaming.py with DIFFERENT unknown-size
# semantics — None here, 0 there; the 0 variant made the executor's byte
# budget silently undercount in-flight blocks).
from .streaming import block_nbytes as _block_nbytes

DEFAULT_PARALLELISM = 16

# This module exports a `range(n)` dataset constructor (reference:
# read_api.py); keep the builtin reachable for internal index loops.
_range = range


def _ensure_initialized():
    if not api.is_initialized():
        api.init(local_mode=True)


# ------------------------------------------------------------- logical plan


@dataclass
class _Op:
    kind: str  # read | input | map_rows | filter | flat_map | map_batches | repartition | shuffle | sort | limit
    fn: Optional[Callable] = None
    datasource: Optional[Datasource] = None
    parallelism: int = DEFAULT_PARALLELISM
    blocks: Optional[List[Any]] = None  # materialized input refs
    batch_size: Optional[int] = None
    batch_format: str = "numpy"
    n: int = 0
    key: Optional[Any] = None
    descending: bool = False
    seed: Optional[int] = None
    # Actor-pool sizing for map_batches: int = fixed pool, (min, max)
    # tuple = autoscaling pool (executor v2), None = fuse into tasks.
    concurrency: Union[int, Tuple[int, int], None] = None
    aggs: Optional[Dict[str, Tuple[str, Optional[str]]]] = None  # groupby
    group_fn: Optional[Callable] = None  # groupby map_groups
    datasets: Optional[List["Dataset"]] = None  # union members

    def fusable(self) -> bool:
        return self.kind in ("map_rows", "filter", "flat_map", "map_batches") and (
            self.concurrency is None
        )


def _apply_fused(block: Block, ops: List[_Op]) -> Block:
    """Runs a fused chain of transforms on one block inside a task."""
    from ..utils import internal_metrics as imet

    for op in ops:
        acc = BlockAccessor(block)
        # Worker-side per-operator rows/s (rate over the flushed counter);
        # counts INPUT rows — the work the operator actually performed.
        try:
            imet.DATA_ROWS.inc(acc.num_rows(), operator=op.kind)
        except Exception:  # lint: swallow-ok(metrics must not break the data plane)
            pass
        if op.kind == "map_rows":
            block = block_from_rows([op.fn(r) for r in acc.iter_rows()])
        elif op.kind == "filter":
            block = block_from_rows([r for r in acc.iter_rows() if op.fn(r)])
        elif op.kind == "flat_map":
            out: List[Any] = []
            for r in acc.iter_rows():
                out.extend(op.fn(r))
            block = block_from_rows(out)
        elif op.kind == "map_batches":
            n = acc.num_rows()
            bs = op.batch_size or n or 1
            outs = []
            for start in _range(0, n, bs):
                sub = BlockAccessor(acc.slice(start, min(start + bs, n)))
                batch = sub.to_batch(op.batch_format)
                res = op.fn(batch)
                outs.append(block_from_batch(res))
            block = concat_blocks(outs) if outs else block_from_rows([])
        else:  # pragma: no cover
            raise ValueError(f"not fusable: {op.kind}")
    return block


class _BatchMapActor:
    """Actor-pool worker for map_batches(concurrency=N) — the analogue of
    ActorPoolMapOperator (reference: _internal/execution/operators/
    actor_pool_map_operator.py:34); holds expensive per-process state (e.g.
    a model on the card) across blocks."""

    def __init__(self, fn_blob: bytes):
        fn_or_cls = serialization.loads(fn_blob)
        self._fn = fn_or_cls() if isinstance(fn_or_cls, type) else fn_or_cls

    def apply(self, block: Block, batch_size: Optional[int], batch_format: str) -> Block:
        op = _Op(kind="map_batches", fn=self._fn, batch_size=batch_size, batch_format=batch_format)
        return _apply_fused(block, [op])


@dataclass
class ExecStats:
    num_blocks: int = 0
    wall_s: float = 0.0




def _windowed(
    refs: Iterator[Any], window: int, memory_budget: Optional[int] = None
) -> Iterator[Any]:
    """Lookahead buffer: pulls (and thereby submits) up to `window` refs
    ahead of the consumer — bounded in-flight work with read/compute
    overlap. With a `memory_budget` (bytes), the effective window shrinks
    to budget/observed-block-size (reference: streaming executor resource
    budgets, streaming_executor_state.py — the memory half)."""
    from collections import deque

    buf: "deque" = deque()
    est_size: Optional[int] = None
    for r in refs:
        buf.append(r)
        eff = window
        if memory_budget:
            size = _block_nbytes(buf[0])
            if size:
                est_size = size
            if est_size:
                eff = max(1, min(window, memory_budget // max(1, est_size)))
        if len(buf) > eff:
            yield buf.popleft()
    while buf:
        yield buf.popleft()


class OptimizerRule:
    """One logical-plan rewrite (reference: _internal/logical/interfaces/
    optimizer.py Rule). apply() returns (ops, changed); the optimizer
    iterates all registered rules to a fixpoint."""

    def apply(self, ops: List[_Op]):
        raise NotImplementedError


class LimitPushdownRule(OptimizerRule):
    """`map(f).limit(n)` -> `limit(n).map(f)`: row-count-preserving
    transforms run on only the limited rows (reference:
    rules/limit_pushdown.py)."""

    def apply(self, ops: List[_Op]):
        changed = False
        ops = list(ops)
        for i in _range(2, len(ops)):  # ops[0] is the source
            if ops[i].kind == "limit" and ops[i - 1].kind == "map_rows":
                ops[i - 1], ops[i] = ops[i], ops[i - 1]
                changed = True
        return ops, changed


class LimitFusionRule(OptimizerRule):
    """Adjacent limits collapse to the smaller one."""

    def apply(self, ops: List[_Op]):
        out: List[_Op] = []
        changed = False
        for op in ops:
            if op.kind == "limit" and out and out[-1].kind == "limit":
                out[-1] = _Op(kind="limit", n=min(out[-1].n, op.n))
                changed = True
            else:
                out.append(op)
        return out, changed


_OPTIMIZER_RULES: List[OptimizerRule] = [LimitPushdownRule(), LimitFusionRule()]


def register_rule(rule: OptimizerRule) -> None:
    """Adds a custom logical-plan rule (applied on every plan build)."""
    _OPTIMIZER_RULES.append(rule)


class Dataset:
    """Lazy, immutable distributed dataset (reference: dataset.py:141)."""

    def __init__(self, ops: List[_Op]):
        self._ops = ops
        self.stats = ExecStats()

    def __getstate__(self):
        # The last run's executors (introspection) hold threads and queues:
        # a dataset iterated here still ships to a trainer or a feeder.
        state = dict(self.__dict__)
        state.pop("_last_executors", None)
        return state

    # ------------------------------------------------------- constructors
    @staticmethod
    def from_ops(ops: List[_Op]) -> "Dataset":
        return Dataset(ops)

    def _extended(self, op: _Op) -> "Dataset":
        return Dataset(self._ops + [op])

    # --------------------------------------------------------- transforms
    def map(self, fn: Callable[[Any], Any]) -> "Dataset":
        return self._extended(_Op(kind="map_rows", fn=fn))

    def filter(self, fn: Callable[[Any], bool]) -> "Dataset":
        return self._extended(_Op(kind="filter", fn=fn))

    def flat_map(self, fn: Callable[[Any], Iterable[Any]]) -> "Dataset":
        return self._extended(_Op(kind="flat_map", fn=fn))

    def map_batches(
        self,
        fn: Union[Callable, type],
        *,
        batch_size: Optional[int] = None,
        batch_format: str = "numpy",
        concurrency: Union[int, Tuple[int, int], None] = None,
        **_ignored,
    ) -> "Dataset":
        """(reference: dataset.py:391)

        `concurrency` selects the actor-pool execution path: an int pins
        the pool size; a `(min, max)` tuple enables pressure-driven
        autoscaling between the bounds (executor v2 — the reference's
        autoscaling actor pool; the v1 executor runs `min` actors)."""
        return self._extended(
            _Op(
                kind="map_batches",
                fn=fn,
                batch_size=batch_size,
                batch_format=batch_format,
                concurrency=concurrency,
            )
        )

    def repartition(self, num_blocks: int) -> "Dataset":
        return self._extended(_Op(kind="repartition", n=num_blocks))

    def random_shuffle(self, *, seed: Optional[int] = None) -> "Dataset":
        return self._extended(_Op(kind="shuffle", seed=seed))

    def sort(self, key: str, descending: bool = False) -> "Dataset":
        return self._extended(_Op(kind="sort", key=key, descending=descending))

    def groupby(self, key: str) -> "GroupedData":
        """Groups rows by a column (reference: Dataset.groupby ->
        GroupedData, python/ray/data/grouped_data.py). Aggregations run as
        a distributed hash shuffle: each block splits into hash partitions,
        each partition reduces independently."""
        return GroupedData(self, key)

    def union(self, *others: "Dataset") -> "Dataset":
        """Concatenates datasets block-wise, lazily: members execute only
        when the union is iterated (reference: Dataset.union)."""
        return Dataset.from_ops([_Op(kind="union", datasets=[self, *others])])

    def limit(self, n: int) -> "Dataset":
        return self._extended(_Op(kind="limit", n=n))

    # ---------------------------------------------------------- execution
    @staticmethod
    def _optimize(ops: List[_Op]) -> List[_Op]:
        """Runs the registered logical-plan rules to a fixpoint
        (reference: the rule-based optimizer, data/_internal/logical/
        rules/ + interfaces/optimizer.py; operator FUSION lives in
        _plan_stages). Rules are pluggable via register_rule()."""
        ops = list(ops)
        changed = True
        while changed:
            changed = False
            for rule in _OPTIMIZER_RULES:
                ops, rule_changed = rule.apply(ops)
                changed = changed or rule_changed
        return ops

    def _plan_stages(self):
        """Splits ops into (source, [stage...]) where each stage is either
        a fused chain, an actor-pool map, or a barrier op."""
        ops = self._optimize(self._ops)
        source = ops[0]
        assert source.kind in ("read", "input", "union")
        stages: List[Any] = []
        fused: List[_Op] = []
        for op in ops[1:]:
            if op.fusable():
                fused.append(op)
            else:
                if fused:
                    stages.append(("fused", fused))
                    fused = []
                stages.append((op.kind, op))
        if fused:
            stages.append(("fused", fused))
        return source, stages

    def _source_iter(self, source: _Op) -> Iterator[Any]:
        """Lazily submits read tasks — pulled through the prefetch window, so
        a huge directory is not all read up front."""
        _ensure_initialized()
        if source.kind == "input":
            yield from list(source.blocks or [])
            return
        if source.kind == "union":
            for member in source.datasets or []:
                yield from member.iter_block_refs()
            return
        tasks = source.datasource.get_read_tasks(source.parallelism)

        @api.remote
        def do_read(task: ReadTask) -> Block:
            return task()

        for t in tasks:
            yield do_read.remote(t)

    def iter_block_refs(
        self, prefetch: int = 8, memory_budget: Optional[int] = None
    ) -> Iterator[Any]:
        """The streaming executor: yields refs to output blocks. Chains of
        streamable stages run under a pull-based per-operator state machine
        so every stage processes different blocks concurrently. Two
        generations, selected by RAY_TPU_DATA_EXECUTOR (read per call so
        benches can A/B in one process):

        - "v2" (default, data/executor.py): autoscaling operator actor
          pools + per-operator byte budgets with drain-first scheduling;
        - "v1" (data/streaming.py): fixed pools, single global budget.

        Barrier stages (repartition/shuffle/sort/groupby) materialize
        their input before streaming resumes."""
        import os as _os
        import time as _time

        _ensure_initialized()
        t0 = _time.perf_counter()
        use_v2 = (_os.environ.get("RAY_TPU_DATA_EXECUTOR") or config.DATA_EXECUTOR) != "v1"
        source, stages = self._plan_stages()
        refs: Iterator[Any] = self._source_iter(source)

        pending_stages: List[Tuple[str, Any]] = []
        self._last_executors: List[Any] = []  # introspection (tests/bench)

        def flush(refs_in: Iterator[Any]) -> Iterator[Any]:
            nonlocal pending_stages
            if not pending_stages:
                return refs_in
            batch, pending_stages = pending_stages, []
            if use_v2:
                from .executor import PipelineExecutor

                ops = [
                    self._fused_pipeline_op(payload, prefetch)
                    if kind == "fused"
                    else self._actor_pool_pipeline_op(payload)
                    for kind, payload in batch
                ]
                ex: Any = PipelineExecutor(
                    refs_in, ops, prefetch=max(1, prefetch), memory_budget=memory_budget
                )
            else:
                from .streaming import StreamingExecutor

                ops = [
                    self._fused_stream_op(payload, prefetch)
                    if kind == "fused"
                    else self._actor_pool_stream_op(payload)
                    for kind, payload in batch
                ]
                ex = StreamingExecutor(
                    refs_in, ops, prefetch=max(1, prefetch), memory_budget=memory_budget
                )
            self._last_executors.append(ex)
            return ex.run_iter()

        for kind, payload in stages:
            if kind in ("fused", "map_batches"):
                pending_stages.append((kind, payload))
            elif kind == "repartition":
                refs = iter(self._repartition(list(flush(refs)), payload.n))
            elif kind == "shuffle":
                refs = iter(self._shuffle(list(flush(refs)), payload.seed))
            elif kind == "sort":
                refs = iter(self._sort(list(flush(refs)), payload))
            elif kind == "groupby":
                refs = iter(self._groupby(list(flush(refs)), payload))
            elif kind == "limit":
                refs = self._limit_iter(flush(refs), payload.n)
            else:  # pragma: no cover
                raise ValueError(f"unknown stage {kind}")
        refs = flush(refs)

        n = 0
        try:
            for ref in _windowed(refs, max(1, prefetch), memory_budget):
                n += 1
                yield ref
        finally:
            # Early consumer exit: stop a live executor (kills actor pools).
            close = getattr(refs, "close", None)
            if close is not None:
                close()
            self.stats.num_blocks = n
            self.stats.wall_s = _time.perf_counter() - t0

    def _fused_stream_op(self, ops: List[_Op], prefetch: int):
        from .streaming import StreamOp

        @api.remote
        def do_transform(block: Block, ops=ops) -> Block:
            return _apply_fused(block, ops)

        names = "+".join(o.kind for o in ops)
        return StreamOp(
            f"fused[{names}]",
            lambda r: do_transform.remote(r),
            cap=max(2, prefetch),
        )

    @staticmethod
    def _pool_bounds(concurrency) -> Tuple[int, int]:
        """(min, max) pool size from a map_batches concurrency spec."""
        if isinstance(concurrency, tuple):
            lo, hi = concurrency
            lo = max(1, int(lo))
            return lo, max(lo, int(hi))
        n = max(1, int(concurrency or 1))
        return n, n

    def _fused_pipeline_op(self, ops: List[_Op], prefetch: int):
        """Executor-v2 fused task stage (stateless submission, same task
        body as the v1 builder)."""
        from .executor import PipelineOp

        @api.remote
        def do_transform(block: Block, ops=ops) -> Block:
            return _apply_fused(block, ops)

        names = "+".join(o.kind for o in ops)
        return PipelineOp(
            f"fused[{names}]",
            submit=lambda r: do_transform.remote(r),
            cap=max(2, prefetch),
        )

    def _actor_pool_pipeline_op(self, op: _Op):
        """Executor-v2 actor-pool stage: an op_pool.OperatorPool scaling
        between the declared (min, max) on pressure signals."""
        from .executor import PipelineOp
        from .op_pool import OperatorPool

        lo, hi = self._pool_bounds(op.concurrency)
        actor_cls = api.remote(max_concurrency=2)(_BatchMapActor)
        blob = serialization.dumps(op.fn)
        pool = OperatorPool(
            f"map_batches[pool={lo}..{hi}]",
            spawn=lambda: actor_cls.remote(blob),
            min_size=lo,
            max_size=hi,
        )
        return PipelineOp(
            pool.name,
            pool=pool,
            make_call=lambda a, r: a.apply.remote(r, op.batch_size, op.batch_format),
        )

    def _actor_pool_stream_op(self, op: _Op):
        """Actor-pool stage (reference: actor_pool_map_operator.py:34):
        the pool is created when the executor starts the stage and torn
        down when the stage ends — including early consumer exit."""
        from .streaming import StreamOp

        n_actors, _ = self._pool_bounds(op.concurrency)
        actor_cls = api.remote(max_concurrency=2)(_BatchMapActor)
        blob = serialization.dumps(op.fn)
        state: Dict[str, Any] = {"actors": [], "rr": 0}

        def on_start():
            state["actors"] = [actor_cls.remote(blob) for _ in _range(n_actors)]

        def submit(r):
            a = state["actors"][state["rr"] % n_actors]
            state["rr"] += 1
            return a.apply.remote(r, op.batch_size, op.batch_format)

        def on_end():
            # In-flight applies (early exit) get a short grace before the
            # kill so refs already handed downstream still resolve.
            stream_op = state.get("op")
            pending = list(stream_op.inflight) if stream_op is not None else []
            stalled = 0.0
            while pending and stalled < 60.0:
                try:
                    before = len(pending)
                    _, pending = api.wait(pending, num_returns=len(pending), timeout=5)
                    stalled = 0.0 if len(pending) < before else stalled + 5.0
                except Exception:
                    break
            for a in state["actors"]:
                try:
                    api.kill(a)
                except Exception:  # lint: swallow-ok(pool actor may already be dead)
                    pass

        sop = StreamOp(
            f"map_batches[pool={n_actors}]",
            submit,
            cap=max(2, 2 * n_actors),
            on_start=on_start,
            on_end=on_end,
        )
        state["op"] = sop
        return sop

    def _repartition(self, refs: List[Any], n: int) -> List[Any]:
        blocks = api.get(refs)
        whole = concat_blocks(blocks)
        acc = BlockAccessor(whole)
        total = acc.num_rows()
        n = max(1, n)
        per = (total + n - 1) // n if total else 0
        out = []
        for start in _range(0, total, per or 1):
            out.append(api.put(acc.slice(start, min(start + per, total))))
            if len(out) == n:
                break
        return out or [api.put(whole)]

    def _shuffle(self, refs: List[Any], seed: Optional[int]) -> List[Any]:
        """Distributed random shuffle: map tasks scatter each block's rows
        into P random partitions, reduce tasks concatenate + locally
        permute partition j — all data moves block-ref to block-ref over
        the object plane, never through the driver (reference: the
        push-based shuffle exchange, _internal/planner/exchange/
        shuffle_task_scheduler)."""
        if not refs:
            return []
        # Output block count follows the input (downstream parallelism is
        # preserved) up to a cap that bounds the P x blocks intermediate
        # object count on small test clusters.
        P = max(1, min(len(refs), 32))

        @api.remote
        def scatter(block: Block, salt: int, P=P):
            rng = random.Random(salt)
            parts: List[List[Any]] = [[] for _ in _range(P)]
            for row in BlockAccessor(block).iter_rows():
                parts[rng.randrange(P)].append(row)
            out = tuple(block_from_rows(p) for p in parts)
            return out if P > 1 else out[0]

        base = seed if seed is not None else random.randrange(1 << 30)
        part_refs = [
            scatter.options(num_returns=P).remote(r, base + i)
            for i, r in enumerate(refs)
        ]
        if P == 1:
            part_refs = [[r] for r in part_refs]

        @api.remote
        def merge(salt: int, *parts):
            rows: List[Any] = []
            for b in parts:
                rows.extend(BlockAccessor(b).iter_rows())
            random.Random(salt).shuffle(rows)
            return block_from_rows(rows)

        return [
            merge.remote(base ^ (j + 1), *[part_refs[i][j] for i in _range(len(part_refs))])
            for j in _range(P)
        ]

    def _sort(self, refs: List[Any], op: _Op) -> List[Any]:
        """Distributed sample-based range-partition sort (reference: the
        sort exchange, _internal/planner/exchange/sort_task_spec.py
        SortTaskSpec.sample_boundaries): only a small KEY SAMPLE crosses
        the driver; rows move map-task -> reduce-task over the object
        plane. Output blocks are globally ordered partition by partition."""
        if not refs:
            return []
        key, desc = op.key, op.descending
        P = max(1, min(len(refs), 32))  # see _shuffle on the cap
        if P == 1:
            blocks = api.get(refs)
            rows = []
            for b in blocks:
                rows.extend(BlockAccessor(b).iter_rows())
            rows.sort(key=lambda r: r[key], reverse=desc)
            return [api.put(block_from_rows(rows))]

        @api.remote
        def sample_keys(block: Block, key=key):
            acc = BlockAccessor(block)
            n = acc.num_rows()
            step = max(1, n // 16)
            return [row[key] for i, row in enumerate(acc.iter_rows()) if i % step == 0]

        samples = sorted(
            k for ks in api.get([sample_keys.remote(r) for r in refs]) for k in ks
        )
        boundaries = [
            samples[(i + 1) * len(samples) // P] for i in _range(P - 1)
        ] if samples else []

        @api.remote
        def partition(block: Block, boundaries=tuple(boundaries), key=key, desc=desc, P=P):
            import bisect

            parts: List[List[Any]] = [[] for _ in _range(P)]
            bounds = list(boundaries)
            for row in BlockAccessor(block).iter_rows():
                # Ascending range index; descending output just reverses
                # the partition order.
                idx = bisect.bisect_right(bounds, row[key]) if bounds else 0
                if desc:
                    idx = P - 1 - idx
                parts[idx].append(row)
            out = tuple(block_from_rows(p) for p in parts)
            return out if P > 1 else out[0]

        part_refs = [partition.options(num_returns=P).remote(r) for r in refs]

        @api.remote
        def sort_partition(key, desc, *parts):
            rows: List[Any] = []
            for b in parts:
                rows.extend(BlockAccessor(b).iter_rows())
            rows.sort(key=lambda r: r[key], reverse=desc)
            return block_from_rows(rows)

        return [
            sort_partition.remote(key, desc, *[part_refs[i][j] for i in _range(len(part_refs))])
            for j in _range(P)
        ]

    def _groupby(self, refs: List[Any], op: _Op) -> List[Any]:
        """Distributed hash-shuffle groupby (reference: the shuffle-based
        groupby planner, _internal/planner/exchange/). Map side: every
        block splits into P hash partitions (multi-return task). Reduce
        side: partition j gathers the j-th split of every block and
        groups/aggregates locally."""
        if not refs:
            return []
        P = max(1, min(len(refs), 32))
        key, aggs, group_fn = op.key, op.aggs, op.group_fn

        @api.remote
        def split(block: Block, P=P, key=key):
            parts: List[List[Any]] = [[] for _ in _range(P)]
            for row in BlockAccessor(block).iter_rows():
                parts[_stable_hash(row[key]) % P].append(row)
            out = tuple(block_from_rows(p) for p in parts)
            return out if P > 1 else out[0]

        part_refs = [split.options(num_returns=P).remote(r) for r in refs]
        if P == 1:
            part_refs = [[r] for r in part_refs]

        @api.remote
        def reduce(key, aggs, group_fn, *parts):
            groups: Dict[Any, List[Any]] = {}
            for b in parts:
                for row in BlockAccessor(b).iter_rows():
                    groups.setdefault(row[key], []).append(row)
            out_rows: List[Any] = []
            for k in sorted(groups, key=repr):
                rows = groups[k]
                if group_fn is not None:
                    res = group_fn(rows)
                    out_rows.extend(res if isinstance(res, list) else [res])
                    continue
                o: Dict[str, Any] = {key: k}
                for name, (akind, col) in aggs.items():
                    vals = [r[col] for r in rows] if col else rows
                    if akind == "count":
                        o[name] = len(rows)
                    elif akind == "sum":
                        o[name] = sum(vals)
                    elif akind == "mean":
                        o[name] = sum(vals) / len(vals)
                    elif akind == "min":
                        o[name] = min(vals)
                    elif akind == "max":
                        o[name] = max(vals)
                    else:  # pragma: no cover
                        raise ValueError(f"unknown aggregation {akind!r}")
                out_rows.append(o)
            return block_from_rows(out_rows)

        return [
            reduce.remote(
                key, aggs, group_fn, *[part_refs[i][j] for i in _range(len(part_refs))]
            )
            for j in _range(P)
        ]

    def _limit_iter(self, refs: Iterator[Any], n: int) -> Iterator[Any]:
        """Streaming limit: stops pulling upstream once n rows are covered,
        so the rest of the dataset is never read."""
        taken = 0
        for r in refs:
            if taken >= n:
                return
            block = api.get(r)
            acc = BlockAccessor(block)
            rows = acc.num_rows()
            if taken + rows <= n:
                taken += rows
                yield r
            else:
                yield api.put(acc.slice(0, n - taken))
                return

    # ---------------------------------------------------------- consumers
    def iter_batches(
        self,
        *,
        batch_size: Optional[int] = 256,
        batch_format: str = "numpy",
        prefetch_batches: int = 2,
        drop_last: bool = False,
        local_shuffle_buffer_size: Optional[int] = None,
        local_shuffle_seed: Optional[int] = None,
    ) -> Iterator[Any]:
        """(reference: dataset.py:3844 via iterator.py).

        `prefetch_batches` block fetches stay in flight ahead of the
        consumer (futures over the object plane), overlapping task
        execution/transfer with downstream consumption — the iterator
        analogue of the reference's prefetching block batching
        (_internal/block_batching)."""
        import collections

        from .iterator import rebatch_blocks

        def block_iter():
            ahead = max(0, int(prefetch_batches))
            window: "collections.deque" = collections.deque()
            for ref in self.iter_block_refs():
                # Keep the REF alive alongside its future: dropping it
                # would let owner refcounting free the block before the
                # prefetched fetch completes.
                window.append((ref, ref.future()))
                while len(window) > ahead:
                    _ref, fut = window.popleft()
                    yield fut.result()
            while window:
                _ref, fut = window.popleft()
                yield fut.result()

        yield from rebatch_blocks(
            block_iter(),
            batch_size=batch_size,
            batch_format=batch_format,
            drop_last=drop_last,
            shuffle_buffer_size=local_shuffle_buffer_size,
            shuffle_seed=local_shuffle_seed,
        )

    def iter_rows(self) -> Iterator[Any]:
        for ref in self.iter_block_refs():
            yield from BlockAccessor(api.get(ref)).iter_rows()

    def take(self, n: int = 20) -> List[Any]:
        return list(itertools.islice(self.iter_rows(), n))

    def take_all(self) -> List[Any]:
        return list(self.iter_rows())

    def count(self) -> int:
        return sum(BlockAccessor(api.get(r)).num_rows() for r in self.iter_block_refs())

    def schema(self):
        for ref in self.iter_block_refs():
            return BlockAccessor(api.get(ref)).schema()
        return None

    def materialize(self) -> "Dataset":
        refs = list(self.iter_block_refs())
        return Dataset([_Op(kind="input", blocks=refs)])

    def num_blocks(self) -> int:
        return len(list(self.iter_block_refs()))

    # ------------------------------------------------------------- splits
    def split(self, n: int) -> List["Dataset"]:
        """Materializing split into n datasets (reference: dataset.py split)."""
        refs = list(self.iter_block_refs())
        if len(refs) < n:
            refs = self._repartition(refs, n)
        shards: List[List[Any]] = [[] for _ in _range(n)]
        for i, r in enumerate(refs):
            shards[i % n].append(r)
        return [Dataset([_Op(kind="input", blocks=s)]) for s in shards]

    def streaming_split(self, n: int, *, equal: bool = True, locality_hints=None):
        """N coordinated iterators, one per training worker (reference:
        dataset.py:1387, SplitCoordinator actor stream_split_iterator.py:124).

        equal=True slices shards to identical row counts (dropping the
        remainder) — required for SPMD training where every worker must step
        the same number of batches or a collective hangs. locality_hints is
        accepted for API parity; the thread-based runtime has no locality.

        Returns a SplitStreams (a list of DataIterators) whose
        `.to_channel()` upgrades delivery to persistent cgraph channels:
        k ChannelFeed handles, shippable to trainer workers / serve
        replicas, each pumping its shard through a shared-memory ring
        (data/feed.py) instead of per-block object-store pulls."""
        from .iterator import make_streaming_split

        return make_streaming_split(self, n, equal=equal)

    # -------------------------------------------------------------- sinks
    def write_parquet(self, path: str) -> List[str]:
        @api.remote
        def do_write(block: Block, idx: int) -> str:
            return write_parquet_block(block, path, idx)

        return api.get(
            [do_write.remote(r, i) for i, r in enumerate(self.iter_block_refs())]
        )

    def __repr__(self):
        kinds = [op.kind for op in self._ops]
        return f"Dataset({' -> '.join(kinds)})"


# ----------------------------------------------------------- constructors
# (reference: python/ray/data/read_api.py)


def range(n: int, *, parallelism: int = DEFAULT_PARALLELISM) -> Dataset:  # noqa: A001
    return Dataset([_Op(kind="read", datasource=RangeDatasource(n), parallelism=parallelism)])


def from_items(items: List[Any], *, parallelism: int = DEFAULT_PARALLELISM) -> Dataset:
    return Dataset([_Op(kind="read", datasource=ItemsDatasource(items), parallelism=parallelism)])


def from_numpy(arrays: Dict[str, np.ndarray], *, parallelism: int = DEFAULT_PARALLELISM) -> Dataset:
    return Dataset([_Op(kind="read", datasource=NumpyDatasource(arrays), parallelism=parallelism)])


def from_pandas(df, *, parallelism: int = DEFAULT_PARALLELISM) -> Dataset:
    """A DataFrame's columns as numpy arrays (its index dropped)."""
    return from_numpy({name: df[name].to_numpy() for name in df.columns},
                      parallelism=parallelism)


def read_parquet(paths, *, columns=None, parallelism: int = DEFAULT_PARALLELISM) -> Dataset:
    return Dataset(
        [_Op(kind="read", datasource=ParquetDatasource(paths, columns), parallelism=parallelism)]
    )


def read_csv(paths, *, parallelism: int = DEFAULT_PARALLELISM) -> Dataset:
    return Dataset([_Op(kind="read", datasource=CSVDatasource(paths), parallelism=parallelism)])


def read_json(paths, *, parallelism: int = DEFAULT_PARALLELISM) -> Dataset:
    return Dataset([_Op(kind="read", datasource=JSONDatasource(paths), parallelism=parallelism)])


def _stable_hash(v: Any) -> int:
    """Deterministic cross-process hash: builtin hash() is salted per
    process, so map-side partitioning in different workers would scatter
    the same key across partitions. Numerics canonicalize to their float
    form when exactly representable (0 == 0.0 == False must land in ONE
    partition — the reduce side groups by Python equality)."""
    import hashlib

    if hasattr(v, "item") and not isinstance(v, (bytes, str)):
        # Numpy scalars repr differently from equal Python scalars
        # ('np.int64(3)' vs '3' under numpy>=2): canonicalize first or
        # map-side partitions disagree with reduce-side Python equality.
        try:
            v = v.item()
        except Exception:  # lint: swallow-ok(non-scalar .item(); value used as-is)
            pass
    if isinstance(v, (bool, int, float)) and not isinstance(v, float):
        try:
            if float(v) == v:
                v = float(v)
        except OverflowError:
            pass
    return int.from_bytes(
        hashlib.md5(repr(v).encode("utf-8", "backslashreplace")).digest()[:8], "little"
    )


class GroupedData:
    """Result of Dataset.groupby (reference: python/ray/data/grouped_data.py
    GroupedData.count/sum/mean/min/max/map_groups)."""

    def __init__(self, ds: Dataset, key: str):
        self._ds = ds
        self._key = key

    def _agg(self, aggs: Dict[str, Tuple[str, Optional[str]]]) -> Dataset:
        return self._ds._extended(_Op(kind="groupby", key=self._key, aggs=aggs))

    def count(self) -> Dataset:
        return self._agg({"count()": ("count", None)})

    def sum(self, col: str) -> Dataset:
        return self._agg({f"sum({col})": ("sum", col)})

    def mean(self, col: str) -> Dataset:
        return self._agg({f"mean({col})": ("mean", col)})

    def min(self, col: str) -> Dataset:
        return self._agg({f"min({col})": ("min", col)})

    def max(self, col: str) -> Dataset:
        return self._agg({f"max({col})": ("max", col)})

    def aggregate(self, **aggs: Tuple[str, Optional[str]]) -> Dataset:
        """aggregate(total=("sum", "v"), n=("count", None), ...)"""
        return self._agg(dict(aggs))

    def map_groups(self, fn: Callable[[List[Any]], Any]) -> Dataset:
        """Applies fn to each group's row list; fn returns a row or a list
        of rows (reference: GroupedData.map_groups)."""
        return self._ds._extended(_Op(kind="groupby", key=self._key, group_fn=fn))
