"""The port's Data (ray_tpu_torch.data) side by side with the JAX package's
ray_tpu.data, and TorchTrainer's `datasets=`.

Every dataset case runs the same pipeline on the same seeded numpy inputs in
both packages' `init(local_mode=True)` and asserts the same outcome, exactly:
the rows (Python values and their types, by `repr`), the "numpy" batches
(keys, dtypes, shapes, values) and the order wherever the JAX package fixes
one (the seeded shuffle, sort, groupby's partitions). The cases are those of
tests/test_data.py and tests/test_data_plane.py: map, filter, flat_map,
map_batches on tasks and on actor pools, repartition, random_shuffle(seed),
sort, groupby aggregates and map_groups, union, limit and its pushdown,
split, streaming_split(equal=True), count/schema, the parquet/CSV/JSON round
trips, both executor generations, the operator pool's scale ladder and blip
tolerance, bounded queued bytes under skew, consumer-stall backpressure, one
split coordinator shipped to every shard, and the channel feed.

The port's blocks are dicts of numpy columns where the JAX package's are
pyarrow Tables (ray_tpu_torch/data/block.py). Rows and batches agree, with
three differences by design, each held by its own case: a column holding
None stays a list of rows in the port (pyarrow makes a nullable column:
float64 with NaN for ints), rows whose keys differ stay a list (pyarrow fills
the first row's keys with None), and a ragged list column is an object array
(pyarrow's numpy view of it raises).

TorchTrainer(datasets=) runs both dataset_config values on the local runtime
and on a cluster of worker processes (use_gpu=False, 2 workers): 128 rows
per rank, data_wait > 0, and a 2-layer MLP trained from
`iter_device_batches(device="cpu")` whose losses are within 1e-5 of the
JaxTrainer's same loop on the same rows.
"""

import importlib
import os
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest

import ray_tpu
import ray_tpu_torch
import torch_modes
from ray_tpu_torch.core import serialization
from torch_waits import bounded

serialization.register_pickle_by_value(sys.modules[__name__])

PACKAGES = {"jax": ray_tpu, "torch": ray_tpu_torch}
LOSS_TOL = 1e-5
CASE_S = 120


def _ns(name):
    pkg = PACKAGES[name]
    return SimpleNamespace(
        name=name, rt=pkg, data=importlib.import_module(f"{pkg.__name__}.data"),
        block=importlib.import_module(f"{pkg.__name__}.data.block"))


def _both(case):
    """case(ns) on each package's local runtime: {"jax": ..., "torch": ...}."""
    out = {}
    for name in PACKAGES:
        ns = _ns(name)
        ns.rt.shutdown()
        ns.rt.init(local_mode=True, num_cpus=8)
        try:
            out[name] = bounded(lambda: case(ns), CASE_S)
        finally:
            ns.rt.shutdown()
    return out


def _rows(rows):
    """Rows compared with their Python types (1 and 1.0 differ)."""
    return [repr(r) for r in rows]


def _batches(batches):
    return [{k: (str(np.asarray(v).dtype), np.asarray(v).shape, np.asarray(v).tolist())
             for k, v in b.items()} for b in batches]


def _same(got):
    assert got["torch"] == got["jax"]
    return got["jax"]


# ------------------------------------------------------------------ blocks


_ROW_CASES = {
    "ints": [{"k": 1}, {"k": 2}],
    "int_float": [{"k": 0}, {"k": 0.0}],
    "bools": [{"k": True}, {"k": False}],
    "int_bool": [{"k": 0}, {"k": True}],
    "int_str": [{"k": 1}, {"k": "a"}],
    "strings": [{"k": "a"}, {"k": "bc"}],
    "str_none": [{"k": "a"}, {"k": None}],
    "bytes": [{"k": b"x"}, {"k": b"yz"}],
    "np_float32": [{"k": np.float32(1.5)}, {"k": np.float32(2)}],
    "np_int32": [{"k": np.int32(1)}, {"k": np.int32(2)}],
    "np_arrays": [{"k": np.ones(2, np.float32)}, {"k": np.zeros(2, np.float32)}],
    "lists": [{"k": [1, 2.5]}, {"k": [3, 4]}],
    "empty_lists": [{"k": []}, {"k": []}],
    "nested_lists": [{"k": [[1, 2], [3, 4]]}],
    "dicts": [{"k": {"x": 1}}, {"k": {"x": 2}}],
    "two_cols": [{"a": 1, "b": "x"}, {"a": 2, "b": "y"}],
    "items": [1, 2, 3],
}


@pytest.mark.parametrize("case", sorted(_ROW_CASES))
def test_block_from_rows_matches_jax(case):
    """Rows -> block -> rows and -> numpy batch, with no runtime."""
    got = {}
    for name in PACKAGES:
        b = _ns(name).block
        block = b.block_from_rows(list(_ROW_CASES[case]))
        acc = b.BlockAccessor(block)
        got[name] = (acc.num_rows(), _rows(acc.iter_rows()), _batches([acc.to_batch("numpy")]))
    _same(got)


def test_block_differences_by_design():
    """A None, keys that differ and a ragged list column: the port keeps the
    rows as given (module docstring)."""
    from ray_tpu_torch.data.block import BlockAccessor, block_from_rows

    for rows in ([{"k": None}, {"k": 1}], [{"a": 1}, {"b": 2}]):
        assert block_from_rows(rows) is rows
        assert list(BlockAccessor(rows).iter_rows()) == rows
    ragged = block_from_rows([{"k": [1]}, {"k": [3, 4]}])
    assert ragged["k"].dtype == object
    assert list(BlockAccessor(ragged).iter_rows()) == [{"k": [1]}, {"k": [3, 4]}]


def test_batch_columns_keep_dtypes_as_jax():
    """block_from_batch then to_batch: 1-D columns keep their dtype, strings
    become objects, tensor columns become int64/float64/bool as a list
    column round-trips, and the block's rows are Python scalars."""
    rng = np.random.default_rng(0)
    batch = {"i": rng.integers(0, 9, 5).astype(np.int32), "f": rng.random(5).astype(np.float32),
             "t": rng.integers(0, 9, (5, 3)).astype(np.int16), "m": rng.random((5, 2)),
             "s": np.array(list("abcde")), "b": rng.random(5) > 0.5,
             "bt": np.array([b"x", b"y", b"z", b"w", b"v"])}
    got = {}
    for name in PACKAGES:
        b = _ns(name).block
        acc = b.BlockAccessor(b.block_from_batch(dict(batch)))
        sl = b.BlockAccessor(acc.slice(1, 4))
        got[name] = (_batches([acc.to_batch("numpy")]), _rows(acc.iter_rows()),
                     _batches([sl.to_batch("numpy")]), acc.num_rows())
    _same(got)


def test_batch_formats_import_their_library_in_the_call():
    """pandas and pyarrow batches from a port block; without those libraries
    the call raises ImportError naming them (a subprocess that hides them)."""
    from ray_tpu_torch.data.block import BlockAccessor

    acc = BlockAccessor({"x": np.arange(3), "t": np.ones((3, 2))})
    assert acc.to_batch("pandas")["x"].tolist() == [0, 1, 2]
    assert acc.to_batch("pyarrow").column("t").to_pylist() == [[1.0, 1.0]] * 3
    code = (
        "import sys\n"
        "sys.modules['pandas'] = None; sys.modules['pyarrow'] = None\n"
        "import numpy as np\n"
        "from ray_tpu_torch.data.block import BlockAccessor\n"
        "acc = BlockAccessor({'x': np.arange(3)})\n"
        "for fmt in ('pandas', 'pyarrow'):\n"
        "    try:\n"
        "        acc.to_batch(fmt)\n"
        "    except ImportError as e:\n"
        "        assert fmt in str(e), e\n"
        "    else:\n"
        "        raise SystemExit(fmt + ' did not raise')\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=torch_modes.__file__.rsplit("/", 2)[0],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "ok" in out.stdout, out.stderr


def test_importing_data_loads_neither_pyarrow_nor_pandas():
    code = (
        "import sys\n"
        "import ray_tpu_torch.data, ray_tpu_torch.data.dataset, ray_tpu_torch.data.feed\n"
        "import ray_tpu_torch.serve, ray_tpu_torch.serve.handle, ray_tpu_torch.serve.ingest\n"
        "import ray_tpu_torch.serve.grpc_proxy\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('pyarrow', 'pandas', 'grpc')]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=torch_modes.__file__.rsplit("/", 2)[0],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "clean" in out.stdout, out.stderr


# -------------------------------------------------------- dataset operations


def _schema(s):
    """A pyarrow Schema (the JAX package's) or the port's {name: dtype} as
    [(name, type)]."""
    if hasattr(s, "names"):
        return [(f.name, str(f.type)) for f in s]
    return list(s.items()) if isinstance(s, dict) else s


def test_range_count_take_schema():
    def case(ns):
        ds = ns.data.range(100, parallelism=8)
        return (ds.count(), _rows(ds.take(5)), ds.num_blocks(), _schema(ds.schema()),
                _schema(ns.data.from_items([{"a": 1}]).schema()),
                _schema(ns.data.from_items([1.5]).schema()))

    got = _same(_both(case))
    assert got[:4] == (100, _rows([{"id": i} for i in range(5)]), 8, [("id", "int64")])


def test_map_filter_flat_map():
    def case(ns):
        a = (ns.data.range(50, parallelism=4).map(lambda r: {"id": r["id"] * 2, "h": r["id"] / 3})
             .filter(lambda r: r["id"] % 4 == 0).take_all())
        b = ns.data.from_items([1, 2, 3]).flat_map(lambda x: [x, x * 10]).take_all()
        c = ns.data.from_items([{"w": "ab"}, {"w": "cde"}]).flat_map(
            lambda r: [{"c": ch, "n": i} for i, ch in enumerate(r["w"])]).take_all()
        return _rows(a), _rows(b), _rows(c)

    _same(_both(case))


def _add_state():
    class AddState:
        def __init__(self):
            self.offset = 1000

        def __call__(self, batch):
            return {"id": batch["id"] + self.offset, "sq": batch["id"] ** 2}

    return AddState


@pytest.mark.parametrize("concurrency", [None, 2, (1, 3)], ids=["tasks", "pool", "autoscale"])
def test_map_batches(concurrency):
    def case(ns):
        fn = _add_state() if concurrency else (lambda b: {"id": b["id"], "sq": b["id"] ** 2})
        ds = ns.data.range(64, parallelism=4).map_batches(fn, batch_size=16,
                                                           concurrency=concurrency)
        return _rows(ds.take_all()), _batches(ds.iter_batches(batch_size=20))

    _same(_both(case))


def test_map_batches_sees_the_block_dtypes():
    """Inside a task the batch is the block's own columns (1-D int32 stays
    int32, a tensor column is float64, strings are objects)."""
    x = np.random.default_rng(1).random((12, 3)).astype(np.float32)

    def sig(b):
        s = repr({k: (str(v.dtype), v.shape[1:]) for k, v in b.items()})
        return {"i": b["i"], "sig": np.array([s] * len(b["i"]), dtype=object)}

    def case(ns):
        ds = ns.data.from_numpy({"i": np.arange(12, dtype=np.int32), "x": x,
                                 "s": np.array(list("abcdefghijkl"))}, parallelism=3)
        return _rows(ds.map_batches(sig).take_all()), _batches(ds.iter_batches(batch_size=5))

    _same(_both(case))


def test_repartition_split_and_num_blocks():
    def case(ns):
        ds = ns.data.range(10, parallelism=2).repartition(5)
        shards = ns.data.range(30, parallelism=3).split(4)
        return (ds.num_blocks(), _rows(ds.take_all()),
                [_rows(s.take_all()) for s in shards])

    _same(_both(case))


def test_seeded_shuffle_order_equals_jax():
    def case(ns):
        ds = ns.data.range(300, parallelism=6).random_shuffle(seed=7)
        items = ns.data.from_items([{"k": i % 5, "s": str(i)} for i in range(40)],
                                   parallelism=4).random_shuffle(seed=11)
        return _rows(ds.take_all()), _rows(items.take_all())

    rows, items = _same(_both(case))
    assert sorted(rows) != rows and len(rows) == 300 and len(items) == 40


def test_sort():
    def case(ns):
        asc = ns.data.from_items([{"v": x, "t": str(x)} for x in [3, 1, 2, 9, -4, 7]],
                                 parallelism=3).sort("v")
        desc = ns.data.range(40, parallelism=10).sort("id", descending=True)
        return _rows(asc.take_all()), _rows(desc.take_all())

    _same(_both(case))


def test_groupby_aggregates_and_partitions():
    rows = [{"k": i % 3, "v": float(i), "g": "ab"[i % 2]} for i in range(30)]

    def case(ns):
        ds = ns.data.from_items(rows, parallelism=6)
        return [_rows(d.take_all()) for d in (
            ds.groupby("k").count(), ds.groupby("k").sum("v"), ds.groupby("g").mean("v"),
            ds.groupby("k").aggregate(lo=("min", "v"), hi=("max", "v"), n=("count", None)))]

    _same(_both(case))


def test_groupby_map_groups_and_numeric_keys():
    def case(ns):
        ds = ns.data.from_items([{"k": "a" if i < 4 else "b", "v": i} for i in range(10)])
        mapped = (ds.groupby("k").map_groups(lambda rows: {"k": rows[0]["k"], "n": len(rows)})
                  .filter(lambda r: r["n"] > 4).take_all())
        mixed = ns.data.from_items(
            [{"k": 0, "v": 1.0}, {"k": 0.0, "v": 3.0}, {"k": 1, "v": 5.0}, {"k": True, "v": 7.0}],
            parallelism=4).groupby("k").sum("v").take_all()
        return _rows(mapped), _rows(mixed)

    mapped, mixed = _same(_both(case))
    assert mapped == _rows([{"k": "b", "n": 6}]) and len(mixed) == 2


def test_union_is_lazy_and_ordered(tmp_path):
    def case(ns):
        marks = tmp_path / ns.name
        marks.mkdir()

        def spy(x):
            (marks / f"{x}-{time.time_ns()}").touch()
            return x

        u = ns.data.from_items([1, 2]).map(spy).union(ns.data.from_items([3]).map(spy))
        before = len(os.listdir(marks))
        a = ns.data.from_items([0, 1, 2, 3, 4]).union(ns.data.from_items([0, 1, 2]).map(
            lambda x: x + 100))
        return before, _rows(u.take_all()), _rows(a.take_all())

    before, *_ = _same(_both(case))
    assert before == 0


def test_limit_and_its_pushdown(tmp_path):
    """limit stops reading upstream; map(f).limit(n) maps only the limited
    rows (counted by marker files, which every task sees)."""
    def case(ns):
        marks = tmp_path / ns.name
        marks.mkdir()

        def spy(x):
            (marks / f"{x}").touch()
            return x * 10

        out = ns.data.from_items(list(range(100)), parallelism=10).map(spy).limit(5).take_all()
        mapped = len(os.listdir(marks))
        n = ns.data.range(1000, parallelism=100).limit(7).count()
        kinds = [o.kind for o in ns.data.dataset.Dataset._optimize([
            ns.data.dataset._Op(kind="input", blocks=[]),
            ns.data.dataset._Op(kind="map_rows", fn=spy),
            ns.data.dataset._Op(kind="limit", n=3), ns.data.dataset._Op(kind="limit", n=2)])]
        return _rows(out), mapped, n, kinds

    out, mapped, n, kinds = _same(_both(case))
    assert out == _rows([0, 10, 20, 30, 40]) and mapped <= 10 and n == 7
    assert kinds == ["input", "limit", "map_rows"]


def test_streaming_split_equal_rows_and_epochs():
    def case(ns):
        ds = ns.data.from_items([{"id": i} for i in range(21)], parallelism=3)
        it0, it1 = ds.streaming_split(2, equal=True)
        first = [_batches(it.iter_batches(batch_size=5)) for it in (it0, it1)]
        again = _batches(it0.iter_batches(batch_size=5))
        return first, again

    (r0, r1), again = _same(_both(case))
    assert sum(len(b["id"][2]) for b in r0) == sum(len(b["id"][2]) for b in r1) == 10
    assert again == r0


def test_from_numpy_batches_and_schema():
    rng = np.random.default_rng(2)
    arrays = {"x": rng.random((20, 4)).astype(np.float32), "i": np.arange(20, dtype=np.int32),
              "b": rng.random(20) > 0.5, "s": np.array([f"r{i}" for i in range(20)])}

    def case(ns):
        ds = ns.data.from_numpy(arrays, parallelism=4)
        return _batches(ds.iter_batches(batch_size=8)), _rows(ds.take(3)), ds.count()

    _same(_both(case))


@pytest.mark.parametrize("fmt", ["parquet", "csv", "json"])
def test_file_round_trips(tmp_path, fmt):
    """Written by the JAX package (or numpy), read by both: equal rows.
    Parquet is written by each package from the same dataset."""
    pytest.importorskip("pyarrow")
    x = np.arange(20, dtype=np.float32)
    src = tmp_path / "src"
    src.mkdir()
    if fmt == "csv":
        for part in range(2):
            (src / f"p{part}.csv").write_text("a,b,s\n" + "".join(
                f"{i},{i * 0.5},w{i}\n" for i in range(part * 10, part * 10 + 10)))
    elif fmt == "json":
        (src / "p.jsonl").write_text("".join(
            f'{{"a": {i}, "b": {i * 0.5}, "s": "w{i}", "l": [{i}, {i + 1}]}}\n'
            for i in range(15)))

    def case(ns):
        if fmt == "parquet":
            out = tmp_path / ns.name
            files = ns.data.from_numpy({"x": x, "y": x * 2, "t": np.ones((20, 2))},
                                       parallelism=4).write_parquet(str(out))
            ds = ns.data.read_parquet(str(out))
            return len(files), sorted(_rows(ds.take_all())), _batches(ds.iter_batches(
                batch_size=7))
        ds = ns.data.read_csv(str(src)) if fmt == "csv" else ns.data.read_json(str(src))
        return _rows(ds.take_all()), _batches(ds.iter_batches(batch_size=6)), ds.count()

    _same(_both(case))


# ---------------------------------------------------------------- executors


def _pipeline(data):
    return (data.range(60, parallelism=6).map(lambda r: {"id": r["id"] + 1})
            .filter(lambda r: r["id"] % 2 == 0).map_batches(lambda b: {"id": b["id"] * 3}))


def test_executor_generations_agree(monkeypatch):
    def case(ns):
        out = {}
        for gen in ("v1", "v2"):
            monkeypatch.setenv("RAY_TPU_DATA_EXECUTOR", gen)
            ds = _pipeline(ns.data)
            out[gen] = (_rows(ds.take_all()), type(ds._last_executors[-1]).__name__)
        return out

    got = _same(_both(case))
    assert got["v1"][0] == got["v2"][0]
    assert (got["v1"][1], got["v2"][1]) == ("StreamingExecutor", "PipelineExecutor")


def test_pool_bounds_from_concurrency():
    from ray_tpu_torch.data.dataset import Dataset

    for spec in (None, 3, (2, 5), (0, 5)):
        assert Dataset._pool_bounds(spec) == ray_tpu.data.dataset.Dataset._pool_bounds(spec)


def _ladder(op_pool, monkeypatch, up_s, idle_s, ticks):
    declared = []
    monkeypatch.setattr(op_pool, "_declare_forecast", lambda n, ttl_s=30.0: declared.append(n))
    pool = op_pool.OperatorPool("p", spawn=object, min_size=1, max_size=4, up_s=up_s,
                                idle_s=idle_s)
    pool.start()
    sizes = []
    for backlogged, starved, now in ticks:
        pool.update_pressure(backlogged, starved, now=now)
        sizes.append((pool.size, pool.scale_ups, pool.scale_downs))
    return sizes, declared


def test_operator_pool_scale_ladder_and_blips(monkeypatch):
    """The same pressure ticks through both packages' pools: the same sizes,
    scale-ups, scale-downs and forecasts, including a calm blip inside a
    streak (kept) and a real calm stretch (restarts the clock)."""
    import ray_tpu.data.op_pool as jpool

    import ray_tpu_torch.data.op_pool as tpool

    ladder = [(True, True, 10.0), (True, True, 10.6), (True, True, 11.0), (True, True, 11.6),
              (True, True, 12.2), (False, False, 20.0), (False, False, 21.1),
              (False, False, 22.2), (False, False, 23.3), (False, False, 24.4)]
    blips = [(True, True, 10.0), (False, True, 10.2), (True, True, 10.6), (True, True, 20.0),
             (False, False, 20.4), (True, True, 20.5), (True, True, 20.9)]
    for ticks, up_s, idle_s in ((ladder, 0.5, 1.0), (blips, 0.5, 10.0)):
        want = _ladder(jpool, monkeypatch, up_s, idle_s, ticks)
        assert _ladder(tpool, monkeypatch, up_s, idle_s, ticks) == want
    sizes, declared = _ladder(tpool, monkeypatch, 0.5, 1.0, ladder)
    assert [s[0] for s in sizes] == [1, 2, 2, 4, 4, 4, 3, 2, 1, 1] and declared == [1, 2]


def test_unknown_size_counts_at_observed_mean():
    from ray_tpu_torch.data.streaming import BlockSizeEstimator

    est = BlockSizeEstimator()
    assert est.estimate(object()) == 0
    est.observe(10)
    est.observe(20)
    assert est.mean == 15 and est.estimate(object()) == 15


def test_bounded_queued_bytes_under_skew(monkeypatch):
    """A slow middle operator backpressures the fast source through its byte
    budget (every block weighs 4 MiB, the budget is 8 MiB), in both
    packages; local mode skips sizing unless block_nbytes is replaced."""
    import ray_tpu.data.streaming as jstream
    from ray_tpu.utils.config import CONFIG

    import ray_tpu_torch.data.streaming as tstream
    from ray_tpu_torch.utils import config

    block = 4 << 20
    monkeypatch.setattr(jstream, "block_nbytes", lambda ref: block)
    monkeypatch.setattr(tstream, "block_nbytes", lambda ref: block)
    monkeypatch.setattr(CONFIG, "data_op_budget_bytes", 8 << 20)
    monkeypatch.setattr(config, "DATA_OP_BUDGET_BYTES", 8 << 20)
    monkeypatch.setenv("RAY_TPU_DATA_EXECUTOR", "v2")

    def case(ns):
        class SlowPass:
            def __call__(self, batch):
                time.sleep(0.03)
                return batch

        n_blocks = 32
        ds = (ns.data.range(n_blocks * 8, parallelism=n_blocks).map_batches(lambda b: b)
              .map_batches(SlowPass, concurrency=1))
        total = sum(1 for _ in ds.iter_block_refs(prefetch=2))
        ex = ds._last_executors[-1]
        return (total, ex._sizing, 0 < ex.stats["peak_queued_bytes"] <= n_blocks * block // 2,
                sum(op.backpressure_events for op in ex._ops) > 0, ex._queued_total)

    got = _both(case)
    assert got["torch"] == (32, True, True, True, 0), got


def test_sizing_is_skipped_without_a_store(monkeypatch):
    monkeypatch.setenv("RAY_TPU_DATA_EXECUTOR", "v2")

    def case(ns):
        ds = ns.data.range(100, parallelism=4).map_batches(lambda b: b)
        n = ds.count()
        ex = ds._last_executors[-1]
        return n, ex._sizing, ex.stats["peak_queued_bytes"]

    assert _same(_both(case)) == (100, False, 0)


def test_consumer_stall_backpressures_the_source(monkeypatch):
    monkeypatch.setenv("RAY_TPU_DATA_EXECUTOR", "v2")

    def case(ns):
        n_blocks = 40
        ds = ns.data.range(n_blocks * 4, parallelism=n_blocks).map_batches(lambda b: b)
        it = ds.iter_block_refs(prefetch=2)
        assert next(it) is not None
        time.sleep(0.4)
        ex = ds._last_executors[-1]
        stalled = ex.stats["source_pulled"]
        rest = sum(1 for _ in it)
        return stalled <= 12, 1 + rest, ex.stats["source_pulled"]

    assert _same(_both(case)) == (True, 40, 40)


def test_one_coordinator_ships_to_every_shard():
    """Shards pickled after prepare_shipping share one SplitCoordinator (the
    port ships them through core/serialization.py, the JAX package through
    cloudpickle)."""
    import cloudpickle

    def case(ns):
        split = ns.data.range(80, parallelism=4).streaming_split(2)
        split.prepare_shipping()
        if ns.name == "jax":
            shards = cloudpickle.loads(cloudpickle.dumps(list(split)))
        else:
            shards = serialization.loads(serialization.dumps(list(split)))
        seen = [_batches(s.iter_batches(batch_size=40)) for s in shards]
        return seen

    seen = _same(_both(case))
    assert sorted(v for shard in seen for b in shard for v in b["id"][2]) == list(range(80))


def test_an_iterated_dataset_still_ships():
    """A dataset that ran here (its executors hold threads) pickles for a
    trainer's workers or a feeder, and runs the same there."""
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(local_mode=True, num_cpus=4)
    try:
        ds = ray_tpu_torch.data.range(40, parallelism=4).map_batches(lambda b: {"id": b["id"] * 2})
        assert ds.count() == 40 and ds._last_executors
        again = serialization.loads(serialization.dumps(ds))
        assert not hasattr(again, "_last_executors")
        assert _rows(bounded(again.take_all, CASE_S)) == _rows(
            [{"id": 2 * i} for i in range(40)])
    finally:
        ray_tpu_torch.shutdown()


def test_streaming_split_to_channel():
    def case(ns):
        feeds = ns.data.range(120, parallelism=6).streaming_split(2).to_channel()
        return [_batches(f.iterator().iter_batches(batch_size=30)) for f in feeds]

    got = _same(_both(case))
    assert [[len(b["id"][2]) for b in shard] for shard in got] == [[30, 30], [30, 30]]


def test_iter_device_batches_places_tensors():
    """On the port: torch tensors on the caller's device; None outside a
    session means the current CUDA device, which raises without one."""
    import torch

    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(local_mode=True, num_cpus=4)
    try:
        ds = ray_tpu_torch.data.from_numpy({"x": np.arange(64, dtype=np.float32).reshape(64, 1),
                                            "i": np.arange(64, dtype=np.int32)})
        (it,) = ds.streaming_split(1)
        batches = bounded(lambda: list(it.iter_device_batches(batch_size=16, device="cpu")),
                          CASE_S)
        assert len(batches) == 4 and batches[0]["x"].device.type == "cpu"
        assert batches[0]["x"].dtype == torch.float64 and batches[0]["i"].dtype == torch.int64
        assert torch.equal(torch.cat([b["i"] for b in batches]), torch.arange(64))
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="no CUDA device"):
                next(iter(it.iter_device_batches(batch_size=16)))
    finally:
        ray_tpu_torch.shutdown()


def test_zygote_imports_the_device_stack_beside_a_card_only(monkeypatch):
    """The zygote's idle-time import of the flash op's first dispatch is
    planned only where an NVIDIA driver is (a file test, no CUDA call)."""
    from ray_tpu_torch.core import zygote

    monkeypatch.setattr(zygote.os.path, "exists", lambda p: p == "/dev/nvidiactl")
    planned = zygote._device_stack_to_import()
    assert set(planned) <= set(zygote._PREWARM_DEVICE)
    assert [m for m in zygote._PREWARM_DEVICE if m not in sys.modules] == planned
    monkeypatch.setattr(zygote.os.path, "exists", lambda p: False)
    assert zygote._device_stack_to_import() == []
    assert "ray_tpu_torch.data" in zygote._PREWARM


# ------------------------------------------------ TorchTrainer(datasets=...)


N_ROWS, D_IN, D_HID, BATCH, LR = 256, 8, 16, 32, 0.1


def _train_rows():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((N_ROWS, D_IN)).astype(np.float32)
    y = (x @ rng.standard_normal((D_IN, 1)) + 0.1).astype(np.float32)
    return {"row": np.arange(N_ROWS, dtype=np.int64), "x": x, "y": y}


def _init_weights():
    rng = np.random.default_rng(6)
    return {"w1": (rng.standard_normal((D_IN, D_HID)) * 0.3).astype(np.float32),
            "w2": (rng.standard_normal((D_HID, 1)) * 0.3).astype(np.float32)}


def _torch_ingest_loop(config):
    """The port's loop: this rank's shard through iter_device_batches on the
    CPU, a 2-layer MLP, plain SGD; reports the rows seen and the losses."""
    import torch

    from ray_tpu_torch import train

    w = {k: torch.tensor(v, requires_grad=True) for k, v in config["weights"].items()}
    rows, losses = [], []
    shard = train.get_dataset_shard("train")
    for batch in shard.iter_device_batches(batch_size=BATCH, drop_last=False, device="cpu"):
        rows.extend(batch["row"].tolist())
        x, y = batch["x"].float(), batch["y"].float()
        loss = ((torch.relu(x @ w["w1"]) @ w["w2"] - y) ** 2).mean()
        loss.backward()
        with torch.no_grad():
            for t in w.values():
                t -= LR * t.grad
                t.grad = None
        losses.append(loss.item())
    train.report({"rows": len(rows), "row_ids": rows, "losses": losses,
                  "rank": train.get_context().get_world_rank()})


def _jax_ingest_loop_maker():
    """The JAX package's same loop (made inside a function, so cloudpickle
    ships it by value)."""
    def loop(config):
        import jax
        import jax.numpy as jnp

        from ray_tpu import train

        def loss_fn(w, x, y):
            return jnp.mean((jax.nn.relu(x @ w["w1"]) @ w["w2"] - y) ** 2)

        grad = jax.jit(jax.value_and_grad(loss_fn))
        w = {k: jnp.asarray(v) for k, v in config["weights"].items()}
        rows, losses = [], []
        shard = train.get_dataset_shard("train")
        for batch in shard.iter_device_batches(batch_size=BATCH, drop_last=False):
            rows.extend(np.asarray(batch["row"]).tolist())
            loss, g = grad(w, batch["x"].astype(jnp.float32), batch["y"].astype(jnp.float32))
            w = {k: w[k] - LR * g[k] for k in w}
            losses.append(float(loss))
        train.report({"rows": len(rows), "row_ids": rows, "losses": losses,
                      "rank": train.get_context().get_world_rank()})

    return loop


@pytest.fixture(scope="module")
def jax_ingest():
    """The JaxTrainer's run on its local runtime, per dataset_config."""
    import jax

    from ray_tpu.parallel import MeshSpec
    from ray_tpu.train import JaxTrainer, RunConfig, ScalingConfig

    old = jax.config.jax_default_matmul_precision
    jax.config.update("jax_default_matmul_precision", "highest")
    out = {}
    ray_tpu.shutdown()
    ray_tpu.init(local_mode=True, num_cpus=8)
    try:
        import tempfile

        for cfg in ("object_store", "channel"):
            result = bounded(JaxTrainer(
                _jax_ingest_loop_maker(), train_loop_config={"weights": _init_weights()},
                scaling_config=ScalingConfig(num_workers=2, mesh=MeshSpec(data=-1)),
                run_config=RunConfig(name=f"jax_{cfg}", storage_path=tempfile.mkdtemp()),
                datasets={"train": ray_tpu.data.from_numpy(_train_rows(), parallelism=8)},
                dataset_config=cfg).fit, CASE_S)
            assert result.error is None, result.error
            out[cfg] = result.metrics
    finally:
        ray_tpu.shutdown()
        jax.config.update("jax_default_matmul_precision", old)
    return out


@pytest.fixture(scope="module")
def clusters():
    booted = torch_modes.Clusters(num_cpus=8)
    try:
        yield booted
    finally:
        booted.shutdown()


@pytest.mark.parametrize("mode", ["local", "cluster"])
@pytest.mark.parametrize("dataset_config", ["object_store", "channel"])
def test_torch_trainer_datasets(request, tmp_path, jax_ingest, mode, dataset_config):
    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer

    want = jax_ingest[dataset_config]
    clusters = request.getfixturevalue("clusters") if mode == "cluster" else None
    with torch_modes.case_time_limit(request, 150):
        with torch_modes.runtime_for(clusters, "torch", mode, num_cpus=8) as rt:
            result = bounded(TorchTrainer(
                _torch_ingest_loop, train_loop_config={"weights": _init_weights()},
                scaling_config=ScalingConfig(num_workers=2, use_gpu=False),
                run_config=RunConfig(name=f"ingest_{dataset_config}", storage_path=str(tmp_path)),
                datasets={"train": rt.data.from_numpy(_train_rows(), parallelism=8)},
                dataset_config=dataset_config).fit, CASE_S)
    assert result.error is None, result.error
    m = result.metrics
    assert m["rows"] == want["rows"] == 128  # an equal split of 256 over 2 ranks
    assert m["rank"] == want["rank"] == 0 and m["row_ids"] == want["row_ids"]
    assert m["phase_seconds"]["data_wait"] > 0 and want["phase_seconds"]["data_wait"] > 0
    assert len(m["losses"]) == len(want["losses"]) == 4
    np.testing.assert_allclose(m["losses"], want["losses"], rtol=0, atol=LOSS_TOL)


def test_trainer_rejects_an_unknown_dataset_config():
    from ray_tpu_torch.train import TorchTrainer

    with pytest.raises(ValueError, match="dataset_config"):
        TorchTrainer(lambda config: None, dataset_config="teleport")
