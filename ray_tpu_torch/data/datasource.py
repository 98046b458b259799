"""Datasources/sinks: pluggable readers producing block-generating tasks
(the port of ray_tpu/data/datasource.py).

Re-design of the reference's Datasource/Datasink ABCs (reference:
python/ray/data/datasource/datasource.py, datasink.py,
file_based_datasource.py). A datasource yields ReadTasks — picklable
zero-arg callables returning one block each — which the executor runs as
distributed tasks; file readers split by file. Range, numpy and items
sources need nothing beyond numpy; the parquet, CSV and JSON readers and the
parquet sink import pyarrow inside the call, as the JAX package's do, and
turn its Table into the port's block (`block.from_arrow`).
"""

from __future__ import annotations

import glob
import os
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from .block import Block, block_from_rows


@dataclass
class ReadTask:
    fn: Callable[[], Block]
    num_rows: Optional[int] = None
    input_files: Optional[List[str]] = None

    def __call__(self) -> Block:
        return self.fn()


class Datasource:
    """ABC (reference: python/ray/data/datasource/datasource.py:24)."""

    def get_read_tasks(self, parallelism: int) -> List[ReadTask]:
        raise NotImplementedError

    def estimate_inmemory_data_size(self) -> Optional[int]:
        return None


class RangeDatasource(Datasource):
    def __init__(self, n: int):
        self.n = n

    def get_read_tasks(self, parallelism: int) -> List[ReadTask]:
        parallelism = max(1, min(parallelism, self.n or 1))
        per = (self.n + parallelism - 1) // parallelism
        tasks = []
        for start in range(0, self.n, per):
            end = min(start + per, self.n)

            def read(start=start, end=end) -> Block:
                return {"id": np.arange(start, end, dtype=np.int64)}

            tasks.append(ReadTask(read, num_rows=end - start))
        return tasks


class NumpyDatasource(Datasource):
    def __init__(self, arrays: Dict[str, np.ndarray]):
        sizes = {len(v) for v in arrays.values()}
        if len(sizes) != 1:
            raise ValueError("all arrays must share the leading dimension")
        self.arrays = arrays
        self.n = next(iter(sizes))

    def get_read_tasks(self, parallelism: int) -> List[ReadTask]:
        parallelism = max(1, min(parallelism, self.n or 1))
        per = (self.n + parallelism - 1) // parallelism
        tasks = []
        for start in range(0, self.n, per):
            end = min(start + per, self.n)
            shard = {k: v[start:end] for k, v in self.arrays.items()}

            def read(shard=shard) -> Block:
                from .block import block_from_batch

                return block_from_batch(shard)

            tasks.append(ReadTask(read, num_rows=end - start))
        return tasks


class ItemsDatasource(Datasource):
    def __init__(self, items: List[Any]):
        self.items = list(items)

    def get_read_tasks(self, parallelism: int) -> List[ReadTask]:
        n = len(self.items)
        parallelism = max(1, min(parallelism, n or 1))
        per = (n + parallelism - 1) // parallelism
        tasks = []
        for start in range(0, n, per):
            chunk = self.items[start : start + per]

            def read(chunk=chunk) -> Block:
                return block_from_rows(chunk)

            tasks.append(ReadTask(read, num_rows=len(chunk)))
        return tasks


def _expand_paths(paths, suffixes) -> List[str]:
    if isinstance(paths, str):
        paths = [paths]
    out: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            for suf in suffixes:
                out.extend(sorted(glob.glob(os.path.join(p, f"**/*{suf}"), recursive=True)))
        elif any(ch in p for ch in "*?["):
            out.extend(sorted(glob.glob(p)))
        else:
            out.append(p)
    if not out:
        raise FileNotFoundError(f"no files matched {paths}")
    return out


class ParquetDatasource(Datasource):
    """(reference: python/ray/data/datasource/parquet_datasource.py)"""

    def __init__(self, paths, columns: Optional[List[str]] = None):
        self.files = _expand_paths(paths, (".parquet",))
        self.columns = columns

    def get_read_tasks(self, parallelism: int) -> List[ReadTask]:
        tasks = []
        for f in self.files:

            def read(f=f, columns=self.columns) -> Block:
                import pyarrow.parquet as pq

                from .block import from_arrow

                return from_arrow(pq.read_table(f, columns=columns))

            tasks.append(ReadTask(read, input_files=[f]))
        return tasks


class CSVDatasource(Datasource):
    def __init__(self, paths):
        self.files = _expand_paths(paths, (".csv",))

    def get_read_tasks(self, parallelism: int) -> List[ReadTask]:
        tasks = []
        for f in self.files:

            def read(f=f) -> Block:
                import pyarrow.csv as pacsv

                from .block import from_arrow

                return from_arrow(pacsv.read_csv(f))

            tasks.append(ReadTask(read, input_files=[f]))
        return tasks


class JSONDatasource(Datasource):
    def __init__(self, paths):
        self.files = _expand_paths(paths, (".json", ".jsonl"))

    def get_read_tasks(self, parallelism: int) -> List[ReadTask]:
        tasks = []
        for f in self.files:

            def read(f=f) -> Block:
                import pyarrow.json as pajson

                from .block import from_arrow

                return from_arrow(pajson.read_json(f))

            tasks.append(ReadTask(read, input_files=[f]))
        return tasks


# --------------------------------------------------------------------- sinks


def write_parquet_block(block: Block, path: str, index: int) -> str:
    import pyarrow.parquet as pq

    from .block import BlockAccessor, _is_table, block_from_rows

    if not _is_table(block):
        block = block_from_rows(list(BlockAccessor(block).iter_rows()))
        if not _is_table(block):
            raise TypeError("cannot write non-tabular block to parquet")
    os.makedirs(path, exist_ok=True)
    out = os.path.join(path, f"part-{index:05d}.parquet")
    pq.write_table(BlockAccessor(block).to_batch("pyarrow"), out)
    return out
