"""Block layer: the unit of distributed data (the port of
ray_tpu/data/block.py).

A block is either a dict of equal-length numpy columns (tabular) or a list
of rows. The JAX package's tabular block is a pyarrow Table; the port's is
the dict on every machine, with or without pyarrow, so the code the CPU
tests run is the code that runs beside the card. It keeps the batches and
rows the Table gives:

- a 1-D column keeps its dtype, but strings and bytes are `object` arrays
  (pyarrow's conversion gives those, never `<U`/`S`);
- a tensor column (ndim > 1) is stored the way `_column_to_numpy` returns a
  list column: bool, int64 or float64 (a list column round-trips through
  Python scalars);
- `iter_rows` yields dicts of Python scalars (`.tolist()`), as `as_py()`
  does, so rows compare by Python equality and `repr` alike in both
  packages (the shuffle's order and groupby's partitions depend on it);
- rows become columns only where pyarrow's inference would make a column
  (ints and floats widen to float64, bools stay bool, strings are objects);
  a mix it refuses (bools with numbers, numbers with strings, None) stays a
  list of rows.

Batches surface as dicts of numpy arrays. `to_batch("pandas")` and
`to_batch("pyarrow")` import those libraries inside the call.
"""

from __future__ import annotations

import sys
from typing import Any, Dict, Iterator, List, Optional, Union

import numpy as np

Block = Union[Dict[str, np.ndarray], List[Any]]
Batch = Union[Dict[str, np.ndarray], "list", Any]


def _is_table(block) -> bool:
    return isinstance(block, dict)


def _canonical(arr: np.ndarray) -> np.ndarray:
    """A tensor column as a list column round-trips: bool, int64, float64,
    anything else an object array."""
    kind = arr.dtype.kind
    if kind == "b":
        return arr.astype(np.bool_, copy=False)
    if kind in "iu":
        return arr.astype(np.int64, copy=False)
    if kind == "f":
        return arr.astype(np.float64, copy=False)
    return arr.astype(object)


def _object_array(values: List[Any]) -> np.ndarray:
    out = np.empty(len(values), dtype=object)
    for i, v in enumerate(values):
        out[i] = v
    return out


def _column(arr: np.ndarray) -> np.ndarray:
    """A batch column as the block stores it."""
    if arr.ndim > 1:
        return _canonical(arr)
    if arr.dtype.kind in "US":
        return _object_array(arr.tolist())
    return arr


def _read_only(arr: np.ndarray) -> np.ndarray:
    """A view the caller cannot write through (the block may be the stored
    object itself on the in-process runtime; an arrow column's numpy view is
    read-only in the JAX package too)."""
    view = arr.view()
    view.flags.writeable = False
    return view


def _import(name: str):
    try:
        return __import__(name, fromlist=["_"])
    except ImportError as e:
        raise ImportError(f"batch_format needs {name}, which is not installed") from e


def _to_arrow(block: Dict[str, np.ndarray]):
    pa = _import("pyarrow")
    return pa.table({k: pa.array(list(v)) if v.ndim > 1 else pa.array(v)
                     for k, v in block.items()})


def from_arrow(table) -> Dict[str, np.ndarray]:
    """A pyarrow Table as a block (the file readers' output): list columns
    stack into dense arrays, as `_column_to_numpy` does."""
    out = {}
    for name in table.schema.names:
        col = table.column(name).combine_chunks()
        values = col.to_pylist() if str(col.type).startswith(("list", "large_list",
                                                                "fixed_size_list")) else None
        if values is not None:
            arr = np.array(values)
            out[name] = arr if arr.dtype != object else _object_array(values)
        else:
            out[name] = _column(np.asarray(col.to_numpy(zero_copy_only=False)))
    return out


class BlockAccessor:
    """Uniform view over a block (reference: python/ray/data/block.py:389)."""

    def __init__(self, block: Block):
        self._block = block

    @staticmethod
    def for_block(block: Block) -> "BlockAccessor":
        return BlockAccessor(block)

    # ------------------------------------------------------------- basics
    def num_rows(self) -> int:
        if _is_table(self._block):
            return len(next(iter(self._block.values()))) if self._block else 0
        return len(self._block)

    def size_bytes(self) -> int:
        if _is_table(self._block):
            return sum(v.nbytes for v in self._block.values())
        try:
            return sum(sys.getsizeof(r) for r in self._block)
        except Exception:
            return 0

    def schema(self):
        """Column name -> dtype (a tensor column's with its row shape) for a
        table; for rows, as the JAX package gives them."""
        if _is_table(self._block):
            return {k: str(v.dtype) + (str(list(v.shape[1:])) if v.ndim > 1 else "")
                    for k, v in self._block.items()}
        if self._block:
            first = self._block[0]
            if isinstance(first, dict):
                return {k: type(v).__name__ for k, v in first.items()}
            return type(first).__name__
        return None

    # -------------------------------------------------------------- views
    def iter_rows(self) -> Iterator[Any]:
        if _is_table(self._block):
            cols = {k: v.tolist() for k, v in self._block.items()}
            for i in range(self.num_rows()):
                yield {k: v[i] for k, v in cols.items()}
        else:
            yield from self._block

    def to_batch(self, batch_format: str = "numpy") -> Batch:
        if batch_format not in ("numpy", "pandas", "pyarrow", "rows"):
            raise ValueError(f"unknown batch_format {batch_format!r}")
        if _is_table(self._block):
            if batch_format == "numpy":
                return {k: _read_only(v) for k, v in self._block.items()}
            if batch_format == "pandas":
                pd = _import("pandas")
                return pd.DataFrame({k: list(v) if v.ndim > 1 else v
                                     for k, v in self._block.items()})
            if batch_format == "pyarrow":
                return _to_arrow(self._block)
            raise ValueError(f"unknown batch_format {batch_format!r}")
        rows = self._block
        if batch_format == "rows":
            return rows
        if rows and isinstance(rows[0], dict):
            if batch_format == "numpy":
                keys = rows[0].keys()
                return {k: np.asarray([r[k] for r in rows]) for k in keys}
            if batch_format == "pandas":
                return _import("pandas").DataFrame(rows)
            return _import("pyarrow").Table.from_pylist(rows)
        # Simple (non-dict) rows surface as an "item" column, matching the
        # reference's simple-dataset batch convention.
        if batch_format == "numpy":
            return {"item": np.asarray(rows)}
        if batch_format == "pandas":
            return _import("pandas").DataFrame({"item": rows})
        pa = _import("pyarrow")
        return pa.table({"item": pa.array(rows)})

    def slice(self, start: int, end: int) -> Block:
        if _is_table(self._block):
            return {k: v[start:end] for k, v in self._block.items()}
        return self._block[start:end]


def block_from_batch(batch: Batch) -> Block:
    """Normalizes a user-returned batch back into a block."""
    if isinstance(batch, dict):
        cols = {k: _column(np.asarray(v)) for k, v in batch.items()}
        if len({len(v) for v in cols.values()}) > 1:
            raise ValueError(f"batch columns differ in length: "
                             f"{ {k: len(v) for k, v in cols.items()} }")
        return cols
    if isinstance(batch, list):
        return batch
    mod = type(batch).__module__.split(".")[0]
    if mod == "pandas":
        cols = {}
        for k in batch.columns:
            values = batch[k].tolist()
            col = (_infer_column(values) if batch[k].dtype == object and values
                   else _column(batch[k].to_numpy()))
            if col is None:
                raise TypeError(f"DataFrame column {k!r} has values of mixed types")
            cols[k] = col
        return cols
    if mod == "pyarrow":
        return from_arrow(batch)
    raise TypeError(f"cannot convert batch of type {type(batch).__name__} to a block")


# Row values pyarrow infers one column type for: the kinds of a column's
# values -> its dtype (None: no column, the rows stay a list).
def _infer_column(values: List[Any]) -> Optional[np.ndarray]:
    first = values[0]
    if isinstance(first, (bool, np.bool_)):
        if all(isinstance(v, (bool, np.bool_)) for v in values):
            return np.array(values, dtype=np.bool_)
        return None
    if isinstance(first, (int, float, np.integer, np.floating)):
        if not all(isinstance(v, (int, float, np.integer, np.floating))
                   and not isinstance(v, (bool, np.bool_)) for v in values):
            return None
        dtypes = {v.dtype for v in values if isinstance(v, np.generic)}
        if len(dtypes) == 1 and all(isinstance(v, np.generic) for v in values):
            return np.array(values, dtype=dtypes.pop())
        if any(isinstance(v, (float, np.floating)) for v in values):
            return np.array(values, dtype=np.float64)
        try:
            return np.array(values, dtype=np.int64)
        except OverflowError:
            return None
    if isinstance(first, str):
        return _object_array(values) if all(isinstance(v, str) for v in values) else None
    if isinstance(first, bytes):
        return _object_array(values) if all(isinstance(v, bytes) for v in values) else None
    if isinstance(first, (list, tuple, np.ndarray)):
        if not all(isinstance(v, (list, tuple, np.ndarray)) for v in values):
            return None
        plain = [v.tolist() if isinstance(v, np.ndarray) else v for v in values]
        try:
            arr = np.array(plain)
        except ValueError:  # ragged: a list column of unequal lengths
            return _object_array(plain)
        return _canonical(arr) if arr.dtype.kind in "bif" else _object_array(plain)
    if isinstance(first, dict):
        return _object_array(values) if all(isinstance(v, dict) for v in values) else None
    return None


def block_from_rows(rows: List[Any]) -> Block:
    """Rows -> block; dict rows become columns where pyarrow's inference
    would (see the module docstring), else they stay a list."""
    if not rows or not isinstance(rows[0], dict):
        return rows
    keys = list(rows[0])
    if not keys or not all(isinstance(r, dict) and list(r) == keys for r in rows):
        return rows
    cols = {}
    for k in keys:
        col = _infer_column([r[k] for r in rows])
        if col is None:
            return rows
        cols[k] = col
    return cols


def concat_blocks(blocks: List[Block]) -> Block:
    real = [b for b in blocks if BlockAccessor(b).num_rows() > 0]
    if not real:
        return blocks[0] if blocks else []
    if all(_is_table(b) for b in real):
        first = real[0]
        if all(list(b) == list(first) and all(b[k].dtype == first[k].dtype
                                             and b[k].shape[1:] == first[k].shape[1:]
                                             for k in first) for b in real):
            return {k: np.concatenate([b[k] for b in real]) for k in first}
    out: List[Any] = []
    for b in real:
        out.extend(BlockAccessor(b).iter_rows())
    return out
