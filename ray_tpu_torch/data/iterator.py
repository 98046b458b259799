"""Batch iteration + streaming split for training workers (the port of
ray_tpu/data/iterator.py).

Re-design of the reference's DataIterator / StreamSplitDataIterator
(reference: python/ray/data/iterator.py,
_internal/iterator/stream_split_iterator.py:32 with the SplitCoordinator
actor at :124). `iter_device_batches` lands each batch as torch tensors on
an explicit device: the caller's `device`, else the training worker's (its
CUDA device, or the CPU under ScalingConfig(use_gpu=False)), else the
current CUDA device, raising without one; with `mesh=` the tensors become
DTensors over its batch axes (parallel/sharding.py `shard_batch`). Host to
device copies are plain `.to(device)`: pinned-memory staging is a speed
change left for a later PR (ROADMAP's held findings).
"""

from __future__ import annotations

import random
import threading
from typing import Any, Callable, Dict, Iterator, List, Optional

from .. import api
from ..core import serialization
from .block import Block, BlockAccessor, block_from_rows


def rebatch_blocks(
    blocks: Iterator[Block],
    *,
    batch_size: Optional[int],
    batch_format: str = "numpy",
    drop_last: bool = False,
    shuffle_buffer_size: Optional[int] = None,
    shuffle_seed: Optional[int] = None,
) -> Iterator[Any]:
    """Re-slices a stream of blocks into fixed-size batches, with optional
    local shuffle buffer (reference: _internal/block_batching/)."""
    rng = random.Random(shuffle_seed)
    row_buffer: List[Any] = []

    for block in blocks:
        row_buffer.extend(BlockAccessor(block).iter_rows())
        if shuffle_buffer_size and len(row_buffer) < shuffle_buffer_size:
            continue
        while batch_size and len(row_buffer) >= batch_size:
            if shuffle_buffer_size:
                rng.shuffle(row_buffer)
            chunk, row_buffer[:] = row_buffer[:batch_size], row_buffer[batch_size:]
            yield _format_rows(chunk, batch_format)
    # Tail: shuffle once if requested (covers buffers that never reached
    # shuffle_buffer_size — otherwise a large buffer silently disables
    # shuffling for the whole stream).
    if shuffle_buffer_size and row_buffer:
        rng.shuffle(row_buffer)
    while row_buffer:
        if batch_size is None:
            chunk, row_buffer[:] = row_buffer[:], []
        elif len(row_buffer) >= batch_size:
            chunk, row_buffer[:] = row_buffer[:batch_size], row_buffer[batch_size:]
        elif drop_last:
            break
        else:
            chunk, row_buffer[:] = row_buffer[:], []
        yield _format_rows(chunk, batch_format)


def _format_rows(rows: List[Any], batch_format: str) -> Any:
    block = block_from_rows(rows)
    if batch_format == "numpy" and isinstance(block, dict):
        return block  # fresh columns: no stored block to guard (block.py _read_only)
    return BlockAccessor(block).to_batch(batch_format)


class DataIterator:
    """One worker's view of a dataset shard."""

    def __init__(self, block_ref_fn: Callable[[], Iterator[Any]]):
        self._block_ref_fn = block_ref_fn

    def iter_batches(
        self,
        *,
        batch_size: Optional[int] = 256,
        batch_format: str = "numpy",
        drop_last: bool = False,
        local_shuffle_buffer_size: Optional[int] = None,
        local_shuffle_seed: Optional[int] = None,
        prefetch_batches: int = 2,
    ) -> Iterator[Any]:
        def block_iter():
            for ref in self._block_ref_fn():
                yield api.get(ref)

        yield from rebatch_blocks(
            block_iter(),
            batch_size=batch_size,
            batch_format=batch_format,
            drop_last=drop_last,
            shuffle_buffer_size=local_shuffle_buffer_size,
            shuffle_seed=local_shuffle_seed,
        )

    def iter_device_batches(
        self,
        *,
        batch_size: int,
        mesh=None,
        drop_last: bool = True,
        batch_format: str = "numpy",
        device=None,
    ) -> Iterator[Any]:
        """Batches as dicts of torch tensors on `device` (see the module
        docstring for None); with `mesh`, DTensors over its batch axes.

        Every host-side pull is bracketed in `train.phase("data_wait")`,
        so input-pipeline stalls land in the goodput/MFU telemetry
        (raytpu_train_phase_time_ms + the per-report phase_seconds
        breakdown). A no-op outside a training session."""
        import torch

        from ..train.session import get_session
        from ..train.session import phase as _train_phase

        target = _batch_device(device, get_session())
        it = self.iter_batches(
            batch_size=batch_size, batch_format=batch_format, drop_last=drop_last
        )
        _SENTINEL = object()
        while True:
            with _train_phase("data_wait"):
                batch = next(it, _SENTINEL)
            if batch is _SENTINEL:
                return
            tensors = {k: torch.as_tensor(v).to(target) for k, v in batch.items()}
            if mesh is not None:
                from ..parallel.sharding import shard_batch

                yield shard_batch(tensors, mesh)
            else:
                yield tensors


def _batch_device(device, session):
    """The device of `iter_device_batches`: the caller's, else the training
    worker's, else the current CUDA device (raising without one)."""
    from .._device import resolve_device

    if device is None and session is not None and getattr(session, "device", None) is not None:
        return session.device
    return resolve_device(device)


class SplitCoordinator:
    """Actor distributing one stream of blocks to n consumers
    (reference: stream_split_iterator.py:124). Each epoch's split is
    computed once and cached, so workers iterating at different rates all
    see the SAME data for the same epoch (no re-execution rewind)."""

    def __init__(self, dataset_blob: bytes, n: int, equal: bool):
        self._dataset = serialization.loads(dataset_blob)
        self._n = n
        self._equal = equal
        self._lock = threading.Lock()
        self._epochs: Dict[int, List[List[Any]]] = {}

    def _compute_epoch(self) -> List[List[Any]]:
        refs = list(self._dataset.iter_block_refs())
        if not self._equal:
            shards: List[List[Any]] = [[] for _ in range(self._n)]
            for i, r in enumerate(refs):
                shards[i % self._n].append(r)
            return shards
        # equal=True: slice to identical row counts, dropping the remainder
        # (SPMD workers must step in lockstep).
        blocks = [api.get(r) for r in refs]
        accs = [BlockAccessor(b) for b in blocks]
        total = sum(a.num_rows() for a in accs)
        per = total // self._n
        shards = []
        bi, off = 0, 0  # (block index, row offset) cursor
        for s in range(self._n):
            need = per
            shard_refs: List[Any] = []
            while need > 0 and bi < len(accs):
                avail = accs[bi].num_rows() - off
                take = min(avail, need)
                if take == avail and off == 0:
                    shard_refs.append(refs[bi])
                else:
                    shard_refs.append(api.put(accs[bi].slice(off, off + take)))
                need -= take
                off += take
                if off >= accs[bi].num_rows():
                    bi, off = bi + 1, 0
            shards.append(shard_refs)
        return shards

    def get_shard_blocks(self, shard: int, epoch: int) -> List[Any]:
        with self._lock:
            if epoch not in self._epochs:
                self._epochs[epoch] = self._compute_epoch()
                # Retain a small history so lagging workers can finish; old
                # epochs beyond that are dropped to bound memory.
                for old in [e for e in self._epochs if e < epoch - 1]:
                    del self._epochs[old]
            return list(self._epochs[epoch][shard])


class SplitStreams(list):
    """The list of per-worker DataIterators `streaming_split` returns,
    plus the channel-delivery upgrade: `.to_channel()` swaps the
    object-store pull path for persistent channel feeds (data/feed.py) —
    one ChannelFeed handle per shard, shippable to the consuming actor."""

    def __init__(self, iterators, dataset, n: int, equal: bool):
        super().__init__(iterators)
        self._dataset = dataset
        self._n = n
        self._equal = equal
        self._coordinator: Optional[Callable[[], Any]] = None

    def prepare_shipping(self) -> None:
        """Forces the shared SplitCoordinator actor into existence before
        the per-shard iterators are pickled to remote workers — otherwise
        each unpickled copy would lazily create its OWN coordinator and
        the epoch-coordination guarantee (same epoch => same data) dies."""
        if self._coordinator is not None:
            self._coordinator()

    def to_channel(self, capacity: Optional[int] = None) -> List[Any]:
        from .feed import _FEED_CAPACITY, make_channel_feeds

        return make_channel_feeds(
            self._dataset,
            self._n,
            equal=self._equal,
            capacity=capacity or _FEED_CAPACITY,
        )


class _LazyCoordinator:
    """Creates the shared SplitCoordinator actor on first use, not at
    split time: a split immediately upgraded with .to_channel() (whose
    BlockFeeder owns its own coordinator state) must not leak an idle
    actor per call. Picklable — and pickling FORCES creation, so every
    shipped shard iterator keeps pointing at the ONE coordinator (each
    copy lazily creating its own would break same-epoch-same-data)."""

    def __init__(self, dataset, n: int, equal: bool):
        self._dataset = dataset
        self._n = n
        self._equal = equal
        self._lock = threading.Lock()
        self._coord: Any = None

    def __call__(self):
        with self._lock:
            if self._coord is None:
                cls = api.remote(max_concurrency=max(2, self._n))(SplitCoordinator)
                self._coord = cls.remote(
                    serialization.dumps(self._dataset), self._n, self._equal
                )
            return self._coord

    def __getstate__(self):
        self()
        return {"coord": self._coord, "n": self._n, "equal": self._equal}

    def __setstate__(self, state):
        self._dataset = None  # remote copies only ever talk to the actor
        self._n = state["n"]
        self._equal = state["equal"]
        self._lock = threading.Lock()
        self._coord = state["coord"]


def make_streaming_split(dataset, n: int, *, equal: bool = True) -> "SplitStreams":
    coordinator = _LazyCoordinator(dataset, n, equal)
    epochs = [0] * n

    def make_fn(shard: int) -> Callable[[], Iterator[Any]]:
        def fn():
            epoch = epochs[shard]
            epochs[shard] += 1
            refs = api.get(coordinator().get_shard_blocks.remote(shard, epoch))
            yield from refs

        return fn

    streams = SplitStreams(
        [DataIterator(make_fn(i)) for i in range(n)], dataset, n, equal
    )
    streams._coordinator = coordinator
    return streams
