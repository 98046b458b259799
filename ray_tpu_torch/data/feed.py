"""Channel delivery: last-mile dataset ingest over persistent channels (the
port of ray_tpu/data/feed.py).

`Dataset.streaming_split(k).to_channel()` turns the k coordinated shard
iterators into k `ChannelFeed` handles. Each consumer (trainer worker,
serve replica) hosts a `core/channel.py` ChannelReader — the same
shared-memory ring the compiled-graph layer and the LLM feed (serve/llm/feed.py, whose attach protocol this mirrors) run on —
and a `BlockFeeder` actor pumps that shard's blocks into the ring,
prefetching object-store fetches ahead of the write cursor.

Why a channel and not `api.get` per block (the DataIterator default): the
pull path pays an RPC round-trip + deserialize INSIDE the consumer's
step loop, which lands directly in the `train.phase("data_wait")`
fraction. The feed moves that work into the feeder actor and overlaps it
with consumer compute; the consumer's read is a ring-buffer pop. A full
ring blocks the feeder's write — consumer-stall backpressure propagates
feeder -> shard iterator -> streaming executor -> source, with no
unbounded queue anywhere.

A consumer on another host than its feeder reads over the channel's TCP
stream (core/channel.py; it needs RAY_TPU_AUTH_TOKEN on both ends).
"""

from __future__ import annotations

import tempfile
import threading
from dataclasses import dataclass
from typing import Any, Iterator, List

from .. import api
from ..core.channel import ChannelClosed, ChannelReader, ChannelWriter
from .iterator import DataIterator

_FEED_CAPACITY = 8 << 20
_EOF = "__rtpu_feed_eof__"


class BlockFeeder:
    """Actor pumping one dataset's shard streams into consumer channels.

    One feeder serves all k shards of one streaming split (it wraps the
    same epoch-cached SplitCoordinator state, so workers iterating at
    different rates see the SAME data for the same epoch); each
    `attach(shard, epoch, spec)` spawns a pump thread bound to that
    consumer's channel."""

    def __init__(self, dataset_blob: bytes, n: int, equal: bool):
        from .iterator import SplitCoordinator

        self._coord = SplitCoordinator(dataset_blob, n, equal)
        self._lock = threading.Lock()
        self._pumps: List[threading.Thread] = []

    def attach(self, shard: int, epoch: int, spec) -> bool:
        """Starts pumping (shard, epoch) into the consumer-hosted channel
        described by `spec`; returns once the pump thread is live."""
        t = threading.Thread(
            target=self._pump,
            args=(shard, epoch, spec),
            name=f"datafeed-{shard}",
            daemon=True,
        )
        with self._lock:
            self._pumps = [p for p in self._pumps if p.is_alive()] + [t]
        t.start()
        return True

    def _pump(self, shard: int, epoch: int, spec) -> None:
        writer = ChannelWriter(spec, metrics_label=f"datafeed:{shard}")
        try:
            refs = self._coord.get_shard_blocks(shard, epoch)
            # Keep one fetch in flight ahead of the write cursor: the
            # object-plane pull overlaps the previous block's ring write.
            futures = [(r, r.future()) for r in refs[:1]]
            for i, ref in enumerate(refs):
                if i + 1 < len(refs):
                    nxt = refs[i + 1]
                    futures.append((nxt, nxt.future()))
                _, fut = futures.pop(0)
                writer.write(fut.result())
            writer.write(_EOF)
        except (ChannelClosed, OSError):
            pass  # lint: swallow-ok(consumer detached mid-epoch; its reader close is authoritative)
        finally:
            try:
                writer.close()
            except Exception:  # lint: swallow-ok(idempotent teardown)
                pass


@dataclass
class ChannelFeed:
    """Picklable handle to one shard of a channel-delivered split; ships
    to the consuming actor (trainer worker / serve replica), which calls
    `iterator()` there."""

    feeder: Any
    shard: int
    capacity: int = _FEED_CAPACITY

    def iterator(self) -> "ChannelDataIterator":
        return ChannelDataIterator(self)


class ChannelDataIterator(DataIterator):
    """DataIterator over a channel feed: blocks arrive by value through
    the ring (no consumer-side object-store pulls), with a reader thread
    keeping a small prefetch queue ahead of rebatching. Each
    `iter_batches` call is one epoch (matching DataIterator semantics)."""

    def __init__(self, feed: ChannelFeed, prefetch_blocks: int = 4):
        super().__init__(self._blocks_this_epoch)
        self._feed = feed
        self._prefetch = max(1, prefetch_blocks)
        self._epoch = 0
        self._epoch_lock = threading.Lock()

    # DataIterator.iter_batches pulls refs then api.get's them; blocks here
    # arrive by VALUE, so override the block iteration instead.
    def _iter_blocks(self) -> Iterator[Any]:
        import queue as _q

        with self._epoch_lock:
            epoch = self._epoch
            self._epoch += 1
        tmpdir = tempfile.mkdtemp(prefix="rtpu-datafeed-")
        reader = ChannelReader(tmpdir, capacity=self._feed.capacity)
        ok = api.get(
            self._feed.feeder.attach.remote(self._feed.shard, epoch, reader.spec())
        )
        if not ok:  # pragma: no cover - attach is fire-and-forget today
            reader.close()
            raise RuntimeError("data feed attach refused")
        buf: "_q.Queue" = _q.Queue(maxsize=self._prefetch)
        done = object()

        def pump():
            try:
                while True:
                    item = reader.read()
                    if isinstance(item, str) and item == _EOF:
                        buf.put(done)
                        return
                    buf.put(item)
            except (ChannelClosed, OSError) as e:
                buf.put(e)

        t = threading.Thread(target=pump, name="datafeed-read", daemon=True)
        t.start()
        try:
            while True:
                item = buf.get()
                if item is done:
                    return
                if isinstance(item, BaseException):
                    from ..exceptions import ActorDiedError

                    raise ActorDiedError(
                        reason="data feeder died (feed channel closed)"
                    ) from item
                yield item
        finally:
            reader.close()

    def _blocks_this_epoch(self):  # pragma: no cover - refs never used
        raise RuntimeError("ChannelDataIterator streams blocks, not refs")

    def iter_batches(self, **kwargs) -> Iterator[Any]:
        from .iterator import rebatch_blocks

        kwargs.pop("prefetch_batches", None)
        yield from rebatch_blocks(self._iter_blocks(), **_batch_kwargs(kwargs))


def _batch_kwargs(kwargs: dict) -> dict:
    return dict(
        batch_size=kwargs.pop("batch_size", 256),
        batch_format=kwargs.pop("batch_format", "numpy"),
        drop_last=kwargs.pop("drop_last", False),
        shuffle_buffer_size=kwargs.pop("local_shuffle_buffer_size", None),
        shuffle_seed=kwargs.pop("local_shuffle_seed", None),
    )


def make_channel_feeds(
    dataset, n: int, *, equal: bool = True, capacity: int = _FEED_CAPACITY
) -> List[ChannelFeed]:
    """One BlockFeeder actor + n ChannelFeed handles for `dataset`."""
    from ..core import serialization

    feeder_cls = api.remote(max_concurrency=max(2, 2 * n))(BlockFeeder)
    feeder = feeder_cls.remote(serialization.dumps(dataset), n, equal)
    return [ChannelFeed(feeder=feeder, shard=i, capacity=capacity) for i in range(n)]
