"""Sharded hot-state layer for the GCS control plane (the port of
ray_tpu/core/gcs_shards.py; this module never imports torch).

The reference architecture's known single-point bottleneck is the GCS
(PAPER.md layer map, L1): every registration, heartbeat, actor-table
mutation, and object-directory update used to serialize on ONE state
lock and ONE write-ahead log. This module is the partitioning layer that
splits the hot tables (nodes, node epochs, actors, the object directory
and its borrow/free companions) into N key-hashed shards, each with:

- its own tracked lock (`gcs.shardNN` — the lock-order detector sees a
  consistent `gcs.state -> gcs.shardNN` acquisition order, and shard
  locks are only ever nested in ascending index),
- its own WAL segment (`<snapshot>.wal.sNN`): a mutation's delta is
  appended under the owning shard's lock, so two shards' appends never
  contend on one file handle, and a batch routed to one shard group-
  commits with a single write+flush,
- an O(1) alive-node counter, so the heartbeat path stops paying an
  O(cluster) scan per beat.

Key routing is `crc32(key) % count` — deterministic across processes
(unlike builtin str hashing), so tests can construct keys that land on
chosen shards and a replay can verify segment-local ordering. Replay
itself routes records by TABLE KEY, not by which segment held them: all
`<snapshot>.wal*` files are replayed over the snapshot, which keeps an
old single-file `.wal` from a pre-sharding boot (or a boot with a
different shard count) fully recoverable. Per-key write ordering is
preserved because a key's deltas always land in one segment within a
process lifetime, and the GCS snapshots (and truncates every segment)
immediately after boot-time replay, closing the cross-segment window a
shard-count change could otherwise open.

Shard count: `RAY_TPU_GCS_SHARDS` (CONFIG.gcs_shards, default 8).
`RAY_TPU_GCS_SHARDS=1` degenerates to the pre-sharding design — one
lock, one segment.
"""

from __future__ import annotations

import collections
import copy
import logging
import os
import pickle
import zlib
from typing import Any, Dict, Iterator, List, Optional, Set, Tuple

from ..utils import lock_order
from ..utils.config import CONFIG

_log = logging.getLogger("ray_tpu_torch.gcs")

MAX_SHARDS = 64

# Tables partitioned by key hash; everything else (names, PGs, KV,
# tasks) stays on the control lock + the meta WAL segment.
SHARDED_WAL_TABLES = ("_nodes", "_node_epochs", "_actors")


def resolve_shard_count(explicit: Optional[int] = None) -> int:
    """Shard count for a GcsService instance: explicit argument (tests,
    the scale simulator) > environment (daemons read their spawn env) >
    CONFIG default. Clamped to [1, MAX_SHARDS]."""
    n: Optional[int] = None
    if explicit is not None:
        n = int(explicit)
    else:
        raw = os.environ.get("RAY_TPU_GCS_SHARDS")
        if raw is not None:
            try:
                n = int(raw)
            except ValueError:
                n = None
        if n is None:
            n = int(CONFIG.gcs_shards)
    return max(1, min(MAX_SHARDS, n))


def shard_index(key: str, count: int) -> int:
    """Deterministic key -> shard routing (stable across processes and
    restarts, unlike PYTHONHASHSEED-randomized builtin hashing)."""
    if count <= 1:
        return 0
    return zlib.crc32(key.encode("utf-8", "surrogatepass")) % count


def encode_wal_record(table: str, key: Any, value: Any) -> bytes:
    """One length-prefixed WAL record. `copy.copy` detaches the logged
    value from the live record the caller keeps mutating."""
    rec = pickle.dumps((table, key, copy.copy(value)))
    return len(rec).to_bytes(4, "little") + rec


def iter_wal_records(data: bytes) -> Iterator[Tuple[str, Any, Any]]:
    """Decodes a WAL segment, tolerating a torn tail write (crash mid-
    append): the partial record and anything after it are dropped."""
    pos = 0
    while pos + 4 <= len(data):
        n = int.from_bytes(data[pos:pos + 4], "little")
        pos += 4
        if pos + n > len(data):
            return  # torn tail write: ignore
        try:
            table, key, value = pickle.loads(data[pos:pos + n])
        except Exception:  # noqa: BLE001 - a corrupt tail: what came before is applied
            return
        pos += n
        yield table, key, value


class GcsShard:
    """One partition of the GCS hot state: its tables, its lock, its WAL
    segment. All table access MUST hold `self.lock`; the GcsService's
    control lock (`gcs.state`) may be held while acquiring a shard lock,
    never the reverse, and multiple shard locks nest in ascending index
    only — the lock-order detector enforces the discipline at test time."""

    def __init__(self, index: int):
        self.index = index
        self.lock = lock_order.tracked_rlock(f"gcs.shard{index:02d}")
        self.nodes: Dict[str, dict] = {}
        self.node_epochs: Dict[str, int] = {}
        self.actors: Dict[str, dict] = {}
        self.objects: Dict[str, Set[str]] = {}
        self.freed: "collections.OrderedDict[str, bool]" = collections.OrderedDict()
        self.borrows: Dict[str, int] = {}
        self.deferred_free: Set[str] = set()
        # O(1) alive-node count, maintained at every alive-flag flip so
        # the 1 Hz * N-node heartbeat fan-in never scans the table.
        self.alive_count = 0
        self.wal_path: Optional[str] = None
        self._wal_f = None
        self._wal_warned = False

    # ------------------------------------------------------------- WAL
    def wal_open(self, path: str) -> None:
        self.wal_path = path
        self._wal_f = open(path, "ab")

    def wal_close(self) -> None:
        if self._wal_f is not None:
            try:
                self._wal_f.close()
            except OSError:
                pass
            self._wal_f = None

    def wal_append(self, table: str, key: Any, value: Any) -> None:
        """One delta, appended + flushed under this shard's lock."""
        self.wal_append_many(((table, key, value),))

    def wal_append_many(self, records) -> None:
        """Group commit: a batch routed to this shard lands as ONE
        write+flush — the per-record flush syscall is amortized across
        the batch, which is where a registration/creation storm's WAL
        cost goes from O(records) to O(shards touched)."""
        if self._wal_f is None:
            return
        try:
            buf = b"".join(encode_wal_record(t, k, v) for t, k, v in records)
            self._wal_f.write(buf)
            self._wal_f.flush()
        except Exception as e:
            # Durability is best-effort between snapshots, but a WAL that
            # stopped persisting (disk full, unpicklable value) must be
            # visible once — silently running without it turns the next
            # GCS restart into state loss.
            if not self._wal_warned:
                self._wal_warned = True
                _log.warning(
                    "WAL append failed on shard %d; durability degraded "
                    "to snapshots: %r", self.index, e,
                )

    def wal_covered(self) -> int:
        """Current end offset (post-flush): how much of this segment the
        in-progress snapshot covers. Call under the shard lock."""
        if self._wal_f is None:
            return 0
        try:
            self._wal_f.flush()
            return self._wal_f.tell()
        except Exception:
            return 0

    def wal_rotate(self, covered: int) -> None:
        """Drops the `covered` prefix (now durably in the snapshot),
        keeping deltas appended after the snapshot's copy. Call under the
        shard lock, only AFTER the snapshot is durably on disk."""
        if self._wal_f is None or not covered or not self.wal_path:
            return
        try:
            self._wal_f.flush()
            with open(self.wal_path, "rb") as rf:
                rf.seek(covered)
                suffix = rf.read()
            self._wal_f.close()
            with open(self.wal_path, "wb") as wf:
                wf.write(suffix)
            self._wal_f = open(self.wal_path, "ab")
        except Exception:
            try:  # never leave the WAL handle closed
                self._wal_f = open(self.wal_path, "ab")
            except Exception:
                self._wal_f = None

    # ----------------------------------------------------------- state
    def recount_alive(self) -> None:
        self.alive_count = sum(1 for n in self.nodes.values() if n.get("alive"))


def make_shards(count: int) -> List[GcsShard]:
    return [GcsShard(i) for i in range(count)]


def wal_segment_path(snapshot_path: str, index: int) -> str:
    return f"{snapshot_path}.wal.s{index:02d}"


def discover_wal_paths(snapshot_path: str) -> List[str]:
    """Every WAL file belonging to `snapshot_path`, oldest naming scheme
    first: the legacy single `.wal` (pre-sharding boots), then the shard
    segments in index order. Replay routes records by key, so segments
    written under a DIFFERENT shard count still land correctly."""
    out = []
    legacy = snapshot_path + ".wal"
    if os.path.exists(legacy):
        out.append(legacy)
    base = os.path.basename(snapshot_path) + ".wal.s"
    d = os.path.dirname(snapshot_path) or "."
    try:
        segs = sorted(
            f for f in os.listdir(d) if f.startswith(base)
        )
    except OSError:
        segs = []
    out.extend(os.path.join(d, f) for f in segs)
    return out
