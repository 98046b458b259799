"""Channel-fed online feature ingest for serve replicas (the port of
ray_tpu/serve/ingest.py).

The serve-side consumer of the streaming data plane's last-mile delivery
(data/feed.py): a data pipeline computes feature transforms
(`ds.map_batches(featurize)`), `streaming_split(k).to_channel()` hands one
ChannelFeed per replica, and each replica hosts a `FeatureTable` — a
background ingest thread pulling transformed batches off the channel ring
into a bounded, request-time lookup table. Requests never touch the object
store or pay a transform: the freshest features for a key are one dict
lookup away, and the table re-ingests epoch after epoch so a re-executed
pipeline (new feature snapshot) rolls through automatically.

Backpressure composes end to end: a replica busy serving requests drains
its ring slowly, the feeder's writes block on the full ring, and the
stall propagates through the shard iterator into the streaming executor's
source — an overloaded replica throttles feature computation instead of
being buried by it.
"""

from __future__ import annotations

import collections
import threading
from typing import Any, Dict, Optional

_EPOCH_PAUSE_S = 0.05  # between epochs: yields the lock, avoids a hot spin


class FeatureTable:
    """Replica-side live feature table over one ChannelFeed shard.

    Construct it in a deployment's ``__init__`` with the ChannelFeed
    passed through ``.bind(...)``; serve ships the handle to every
    replica. ``lookup(key)`` serves the newest ingested row for that key;
    eviction is LRU-by-insertion once ``max_rows`` is exceeded.
    """

    def __init__(
        self,
        feed: Any,
        key: str = "id",
        max_rows: int = 100_000,
        batch_size: int = 256,
        continuous: bool = True,
    ):
        self._feed = feed
        self._key = key
        self._max_rows = max(1, int(max_rows))
        self._batch_size = batch_size
        self._continuous = continuous
        self._rows: "collections.OrderedDict[Any, Dict[str, Any]]" = (
            collections.OrderedDict()
        )
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self.epochs_ingested = 0
        self.rows_ingested = 0
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(
            target=self._pump, name="feature-ingest", daemon=True
        )
        self._thread.start()

    # ------------------------------------------------------------- requests
    def lookup(self, key: Any) -> Optional[Dict[str, Any]]:
        """The newest feature row ingested for `key`, or None."""
        with self._lock:
            row = self._rows.get(key)
            return dict(row) if row is not None else None

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            n = len(self._rows)
        return {
            "rows": n,
            "rows_ingested": self.rows_ingested,
            "epochs_ingested": self.epochs_ingested,
            "error": repr(self._error) if self._error else None,
        }

    def wait_for_epoch(self, timeout: float = 30.0) -> bool:
        """Blocks until at least one full epoch has been ingested (warm-up
        gate for deployments that must not serve empty features)."""
        import time

        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self.epochs_ingested > 0 or self._error is not None:
                return self.epochs_ingested > 0
            time.sleep(0.01)
        return False

    def close(self) -> None:
        self._stop.set()

    # --------------------------------------------------------------- ingest
    def _pump(self) -> None:
        it = self._feed.iterator()
        while not self._stop.is_set():
            try:
                for batch in it.iter_batches(
                    batch_size=self._batch_size, batch_format="numpy"
                ):
                    self._ingest(batch)
                    if self._stop.is_set():
                        return
            except BaseException as e:  # noqa: BLE001 - thread boundary
                # Feeder death / channel teardown ends ingest; the table
                # keeps serving its last snapshot and surfaces the cause
                # via stats() rather than killing the replica.
                self._error = e
                return
            self.epochs_ingested += 1
            if not self._continuous:
                return
            self._stop.wait(_EPOCH_PAUSE_S)

    def _ingest(self, batch: Dict[str, Any]) -> None:
        keys = batch.get(self._key)
        if keys is None:
            raise KeyError(
                f"feature batch has no key column {self._key!r} "
                f"(columns: {sorted(batch)})"
            )
        cols = list(batch)
        with self._lock:
            for i, k in enumerate(keys):
                k = k.item() if hasattr(k, "item") else k
                row = {c: batch[c][i] for c in cols}
                self._rows[k] = row
                self._rows.move_to_end(k)
                self.rows_ingested += 1
            while len(self._rows) > self._max_rows:
                self._rows.popitem(last=False)
