"""General-purpose pub/sub channels over the GCS (the port of
ray_tpu/utils/pubsub.py).

Re-design of the reference's pubsub layer (reference:
src/ray/pubsub/publisher.h long-poll publisher, subscriber.h; protocol
src/ray/protobuf/pubsub.proto:232 SubscriberService): named channels,
at-least-once delivery from a bounded retained log, long-poll consumers.

    from ray_tpu_torch.utils import pubsub

    sub = pubsub.subscribe("alerts")          # any process in the cluster
    pubsub.publish("alerts", {"sev": "info"}) # any other process
    msgs = sub.poll(timeout=5.0)              # [{"sev": "info"}]

A subscriber is a cursor: nothing is registered, so nothing is left in the
GCS when it goes away. A subscriber that falls more than the retention ring
(`GcsService._PUBSUB_RETAIN` entries per channel) behind misses messages:
there is no unbounded queue. `poll_deltas` says when that happened.
These calls touch no device.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Set, Tuple


def _gcs():
    from ..core.runtime_base import current_runtime

    gcs = getattr(current_runtime(), "_gcs", None)
    if gcs is None:
        raise RuntimeError("pubsub needs the cluster runtime (GCS-backed)")
    return gcs


def publish(channel: str, message: Any) -> int:
    """Publishes to a channel; returns the message's sequence number."""
    return _gcs().call("pubsub_publish", channel, message)


class Subscription:
    """Cursor over one channel; poll() long-polls for new messages."""

    def __init__(self, channel: str, from_seq: int = 0):
        self.channel = channel
        self._cursor = from_seq
        self._gcs_client = _gcs()

    def poll(self, timeout: float = 10.0, max_messages: Optional[int] = None) -> List[Any]:
        """Messages after the cursor (waiting up to `timeout` for the first);
        the cursor moves past the ones returned."""
        entries = self._gcs_client.call("pubsub_poll", self.channel, self._cursor, timeout,
                                        timeout=timeout + 10.0)
        if max_messages is not None:
            entries = entries[:max_messages]
        if entries:
            self._cursor = entries[-1][0]
        return [m for _, m in entries]

    def poll_deltas(self, timeout: float = 10.0) -> Tuple[List[Tuple[int, Any]], bool]:
        """Gap-aware poll (GCS `pubsub_poll2`): `(entries, gap)` with entries
        as (seq, message) pairs. `gap=True` means the cursor fell behind the
        retention ring and messages were lost: the caller resyncs from an
        authoritative snapshot (as NodeTableMirror does)."""
        reply = self._gcs_client.call("pubsub_poll2", self.channel, self._cursor, timeout,
                                      timeout=timeout + 10.0)
        entries = reply.get("entries") or []
        if entries:
            self._cursor = entries[-1][0]
        return entries, bool(reply.get("gap"))

    @property
    def cursor(self) -> int:
        return self._cursor


class NodeTableMirror:
    """Local mirror of the GCS node table fed by the `node_table` delta
    channel: one slim row per membership or lifecycle change, applied in seq
    order, with a snapshot resync whenever the cursor falls behind the
    retention ring."""

    CHANNEL = "node_table"

    def __init__(self, gcs):
        self._gcs = gcs
        self._seq = 0
        self.nodes: Dict[str, dict] = {}
        self.resyncs = 0
        self._resync()

    def _resync(self) -> None:
        snap = self._gcs.call("node_table_snapshot")
        self.nodes = {row["NodeID"]: row for row in snap.get("nodes") or []}
        self._seq = snap.get("seq", 0)
        self.resyncs += 1

    def poll(self, timeout: float = 1.0) -> int:
        """Applies pending rows (long-polling up to `timeout` for the first);
        resyncs from the snapshot on a gap. Returns the rows applied."""
        reply = self._gcs.call("pubsub_poll2", self.CHANNEL, self._seq, timeout,
                               timeout=timeout + 10.0)
        if reply.get("gap"):
            self._resync()
            return 0
        entries = reply.get("entries") or []
        for seq, row in entries:
            self._seq = max(self._seq, seq)
            if isinstance(row, dict) and row.get("op") == "upsert":
                self.nodes[row["NodeID"]] = row
        return len(entries)

    def alive(self) -> Set[str]:
        return {nid for nid, r in self.nodes.items() if r.get("Alive")}


def subscribe(channel: str, from_beginning: bool = False) -> Subscription:
    """A subscription at the channel's current tail, or at its retained
    beginning with from_beginning=True."""
    sub = Subscription(channel, 0)
    if not from_beginning:
        entries = sub._gcs_client.call("pubsub_poll", channel, 0, 0.0)
        if entries:
            sub._cursor = entries[-1][0]
    return sub
