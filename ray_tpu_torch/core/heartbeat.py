"""Compact heartbeat encoding between raylet and GCS (copy of
ray_tpu/core/heartbeat.py for the PyTorch port).

Before this layer, every 1 Hz heartbeat resent the node's entire
state: the full `available` resource map plus the full stats dict
(labels, slice spec, topology hints, pool/store gauges, wall_ts). At
1000 nodes that is ~1000 full-payload RPCs per second into the GCS for
data that mostly did not change since the previous beat.

The codec turns the steady-state heartbeat into a delta:

- `available` is sent only when it differs from the last acknowledged
  send (None on the wire means "unchanged — keep what you have").
- `stats` carries only the keys whose values changed, plus `wall_ts`
  always (the GCS clock-skew estimator needs a fresh timestamp every
  beat). A full resend sets `stats["full"] = True`, telling the GCS to
  REPLACE its stored stats rather than merge — that flag is how
  deleted keys propagate.

The raylet forces a full beat after (re)registration and after an
epoch-fence rejection: in both cases the GCS's copy of this node's
state is unknown or stale, so delta-merging against it would be wrong.
The GCS-side merge lives in `apply_heartbeat` so the contract has one
implementation and the tests can drive both halves directly.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Optional, Tuple

# Always present in a delta beat: the GCS derives per-node clock offset
# from it, which must never go stale.
ALWAYS_KEYS = ("wall_ts",)


class HeartbeatCodec:
    """Raylet-side encoder. One instance per raylet; not thread-safe on
    its own (the raylet's heartbeat loop is single-threaded)."""

    def __init__(self):
        self._last_available: Optional[Dict[str, float]] = None
        self._last_stats: Optional[Dict[str, Any]] = None
        self._force_full = True

    def force_full(self) -> None:
        """Next beat resends everything — call after (re)registration or
        a fence rejection, when the GCS's view of this node is unknown."""
        self._force_full = True

    def encode(
        self, available: Dict[str, float], stats: Dict[str, Any]
    ) -> Tuple[Optional[Dict[str, float]], Dict[str, Any]]:
        """(available_or_None, stats_payload) for the wire. Snapshots its
        inputs, so callers may keep mutating the dicts they passed."""
        if self._force_full or self._last_stats is None:
            self._force_full = False
            self._last_available = copy.deepcopy(available)
            self._last_stats = copy.deepcopy(stats)
            out_stats = dict(stats)
            out_stats["full"] = True
            return dict(available), out_stats

        if available == self._last_available:
            out_avail: Optional[Dict[str, float]] = None
        else:
            out_avail = dict(available)
            self._last_available = copy.deepcopy(available)

        delta: Dict[str, Any] = {}
        for k, v in stats.items():
            if k in ALWAYS_KEYS or self._last_stats.get(k, _MISSING) != v:
                delta[k] = v
        # Key deletions ride the next full beat; between fulls a vanished
        # key simply stops updating, which every consumer tolerates.
        self._last_stats = copy.deepcopy(stats)
        return out_avail, delta


class _Missing:
    __slots__ = ()

    def __repr__(self):  # pragma: no cover - debug aid
        return "<missing>"


_MISSING = _Missing()


def apply_heartbeat(
    record: Dict[str, Any],
    available: Optional[Dict[str, float]],
    stats: Dict[str, Any],
) -> None:
    """GCS-side merge of one beat into the node record. Caller holds the
    GCS lock. Tolerates pre-codec senders (which always pass a
    full `available` and a plain full stats dict without the flag):
    merging a full dict over an equal stored dict is a no-op."""
    if available is not None:
        record["available"] = available
    if stats.pop("full", False):
        record["stats"] = stats
    else:
        record.setdefault("stats", {}).update(stats)
