"""Node lifecycle event subscription: the drain/death feed supervisors react
to (a copy of ray_tpu/utils/node_events.py for the PyTorch port).

The GCS (core/gcs.py) publishes to the general-purpose ``node_events``
pubsub channel:

- ``{"event": "node_draining", "node_id", "deadline_s", "reason"}`` when a
  preemption notice arrives (``report_preemption``: relayed from a cloud
  API, an operator, or a test),
- ``{"event": "node_dead", "node_id"}`` when a node is declared dead
  (heartbeat expiry, or `Cluster.remove_node`),
- ``{"event": "node_fenced", "node_id", "epoch"}`` when a dead-marked
  node's calls resumed (a healed partition) and were rejected with
  StaleNodeEpochError: supervisors treat it as death (the node already left
  the membership; the fence only makes the zombie stop),
- ``{"event": "node_added", "node_id", "epoch"}`` when a node registers
  (a first join, or a fenced incarnation rejoining fresh).

`NodeEventWatcher` is the subscriber side: a daemon thread long-polls the
channel and maintains the cumulative ``draining`` / ``dead`` node-id sets.
Gang supervisors (the JaxTrainer driver, the serve controller) poll those
sets between rounds — cheap, no callback reentrancy, and a missed poll
only delays a reaction, never loses it. The poll thread takes only its own
lock: no runtime lock (the reference counts' lock above all) is ever taken
on it.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Set

CHANNEL = "node_events"


class NodeEventWatcher:
    def __init__(self, gcs, poll_timeout_s: float = 1.0):
        self._gcs = gcs
        self._poll_timeout_s = poll_timeout_s
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._event_count = 0
        self._seq = 0
        self.draining: Set[str] = set()
        self.dead: Set[str] = set()
        self.added: Set[str] = set()
        self.fenced: Set[str] = set()
        # Grows only: nodes that EVER received a drain notice. `draining`
        # reflects current state (a dead node leaves it); supervisors
        # distinguishing "noticed preemption" from "un-noticed crash"
        # need the cumulative view — the node may drain and die between
        # two of their polls.
        self.ever_draining: Set[str] = set()
        self.resyncs = 0  # times the cursor fell behind the retention ring
        self._events: List[Dict[str, Any]] = []
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="node-events"
        )
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                reply = self._gcs.call(
                    "pubsub_poll2", CHANNEL, self._seq, self._poll_timeout_s,
                    timeout=self._poll_timeout_s + 10.0,
                )
            except Exception:
                if self._stop.wait(0.5):
                    return
                continue
            entries = reply.get("entries") or []
            if reply.get("gap"):
                # Events between the cursor and the ring's head are GONE
                # (a stalled subscriber at high event rate): rebuild the
                # current state sets from the node-table snapshot, then
                # apply whatever the ring still retains normally.
                entries = self._resync() + entries
            with self._lock:
                for seq, msg in entries:
                    self._seq = max(self._seq, seq)
                    if not isinstance(msg, dict):
                        continue
                    self._events.append(msg)
                    del self._events[:-256]
                    nid = msg.get("node_id")
                    if not nid:
                        continue
                    if msg.get("event") == "node_draining":
                        self.draining.add(nid)
                        self.ever_draining.add(nid)
                    elif msg.get("event") == "node_dead":
                        self.dead.add(nid)
                        # A dead node is no longer "draining" — it's gone.
                        self.draining.discard(nid)
                    elif msg.get("event") == "node_fenced":
                        # Death, to a supervisor (the membership was lost
                        # at node_dead; this is the zombie put down), kept
                        # apart for post-mortems.
                        self.fenced.add(nid)
                        self.dead.add(nid)
                        self.draining.discard(nid)
                    elif msg.get("event") == "node_added":
                        self.added.add(nid)
                        self.dead.discard(nid)
                if entries:
                    self._event_count += len(entries)
                    self._cond.notify_all()

    def _resync(self) -> List:
        """Snapshot-then-deltas recovery: missed TRANSITIONS cannot be
        replayed, but dead/draining are STATE and the node-table snapshot
        is authoritative for state — rebuild the sets from it, return the
        ring's retained tail for normal processing. Best-effort: a failed
        resync just retries on the next gap verdict."""
        try:
            snap = self._gcs.call("node_table_snapshot")
            retained = self._gcs.call("pubsub_poll", CHANNEL, self._seq, 0.0)
        except Exception:
            return []
        with self._lock:
            self.resyncs += 1
            for row in snap.get("nodes") or []:
                nid = row.get("NodeID")
                if not nid:
                    continue
                self.added.add(nid)
                if not row.get("Alive"):
                    self.dead.add(nid)
                    self.draining.discard(nid)
                elif row.get("Draining"):
                    self.draining.add(nid)
                    self.ever_draining.add(nid)
                else:
                    self.dead.discard(nid)
        return retained

    def affected(self, node_ids) -> Set[str]:
        """The subset of `node_ids` that is draining or dead."""
        with self._lock:
            lost = self.draining | self.dead
        return {n for n in node_ids if n in lost}

    def drain_noticed(self, node_ids) -> Set[str]:
        """The subset of `node_ids` that ever received a preemption
        notice. Distinct from affected(): an un-noticed crash (node_dead
        with no prior node_draining) is a FAILURE, not a preemption, and
        must not be granted the gentler preemption retry budget."""
        with self._lock:
            return {n for n in node_ids if n in self.ever_draining}

    def draining_nodes(self) -> Set[str]:
        """Locked snapshot of the draining set (the poll thread mutates
        it concurrently — callers must not iterate the live set)."""
        with self._lock:
            return set(self.draining)

    def wait_for_event(self, timeout_s: float) -> bool:
        """Blocks until ANY node event lands (or timeout) — the
        event-driven half of a capacity wait: wake on node_added/
        node_draining/node_dead, re-check the predicate, repeat. Returns
        True when an event arrived inside the window."""
        with self._cond:
            before = self._event_count
            self._cond.wait(timeout_s)
            return self._event_count != before

    def events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._events)

    def stop(self) -> None:
        self._stop.set()


def actor_locations(gcs) -> Dict[str, str]:
    """actor_id(hex) -> node_id for every actor the GCS knows — the
    resolution gang supervisors (trainer, serve controller) use to map a
    drain notice to their own members. Empty on any GCS error: a
    supervisor that cannot resolve locations simply reacts a tick later."""
    try:
        return {
            a["actor_id"]: a.get("node_id")
            for a in gcs.call("list_actors", 100_000)
        }
    except Exception:
        return {}
