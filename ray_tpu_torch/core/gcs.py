"""GCS: the cluster control plane (the port of ray_tpu/core/gcs.py, trimmed
to what one machine's cluster of tasks, actors, objects and a process-
isolated trainer needs).

Re-design of the reference's GCS server (reference:
src/ray/gcs/gcs_server/gcs_server.h:80; node manager gcs_node_manager.h:45;
actor registry + restart FT gcs_actor_manager.h:308/:548; actor placement
gcs_actor_scheduler.h:111; placement groups gcs_placement_group_manager.h:230;
internal KV gcs_kv_manager.h; object directory
ownership_based_object_directory.h, centralized here).

Runs as its own process serving RPC over a UDS. Like the reference, the GCS
is not on the task fast path: drivers talk to raylets for tasks and objects;
the GCS holds membership, actors, placement groups, the object directory,
task states, the KV and the resource view used for spillback decisions.

Kept from the JAX copy: the node table and heartbeats, resources and
`pick_node`, the actor table (create, started, died, get, named, list),
object locations with frees and borrows and `node_sync`, task states, the
KV, placement groups (PACK, SPREAD, STRICT_PACK, STRICT_SPREAD), the
general-purpose pubsub log, preemption notices and the DRAINING node state
(`report_preemption`; `node_draining` / `node_dead` / `node_added` on the
`node_events` channel, read by utils/node_events.py), ping and stop.
Left out: the snapshot/WAL persistence and GCS restart, epoch fencing and
`node_fenced` (ROADMAP Queue 1 item 3.9), the `node_table` delta channel,
metrics history and alerts, incidents, `debug_harvest`, flight dumps, and
the TPU slice strategy SLICE_GANG. This module never imports torch.
"""

from __future__ import annotations

import collections
import logging
import os
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Set, Tuple

from . import heartbeat as _hb
from ..exceptions import ActorNameTakenError, PlacementGroupError, SchedulingError
from ..utils import config
from ..utils import internal_metrics as imet

_log = logging.getLogger("ray_tpu_torch.gcs")

TASK_TABLE_CAP = 50_000
FREED_CAP = 200_000


def _is_hard_affinity(strategy: str) -> bool:
    from .placement_group import decode_node_affinity

    aff = decode_node_affinity(strategy)
    return aff is not None and not aff[1]


class GcsService:
    def __init__(self):
        # One lock over every table. The JAX copy splits nodes, actors and
        # objects into key-hashed shards (gcs_shards.py); no trace of this
        # runtime has shown the lock contended, so the port keeps one.
        self._lock = threading.RLock()
        self._nodes: Dict[str, dict] = {}
        self._node_epochs: Dict[str, int] = {}
        self._alive_count = 0
        self._actors: Dict[str, dict] = {}
        self._objects: Dict[str, Set[str]] = {}
        self._freed: "collections.OrderedDict[str, bool]" = collections.OrderedDict()
        self._borrows: Dict[str, int] = {}
        self._deferred_free: Set[str] = set()
        self._named: Dict[Tuple[str, str], str] = {}
        self._kv: Dict[str, bytes] = {}
        self._pgs: Dict[str, dict] = {}
        self._tasks: "collections.OrderedDict[str, dict]" = collections.OrderedDict()
        self._removed_pgs: "collections.OrderedDict[str, bool]" = collections.OrderedDict()
        self._pg_creating: Set[str] = set()
        self._actor_restarting: Set[str] = set()
        self._stranded_sweep_inflight = False
        self._free_queue: List[Tuple[float, List[str]]] = []
        self._raylet_clients: Dict[str, Any] = {}
        self._spread_rr = -1
        self._overflow_rr = -1
        # Demand forecasts by source, {source: (launches expected, expiry)}:
        # each heartbeat reply hands a node its share as `pool_hint`, so its
        # warm pool is sized before the launches arrive; each actor
        # registration consumes one unit.
        self._demand_forecast: Dict[str, Tuple[int, float]] = {}
        # The pubsub log: channel -> [(seq, message)], a bounded ring per
        # channel; subscribers long-poll with their cursor.
        self._pubsub: Dict[str, List[Tuple[int, Any]]] = {}
        self._pubsub_cv = threading.Condition()
        self._stop = threading.Event()
        self._health = threading.Thread(target=self._health_loop, daemon=True, name="health")
        self._health.start()

    def _nodes_view_for(self, nids) -> Dict[str, dict]:
        """Resolves node ids to {sock, store, alive}."""
        out: Dict[str, dict] = {}
        with self._lock:
            for nid in set(nids):
                n = self._nodes.get(nid)
                if n is not None:
                    out[nid] = {"sock": n["sock"], "store": n["store"], "alive": n["alive"]}
        return out

    def _node_sock(self, node_id: str, alive_only: bool = True) -> Optional[str]:
        with self._lock:
            n = self._nodes.get(node_id)
            if n is None or (alive_only and not n["alive"]):
                return None
            return n["sock"]

    # -------------------------------------------------------------- nodes
    def register_node(self, node_id: str, sock_path: str, store_path: str,
                      resources: dict) -> dict:
        with self._lock:
            epoch = self._node_epochs.get(node_id, 0) + 1
            self._node_epochs[node_id] = epoch
            prev = self._nodes.get(node_id)
            if prev is None or not prev["alive"]:
                self._alive_count += 1
            self._nodes[node_id] = {
                "sock": sock_path,
                "store": store_path,
                "resources": dict(resources),
                "available": dict(resources),
                "alive": True,
                "epoch": epoch,
                "last_hb": time.monotonic(),
            }
            nodes = self._alive_count
        self._kick_stranded_restarts()
        # Capacity waiters (TorchTrainer's renegotiation) block on
        # node_events: a join is as much a lifecycle event as a drain.
        self.pubsub_publish("node_events", {"event": "node_added", "node_id": node_id,
                                            "epoch": epoch, "ts": time.time()})
        return {"ok": True, "nodes": nodes, "epoch": epoch}

    def heartbeat(self, node_id: str, available: Optional[dict] = None,
                  stats: Optional[dict] = None) -> dict:
        """The 1 Hz fan-in. Payloads are deltas (core/heartbeat.py)."""
        alive = self._alive_count
        raylet_drained = False
        with self._lock:
            n = self._nodes.get(node_id)
            if n is None or not n["alive"]:
                return {"ok": False, "nodes": alive}
            if stats:
                _hb.apply_heartbeat(n, available, dict(stats))
                if (n.get("stats") or {}).get("draining") and not n.get("draining"):
                    raylet_drained = True
            elif available is not None:
                n["available"] = dict(available)
            n["last_hb"] = time.monotonic()
            now = n["last_hb"]
            expected = sum(k for k, exp in self._demand_forecast.values() if k > 0 and now < exp)
        pool_hint = -(-expected // alive) if expected > 0 and alive > 0 else 0
        if raylet_drained:
            # A drain the raylet started (an operator's `drain` RPC) is
            # adopted through the same path as a notice the GCS received.
            self.report_preemption(node_id, 0.0, "raylet-initiated drain")
        return {"ok": True, "nodes": alive, "pool_hint": pool_hint}

    def report_demand_forecast(self, n: int, ttl_s: float = 15.0,
                               source: str = "autoscaler") -> bool:
        """Launches `source` expects soon, cluster-wide. A report replaces
        that source's previous one, and it expires after `ttl_s`, so a
        reporter that died leaves no pool pinned high."""
        with self._lock:
            self._demand_forecast[str(source)] = (max(0, int(n)),
                                                  time.monotonic() + max(0.0, float(ttl_s)))
        return True

    def _consume_forecast(self, n: int) -> None:
        """Registered launches are no longer expected: they draw the
        forecasts down, sources in sorted order."""
        with self._lock:
            for src in sorted(self._demand_forecast):
                if n <= 0:
                    break
                k, exp = self._demand_forecast[src]
                take = min(k, n)
                self._demand_forecast[src] = (k - take, exp)
                n -= take

    # ---------------------------------------------------- preemption/drain
    def report_preemption(self, node_id: str, deadline_s: float = 30.0,
                          reason: str = "preempted") -> bool:
        """A preemption notice for `node_id` (from a cloud's metadata server,
        an operator, or a test). The node enters the DRAINING state: it stays
        alive and keeps running in-flight work, but new placement avoids it,
        its raylet spills default-placement work and worker leases, and
        `node_draining` is published once on `node_events`, so gang
        supervisors (the trainer, the Serve controller) checkpoint or replace
        before the machine dies at the deadline."""
        with self._lock:
            n = self._nodes.get(node_id)
            if n is None:
                return False
            already = bool(n.get("draining"))
            n["draining"] = True
            n["drain_reason"] = reason
            n["drain_deadline"] = time.time() + max(0.0, deadline_s)
            sock = n["sock"] if n["alive"] else None
        if already:
            return True
        imet.NODES_DRAINED.inc()
        _log.warning("node %s draining (%s; deadline %.1f s)", node_id[:12], reason, deadline_s)
        self.pubsub_publish("node_events", {"event": "node_draining", "node_id": node_id,
                                            "deadline_s": deadline_s, "reason": reason,
                                            "ts": time.time()})
        # Best effort: on a real preemption the machine may already be
        # unreachable; the notice above is what subscribers rely on.
        if sock:
            try:
                self._raylet_call(sock, "drain", deadline_s)
            except Exception as e:  # noqa: BLE001 - the node may already be gone
                _log.debug("drain RPC to %s failed: %r", sock, e)
        return True

    @staticmethod
    def _node_state(n: dict) -> str:
        """ALIVE -> DRAINING (a preemption notice) -> DEAD; a rejoin
        registers anew."""
        if n["alive"]:
            return "DRAINING" if n.get("draining") else "ALIVE"
        return "DEAD"

    @classmethod
    def _node_entry(cls, nid: str, n: dict) -> dict:
        return {
            "NodeID": nid, "Alive": n["alive"], "Resources": dict(n["resources"]),
            "Available": dict(n["available"]), "Stats": dict(n.get("stats") or {}),
            "Draining": bool(n.get("draining")),
            "DrainReason": n.get("drain_reason"),
            "DrainDeadline": n.get("drain_deadline"),
            "Epoch": n.get("epoch"),
            "State": cls._node_state(n),
            "sock": n["sock"], "store": n["store"],
        }

    def list_nodes(self) -> List[dict]:
        out: List[dict] = []
        with self._lock:
            out.extend(self._node_entry(nid, n) for nid, n in self._nodes.items())
        return out

    def node_table_snapshot(self) -> dict:
        """The resync point of a node_events subscriber whose cursor fell
        behind the pubsub ring: every node's membership state (the JAX
        copy's slim rows; the port has no `node_table` channel, so `seq` is
        that channel's, always 0)."""
        with self._lock:
            nodes = [{"NodeID": nid, "Alive": bool(n["alive"]),
                      "Draining": bool(n.get("draining")), "Epoch": n.get("epoch"),
                      "State": self._node_state(n)} for nid, n in self._nodes.items()]
        return {"seq": 0, "nodes": nodes}

    def node_info(self, node_id: str) -> Optional[dict]:
        with self._lock:
            n = self._nodes.get(node_id)
            return dict(n) if n else None

    def _resource_sum(self, key: str) -> Dict[str, float]:
        out: Dict[str, float] = {}
        with self._lock:
            for n in self._nodes.values():
                if n["alive"]:
                    for k, v in n[key].items():
                        out[k] = out.get(k, 0.0) + v
        return out

    def cluster_resources(self) -> Dict[str, float]:
        return self._resource_sum("resources")

    def available_resources(self) -> Dict[str, float]:
        return self._resource_sum("available")

    def pick_node(self, resources: dict, exclude: Optional[List[str]] = None,
                  mode: str = "pack") -> Optional[dict]:
        """Best-fit node for a resource request (the cluster-level half of the
        two-level scheduler; reference: cluster_resource_scheduler.h:44 and
        the spread policy). "pack" picks the most-utilized feasible node,
        "spread" round-robins over feasible nodes."""
        exclude = set(exclude or [])
        feasible: List[dict] = []
        with self._lock:
            for nid, n in self._nodes.items():
                if nid in exclude or not n["alive"] or n.get("draining"):
                    # A draining node is leaving: work placed there would
                    # be lost at the preemption deadline.
                    continue
                avail = n["available"]
                if all(avail.get(k, 0.0) >= v for k, v in resources.items()):
                    used = 1.0 - sum(avail.values()) / (sum(n["resources"].values()) or 1.0)
                    feasible.append({"node_id": nid, "sock": n["sock"],
                                     "store": n["store"], "_used": used})
        if not feasible:
            return None
        feasible.sort(key=lambda e: e["node_id"])  # a stable order for the round robin
        if mode == "spread":
            with self._lock:
                self._spread_rr += 1
                chosen = feasible[self._spread_rr % len(feasible)]
        else:
            chosen = max(feasible, key=lambda e: e["_used"])
        return {k: v for k, v in chosen.items() if k != "_used"}

    def _health_loop(self):
        tick = 0
        while not self._stop.wait(0.1):
            self._process_frees()
            tick += 1
            if tick % 20 == 0:
                self._kick_stranded_restarts()
            dead = []
            now = time.monotonic()
            with self._lock:
                for nid, n in self._nodes.items():
                    if n["alive"] and now - n["last_hb"] > config.HEARTBEAT_TIMEOUT_S:
                        n["alive"] = False
                        self._alive_count -= 1
                        dead.append(nid)
            for nid in dead:
                self._on_node_death(nid)

    def mark_node_dead(self, node_id: str) -> bool:
        """A node known to be gone (its raylet was killed by the cluster that
        started it): declared dead now instead of after the heartbeat timeout."""
        with self._lock:
            n = self._nodes.get(node_id)
            if n is None or not n["alive"]:
                return False
            n["alive"] = False
            self._alive_count -= 1
        self._on_node_death(node_id)
        return True

    def _on_node_death(self, node_id: str) -> None:
        """Node failure: objects there leave the directory, its queued and
        running tasks fail, its actors restart elsewhere or die (reference:
        gcs_node_manager death handling -> gcs_actor_manager restart :548)."""
        _log.warning("node %s declared dead", node_id[:12])
        # Death is a node event too: supervisors subscribed for drain
        # notices learn of a failure without one from the same stream.
        self.pubsub_publish("node_events", {"event": "node_dead", "node_id": node_id,
                                            "ts": time.time()})
        dead_sock = self._node_sock(node_id, alive_only=False)
        with self._lock:
            cli = self._raylet_clients.pop(dead_sock, None) if dead_sock else None
            for rec in self._tasks.values():
                if rec.get("node") == node_id and rec["state"] in ("QUEUED", "RUNNING"):
                    rec["state"] = "FAILED"
                    rec["reason"] = "node_died"
                    rec["ts"] = time.time()
        if cli is not None:
            cli.close()
        restart: List[str] = []
        with self._lock:
            for locs in self._objects.values():
                locs.discard(node_id)
            for aid, a in self._actors.items():
                if a.get("node_id") == node_id and a["state"] in (
                        "ALIVE", "PENDING", "RESTARTING"):
                    a["state"] = "RESTARTING" if self._can_restart(a) else "DEAD"
                    a["node_id"] = None
                    if a["state"] == "DEAD":
                        a["death_reason"] = f"node {node_id[:8]} died"
                        self._drop_name(aid, a)
                    else:
                        restart.append(aid)
        if restart:
            threading.Thread(target=lambda: [self._restart_actor(a) for a in restart],
                             daemon=True).start()

    # ------------------------------------------------------------- actors
    @staticmethod
    def _can_restart(a: dict) -> bool:
        mr = a.get("max_restarts", 0)
        return mr == -1 or a.get("num_restarts", 0) < mr

    def _drop_name(self, actor_id: str, a: dict) -> None:
        """Releases a dead actor's name claim (caller holds self._lock)."""
        key = (a.get("namespace") or "default", a.get("name") or "")
        if a.get("name") and self._named.get(key) == actor_id:
            del self._named[key]

    def _restart_actor(self, actor_id: str) -> None:
        """Re-places and re-creates one RESTARTING actor. No capacity now:
        it stays RESTARTING and is retried when a node registers and on the
        health loop's cadence."""
        with self._lock:
            if actor_id in self._actor_restarting:
                return
            a = self._actors.get(actor_id)
            if a is None or a["state"] != "RESTARTING" or a.get("node_id"):
                return
            resources = dict(a["resources"])
            pg_id, bundle_index = a.get("pg_id"), a.get("bundle_index", -1)
            strategy = a.get("strategy", "DEFAULT")
            self._actor_restarting.add(actor_id)
        try:
            node = (self.pick_bundle(pg_id, bundle_index) if pg_id
                    else self._place_with_strategy(resources, strategy))
            if node is None:
                with self._lock:
                    pg_gone = bool(pg_id) and pg_id not in self._pgs
                reason = None
                if pg_gone:
                    reason = (f"placement group {pg_id[:8]} removed; bundle-pinned restart "
                              "impossible")
                elif not pg_id and _is_hard_affinity(strategy):
                    reason = "hard NodeAffinity target unavailable for restart"
                if reason is not None:
                    with self._lock:
                        a = self._actors.get(actor_id)
                        if a is not None and a["state"] == "RESTARTING" and not a.get("node_id"):
                            a["state"] = "DEAD"
                            a["death_reason"] = reason
                            self._drop_name(actor_id, a)
                return
            with self._lock:
                a = self._actors.get(actor_id)
                if a is None or a["state"] != "RESTARTING" or a.get("node_id"):
                    return
                a["node_id"] = node["node_id"]
                spec_blob = a["spec_blob"]
            try:
                self._raylet_call(node["sock"], "create_actor", spec_blob,
                                  node.get("bundle_index", -1))
            except Exception as e:  # noqa: BLE001 - retried on the health loop's cadence
                _log.warning("restart of actor %s on %s failed (%r); will retry",
                             actor_id[:8], node["node_id"][:8], e)
                with self._lock:
                    a = self._actors.get(actor_id)
                    if a is not None and a["state"] == "RESTARTING":
                        a["node_id"] = None
                return
            with self._lock:
                a = self._actors.get(actor_id)
                if a is not None:
                    a["num_restarts"] += 1
        finally:
            with self._lock:
                self._actor_restarting.discard(actor_id)

    def _kick_stranded_restarts(self) -> None:
        """One off-thread sweep over RESTARTING actors without a node, only
        when there is one."""
        with self._lock:
            if self._stranded_sweep_inflight:
                return
            if not any(a["state"] == "RESTARTING" and not a.get("node_id")
                       for a in self._actors.values()):
                return
            self._stranded_sweep_inflight = True

        def sweep():
            try:
                with self._lock:
                    ids = [aid for aid, a in self._actors.items()
                           if a["state"] == "RESTARTING" and not a.get("node_id")]
                for aid in ids:
                    self._restart_actor(aid)
            finally:
                with self._lock:
                    self._stranded_sweep_inflight = False

        threading.Thread(target=sweep, daemon=True).start()

    def _place_with_strategy(self, resources: dict, strategy: str) -> Optional[dict]:
        """Strategy-aware node choice shared by first placement and restart.
        NodeAffinity picks by total capacity (the raylet queues until
        resources free)."""
        from .placement_group import decode_node_affinity

        aff = decode_node_affinity(strategy)
        if aff is not None:
            target_id, soft = aff
            with self._lock:
                n = self._nodes.get(target_id)
                if n is not None and n["alive"] and all(
                        n["resources"].get(k, 0.0) >= v for k, v in resources.items()):
                    return {"node_id": target_id, "sock": n["sock"], "store": n["store"]}
            return self.pick_node(resources) if soft else None
        return self.pick_node(resources, mode="spread" if strategy == "SPREAD" else "pack")

    def _claim_name(self, actor_id: str, name: Optional[str],
                    namespace: Optional[str]) -> Optional[Tuple[str, str]]:
        key = (namespace or "default", name) if name else None
        if key is not None:
            with self._lock:
                if key in self._named:
                    raise ActorNameTakenError(f"actor name {name!r} already taken")
                self._named[key] = actor_id
        return key

    def _place_actor(self, resources: dict, pg_id: Optional[str], bundle_index: int,
                     strategy: str) -> dict:
        """Placement for one actor: bundle pin, strategy placement, or any node
        whose total capacity fits (the raylet queues the creation)."""
        if pg_id:
            node = self.pick_bundle(pg_id, bundle_index)
            if node is None:
                raise PlacementGroupError(
                    f"placement group {pg_id[:8]} bundle {bundle_index} not available")
            return node
        node = self._place_with_strategy(resources, strategy)
        if node is None and not _is_hard_affinity(strategy):
            feasible = []
            with self._lock:
                feasible.extend(
                    {"node_id": nid, "sock": n["sock"], "store": n["store"]}
                    for nid, n in self._nodes.items()
                    if n["alive"] and not n.get("draining")
                    and all(n["resources"].get(k, 0.0) >= v for k, v in resources.items()))
            if feasible:
                feasible.sort(key=lambda f: f["node_id"])
                with self._lock:
                    self._overflow_rr += 1
                    node = feasible[self._overflow_rr % len(feasible)]
        if node is None:
            if _is_hard_affinity(strategy):
                raise SchedulingError(
                    f"hard NodeAffinity to {strategy.split(':')[1][:12]} cannot be "
                    f"satisfied for actor requiring {resources}")
            raise SchedulingError(f"no node can EVER host actor requiring {resources}")
        return node

    def create_actors(self, specs: List[dict]) -> List[dict]:
        """Batched register + place + forward: one driver RPC registers a
        burst of actors, and the GCS forwards the creations grouped per
        target raylet. Per-spec failures come back as the exception object
        in that spec's slot."""
        results: List[Optional[dict]] = [None] * len(specs)
        placed = []
        for i, s in enumerate(specs):
            key = None
            try:
                key = self._claim_name(s["actor_id"], s.get("name"), s.get("namespace"))
                node = self._place_actor(s.get("resources") or {}, s.get("pg_id"),
                                         s.get("bundle_index", -1), s.get("strategy", "DEFAULT"))
            except Exception as e:  # noqa: BLE001 - returned in this spec's slot
                if key is not None:
                    with self._lock:
                        if self._named.get(key) == s["actor_id"]:
                            del self._named[key]
                results[i] = {"error": e}
                continue
            placed.append((i, s, node))
        self._consume_forecast(len(placed))
        for i, s, node in placed:
            rec = {
                "state": "PENDING",
                "node_id": node["node_id"],
                "spec_blob": s["spec_blob"],
                "resources": dict(s.get("resources") or {}),
                "max_restarts": s.get("max_restarts", 0),
                "num_restarts": 0,
                "pg_id": s.get("pg_id"),
                "bundle_index": node.get("bundle_index", -1) if s.get("pg_id") else -1,
                "strategy": s.get("strategy", "DEFAULT"),
                "name": s.get("name"),
                "namespace": s.get("namespace") or "default",
                "death_reason": "",
            }
            with self._lock:
                self._actors[s["actor_id"]] = rec
        by_sock: Dict[str, List[Tuple[int, bytes, int]]] = {}
        for i, s, node in placed:
            bi = node.get("bundle_index", -1)
            results[i] = {"node_id": node["node_id"], "sock": node["sock"], "bundle_index": bi}
            by_sock.setdefault(node["sock"], []).append((i, s["spec_blob"], bi))
        for sock, items in by_sock.items():
            try:
                self._raylet_call(sock, "create_actor_batch", [(b, bi) for _, b, bi in items])
            except Exception as e:  # noqa: BLE001 - the creations fail visibly
                _log.warning("create_actor_batch forward to %s failed: %r", sock, e)
                for i, _, _ in items:
                    aid = specs[i]["actor_id"]
                    with self._lock:
                        a = self._actors.get(aid)
                        if a is not None and a["state"] == "PENDING":
                            a["state"] = "DEAD"
                            a["death_reason"] = f"creation forward failed: {e!r}"
                            a["node_id"] = None
                            self._drop_name(aid, a)
                    results[i] = {"error": e}
        return results

    def actor_started_batch(self, node_id: str, actor_ids: List[str]) -> Dict[str, bool]:
        """Coalesced actor_started reports from one raylet. False tells the
        raylet its instance is a duplicate (the record moved) to kill."""
        out: Dict[str, bool] = {}
        with self._lock:
            for aid in actor_ids:
                a = self._actors.get(aid)
                if a and (a["state"] == "DEAD" or a.get("node_id") not in (None, node_id)):
                    out[aid] = False
                    continue
                if a:
                    a["state"] = "ALIVE"
                    a["node_id"] = node_id
                out[aid] = True
        return out

    def actor_died(self, actor_id: str, reason: str, no_restart: bool = False,
                   node_id: Optional[str] = None) -> dict:
        """Returns {restart: bool}; on True the GCS re-places and re-creates
        the actor itself, off-thread (reference: design_docs/actor_states.rst)."""
        with self._lock:
            a = self._actors.get(actor_id)
            if a is None:
                return {"restart": False}
            if node_id is not None and a.get("node_id") not in (None, node_id):
                return {"restart": False}
            if no_restart or not self._can_restart(a):
                a["state"] = "DEAD"
                a["death_reason"] = reason
                a["node_id"] = None
                self._drop_name(actor_id, a)
                return {"restart": False}
            a["state"] = "RESTARTING"
            a["node_id"] = None
        self._kick_stranded_restarts()
        return {"restart": True}

    def get_actor(self, actor_id: str) -> Optional[dict]:
        with self._lock:
            a = self._actors.get(actor_id)
            if a is None:
                return None
            out = {k: v for k, v in a.items() if k != "spec_blob"}
        out["sock"] = self._node_sock(out["node_id"], alive_only=False) if out["node_id"] else None
        return out

    def lookup_named_actor(self, name: str, namespace: Optional[str]) -> Optional[str]:
        with self._lock:
            return self._named.get((namespace or "default", name))

    def list_actors(self, limit: int = 1000) -> List[dict]:
        """The actor table's summary (reference: the state API's
        list_actors); supervisors map actors to nodes with it."""
        with self._lock:
            out = [{"actor_id": aid, "state": a["state"], "node_id": a.get("node_id"),
                    "name": a.get("name"), "namespace": a.get("namespace"),
                    "num_restarts": a.get("num_restarts", 0),
                    "max_restarts": a.get("max_restarts", 0), "pg_id": a.get("pg_id"),
                    "death_reason": a.get("death_reason", "")}
                   for aid, a in self._actors.items()]
        return out[-limit:]

    # ------------------------------------------------------------ objects
    def remove_object_location(self, oid_hex: str, node_id: str) -> bool:
        """A node dropped its copy (replica eviction)."""
        with self._lock:
            locs = self._objects.get(oid_hex)
            if locs is not None:
                locs.discard(node_id)
                if not locs:
                    del self._objects[oid_hex]
        return True

    def get_object_locations(self, oid_hex: str) -> List[dict]:
        with self._lock:
            locs = list(self._objects.get(oid_hex, ()))
        view = self._nodes_view_for(locs)
        return [{"node_id": nid, "sock": view[nid]["sock"], "store": view[nid]["store"]}
                for nid in locs if nid in view and view[nid]["alive"]]

    def get_object_locations_batch(self, oid_hexes: List[str]) -> Dict[str, List[dict]]:
        """One round trip for a raylet's whole wait set."""
        found: Dict[str, List[str]] = {}
        with self._lock:
            for h in oid_hexes:
                if self._objects.get(h):
                    found[h] = list(self._objects[h])
        view = self._nodes_view_for({nid for locs in found.values() for nid in locs})
        return {h: [{"node_id": nid, "sock": view[nid]["sock"]}
                    for nid in locs if nid in view and view[nid]["alive"]]
                for h, locs in found.items()}

    def free_objects(self, oid_hexes: List[str]) -> bool:
        """The owner dropped its last reference. The free runs after a short
        grace (on the health loop) so in-flight borrow registrations land
        first, and waits further while a borrower holds the ref (reference:
        reference_count.h:64 owner release + the borrower protocol)."""
        with self._lock:
            self._free_queue.append((time.monotonic(), list(oid_hexes)))
        return True

    def flush_frees(self) -> bool:
        """Prompt free processing for a raylet under pool pressure."""
        self._process_frees(grace=0.05)
        return True

    def _process_frees(self, grace: float = 0.1) -> None:
        now = time.monotonic()
        with self._lock:
            ready = [b for ts, b in self._free_queue if now - ts >= grace]
            self._free_queue = [e for e in self._free_queue if now - e[0] < grace]
        if not ready:
            return
        freed: List[Tuple[str, List[str]]] = []
        with self._lock:
            for h in (h for b in ready for h in b):
                if self._borrows.get(h, 0) > 0:
                    self._deferred_free.add(h)
                else:
                    self._release_locked(h, freed)
        self._delete_on_nodes(freed)

    def _release_locked(self, h: str, freed: List[Tuple[str, List[str]]]) -> None:
        self._freed[h] = True
        while len(self._freed) > FREED_CAP:
            self._freed.popitem(last=False)
        locs = self._objects.pop(h, None)
        if locs:
            freed.append((h, list(locs)))

    def _delete_on_nodes(self, freed: List[Tuple[str, List[str]]]) -> None:
        if not freed:
            return
        view = self._nodes_view_for({nid for _, locs in freed for nid in locs})
        by_sock: Dict[str, List[str]] = {}
        for h, locs in freed:
            for nid in locs:
                v = view.get(nid)
                if v is not None and v["alive"]:
                    by_sock.setdefault(v["sock"], []).append(h)
        for sock, hs in by_sock.items():
            try:
                self._raylet_call(sock, "delete_objects", hs)
            except Exception:  # noqa: BLE001 - a node going away frees its pool anyway
                pass

    def update_borrows(self, deltas: Dict[str, int]) -> bool:
        """Batched borrow-count adjustments from non-owner processes."""
        freed: List[Tuple[str, List[str]]] = []
        with self._lock:
            for h in deltas:
                c = self._borrows.get(h, 0) + deltas[h]
                if c > 0:
                    self._borrows[h] = c
                    continue
                self._borrows.pop(h, None)
                if h in self._deferred_free:
                    self._deferred_free.discard(h)
                    self._release_locked(h, freed)
        self._delete_on_nodes(freed)
        return True

    def node_sync(self, node_id: str, sealed: List[str], events: List[dict]) -> bool:
        """Batched raylet -> GCS sync: object locations and task state events
        (reference: task_event_buffer.h batching + object directory adds).
        A location for an object already freed is deleted on its node."""
        stale: List[str] = []
        with self._lock:
            for h in sealed:
                if h in self._freed:
                    stale.append(h)
                else:
                    self._objects.setdefault(h, set()).add(node_id)
        with self._lock:
            for evt in events:
                tid = evt["task_id"]
                rec = self._tasks.get(tid)
                if rec is None:
                    rec = self._tasks[tid] = {"task_id": tid, "state": "QUEUED", "name": "",
                                              "ts": 0.0}
                    while len(self._tasks) > TASK_TABLE_CAP:
                        self._tasks.popitem(last=False)
                if evt["state"] == "QUEUED" or rec["state"] not in ("FINISHED", "FAILED"):
                    rec["state"] = evt["state"]
                    rec["node"] = node_id
                    rec["ts"] = evt.get("ts", time.time())
                    for k in ("name", "reason"):
                        if evt.get(k):
                            rec[k] = evt[k]
        if stale:
            self._delete_on_nodes([(h, [node_id]) for h in stale])
        return True

    def get_task_states(self, task_ids: List[str]) -> Dict[str, dict]:
        with self._lock:
            return {tid: dict(self._tasks[tid]) for tid in task_ids if tid in self._tasks}

    # ----------------------------------------------------------------- KV
    def kv_put(self, key: str, value: bytes) -> bool:
        with self._lock:
            self._kv[key] = value
        return True

    def kv_get(self, key: str) -> Optional[bytes]:
        with self._lock:
            return self._kv.get(key)

    def kv_del(self, key: str) -> bool:
        with self._lock:
            return self._kv.pop(key, None) is not None

    def kv_keys(self, prefix: str = "") -> List[str]:
        with self._lock:
            return [k for k in self._kv if k.startswith(prefix)]

    # --------------------------------------------------- placement groups
    def _plan_bundles(self, bundles: List[dict], strategy: str, banned: Set[str]) -> List[str]:
        """Placement planning against the current resource view (reference:
        bundle_scheduling_policy.h PACK/SPREAD/STRICT_PACK/STRICT_SPREAD)."""
        if strategy == "SLICE_GANG":
            raise PlacementGroupError(
                "SLICE_GANG places bundles on the hosts of one TPU slice; "
                "the port's nodes carry GPUs")
        avail: Dict[str, dict] = {}
        with self._lock:
            avail.update((nid, dict(n["available"])) for nid, n in self._nodes.items()
                         if n["alive"] and nid not in banned and not n.get("draining"))
        order = sorted(avail, key=lambda nid: -sum(avail[nid].values()))

        def fits(nid, b):
            return all(avail[nid].get(k, 0.0) >= v for k, v in b.items())

        placements: List[str] = []
        for i, bundle in enumerate(bundles):
            chosen = None
            if strategy in ("PACK", "STRICT_PACK"):
                pool = placements[:1] if (strategy == "STRICT_PACK" and placements) else order
                chosen = next((nid for nid in pool if fits(nid, bundle)), None)
                if chosen is None and strategy == "PACK":
                    chosen = next((nid for nid in order if fits(nid, bundle)), None)
            elif strategy in ("SPREAD", "STRICT_SPREAD"):
                used = set(placements)
                candidates = [n for n in order if n not in used] or (
                    order if strategy == "SPREAD" else [])
                chosen = next((nid for nid in candidates if fits(nid, bundle)), None)
            if chosen is None:
                raise PlacementGroupError(
                    f"cannot place bundle {i} ({bundle}) with strategy {strategy}")
            for k, v in bundle.items():
                avail[chosen][k] = avail[chosen].get(k, 0.0) - v
            placements.append(chosen)
        return placements

    def _release_bundles(self, pg_id: str, reserved: List[Tuple[str, int]]) -> None:
        for nid, i in reserved:
            sock = self._node_sock(nid, alive_only=False)
            if sock:
                try:
                    self._raylet_call(sock, "release_bundle", pg_id, i)
                except Exception:  # noqa: BLE001 - bundle release on a gone node
                    pass

    def create_placement_group(self, pg_id: str, bundles: List[dict], strategy: str) -> dict:
        """Plans placements, then leases each bundle on its raylet, which
        debits its own free pool, so the reservation is durable across
        heartbeats (reference: gcs_placement_group_scheduler.h:283 two-phase
        PREPARE/COMMIT). All-or-nothing: a refused lease rolls back."""
        with self._lock:
            if pg_id in self._removed_pgs:
                raise PlacementGroupError(f"placement group {pg_id[:8]} was removed")
        banned: Set[str] = set()
        last_err: Optional[str] = None
        for _ in range(4):  # replanning rounds for stale-view refusals
            placements = self._plan_bundles(bundles, strategy, banned)
            reserved: List[Tuple[str, int]] = []
            failed = None
            for i, (nid, bundle) in enumerate(zip(placements, bundles)):
                sock = self._node_sock(nid)
                ok = False
                if sock is not None:
                    try:
                        ok = self._raylet_call(sock, "reserve_bundle", pg_id, i, bundle)
                    except Exception:  # noqa: BLE001 - counts as a refusal
                        ok = False
                if not ok:
                    failed = nid
                    break
                reserved.append((nid, i))
            if failed is None:
                for nid in set(placements):  # refresh the view: the debit is real now
                    sock = self._node_sock(nid)
                    if sock:
                        try:
                            _, avail = self._raylet_call(sock, "node_resources")
                        except Exception:  # noqa: BLE001 - the next heartbeat refreshes it
                            continue
                        with self._lock:
                            if nid in self._nodes:
                                self._nodes[nid]["available"] = dict(avail)
                with self._lock:
                    removed = pg_id in self._removed_pgs
                    if not removed:
                        self._pgs[pg_id] = {"bundles": bundles, "strategy": strategy,
                                            "placements": placements, "state": "CREATED",
                                            "rr": 0}
                if removed:
                    self._release_bundles(pg_id, reserved)
                    raise PlacementGroupError(f"placement group {pg_id[:8]} was removed")
                return {"placements": placements}
            self._release_bundles(pg_id, reserved)
            banned.add(failed)
            last_err = f"node {failed[:8]} refused bundle lease"
        raise PlacementGroupError(f"placement group {pg_id[:8]} creation failed: {last_err}")

    def _raylet_call(self, sock: str, method: str, *args):
        """Cached per-raylet client for control-plane calls."""
        from .rpc import RpcClient

        with self._lock:
            cli = self._raylet_clients.get(sock)
        if cli is None:
            fresh = RpcClient(sock, connect_timeout=5.0)
            with self._lock:
                cli = self._raylet_clients.setdefault(sock, fresh)
            if cli is not fresh:
                fresh.close()
        return cli.call(method, *args)

    def remove_placement_group(self, pg_id: str) -> bool:
        with self._lock:
            pg = self._pgs.pop(pg_id, None)
            self._removed_pgs[pg_id] = True
            while len(self._removed_pgs) > 10_000:
                self._removed_pgs.popitem(last=False)
        if pg:
            for i, (nid, bundle) in enumerate(zip(pg["placements"], pg["bundles"])):
                with self._lock:
                    n = self._nodes.get(nid)
                    sock = n["sock"] if n and n["alive"] else None
                    if n:
                        for k, v in bundle.items():
                            n["available"][k] = min(n["resources"].get(k, 0.0),
                                                    n["available"].get(k, 0.0) + v)
                if sock:
                    try:
                        self._raylet_call(sock, "release_bundle", pg_id, i)
                    except Exception:  # noqa: BLE001 - bundle release on a gone node
                        pass
        return True

    def pick_bundle(self, pg_id: str, bundle_index: int) -> Optional[dict]:
        """Resolves a (pg, bundle) to its host node; bundle_index -1
        round-robins across the group."""
        with self._lock:
            pg = self._pgs.get(pg_id)
            if pg is None or pg.get("state") != "CREATED":
                return None
            if bundle_index < 0:
                bundle_index = pg["rr"] % len(pg["placements"])
                pg["rr"] += 1
            if bundle_index >= len(pg["placements"]):
                return None
            nid = pg["placements"][bundle_index]
        with self._lock:
            n = self._nodes.get(nid)
            if n is None or not n["alive"]:
                return None
            return {"node_id": nid, "sock": n["sock"], "store": n["store"],
                    "bundle_index": bundle_index}

    def register_pending_placement_group(self, pg_id: str, bundles: List[dict],
                                         strategy: str) -> bool:
        """Records a group the cluster cannot place yet (reference: the
        PENDING state of gcs_placement_group_manager.h:230)."""
        with self._lock:
            if pg_id in self._removed_pgs or pg_id in self._pgs:
                return False
            self._pgs[pg_id] = {"bundles": bundles, "strategy": strategy, "placements": [],
                                "state": "PENDING", "rr": 0}
        return True

    def retry_pending_placement_group(self, pg_id: str) -> Optional[dict]:
        """One placement attempt for a PENDING group (ready() pollers drive
        it: new capacity may have arrived)."""
        with self._lock:
            pg = self._pgs.get(pg_id)
            if pg is None:
                return None
            if pg.get("state") == "CREATED":
                return {"placements": pg["placements"]}
            if pg.get("state") != "PENDING" or pg_id in self._pg_creating:
                return None
            self._pg_creating.add(pg_id)
            bundles, strategy = pg["bundles"], pg["strategy"]
            del self._pgs[pg_id]  # create_placement_group re-registers on success
        try:
            return self.create_placement_group(pg_id, bundles, strategy)
        except RuntimeError:
            with self._lock:
                if pg_id not in self._removed_pgs and pg_id not in self._pgs:
                    self._pgs[pg_id] = {"bundles": bundles, "strategy": strategy,
                                        "placements": [], "state": "PENDING", "rr": 0}
            return None
        finally:
            with self._lock:
                self._pg_creating.discard(pg_id)

    def placement_group_table(self) -> Dict[str, dict]:
        with self._lock:
            return {k: dict(v) for k, v in self._pgs.items()}

    def get_placement_group(self, pg_id: str) -> Optional[dict]:
        with self._lock:
            pg = self._pgs.get(pg_id)
            return dict(pg) if pg else None

    # ------------------------------------------------------------- pubsub
    # General-purpose channels (reference: src/ray/pubsub/publisher.h, the
    # long-poll publisher): a bounded sequence log per channel; a
    # subscriber is a cursor that long-polls for entries after it.
    _PUBSUB_RETAIN = 1024

    def pubsub_publish(self, channel: str, message: Any) -> int:
        with self._pubsub_cv:
            log = self._pubsub.setdefault(channel, [])
            seq = (log[-1][0] + 1) if log else 1
            log.append((seq, message))
            del log[:-self._PUBSUB_RETAIN]
            self._pubsub_cv.notify_all()
        return seq

    def pubsub_poll(self, channel: str, after_seq: int = 0,
                    timeout: float = 10.0) -> List[Tuple[int, Any]]:
        """Entries with seq > after_seq; blocks up to `timeout` while there
        are none."""
        deadline = time.monotonic() + max(0.0, timeout)
        with self._pubsub_cv:
            while True:
                out = [(q, m) for q, m in self._pubsub.get(channel, []) if q > after_seq]
                remaining = deadline - time.monotonic()
                if out or remaining <= 0:
                    return out
                self._pubsub_cv.wait(timeout=min(remaining, 1.0))

    def pubsub_poll2(self, channel: str, after_seq: int = 0, timeout: float = 10.0) -> dict:
        """Gap-aware poll: {"entries": [(seq, msg), ...], "gap": bool}. A gap
        means the cursor fell behind the ring (entries after it were
        trimmed): the subscriber resyncs from a snapshot. A gap returns at
        once."""
        deadline = time.monotonic() + max(0.0, timeout)
        with self._pubsub_cv:
            while True:
                log = self._pubsub.get(channel, [])
                if after_seq > 0 and log and log[0][0] > after_seq + 1:
                    return {"entries": [], "gap": True}
                out = [(q, m) for q, m in log if q > after_seq]
                remaining = deadline - time.monotonic()
                if out or remaining <= 0:
                    return {"entries": out, "gap": False}
                self._pubsub_cv.wait(timeout=min(remaining, 1.0))

    # ---------------------------------------------------------- lifecycle
    def ping(self) -> str:
        return "pong"

    def stop(self) -> bool:
        self._stop.set()
        return True


def exit_with_parent(stop: threading.Event) -> None:
    """Sets `stop` when the process that started this one exits: a daemon
    whose driver was killed must not outlive it (a SIGKILLed driver runs no
    shutdown)."""
    parent = os.getppid()

    def watch():
        while not stop.wait(0.5):
            if os.getppid() != parent:
                stop.set()

    threading.Thread(target=watch, daemon=True, name="parent-watch").start()


def main(sock_path: str, tcp_address: Optional[str] = None) -> None:
    """GCS daemon: serves the cluster's control plane on `sock_path`, and on
    `tcp_address` too for a cluster other hosts join (its bound address is
    printed as GCS_TCP_ADDRESS=... for the head to read)."""
    from .rpc import RpcServer

    logging.basicConfig(level=logging.INFO, format="%(asctime)s gcs %(levelname)s %(message)s")
    _log.info("gcs started (pid %d)", os.getpid())
    service = GcsService()
    servers = [RpcServer(sock_path, service)]
    if tcp_address:
        servers.append(RpcServer(tcp_address, service))
        print(f"GCS_TCP_ADDRESS={servers[-1].address}", flush=True)
    exit_with_parent(service._stop)
    try:
        while not service._stop.wait(0.5):
            pass
    finally:
        for server in servers:
            server.shutdown()


if __name__ == "__main__":
    main(*sys.argv[1:3])
