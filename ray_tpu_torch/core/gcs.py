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
general-purpose pubsub log with its gap-aware poll and the `node_table`
delta channel, preemption notices and the DRAINING node state
(`report_preemption`; `node_draining` / `node_dead` / `node_added` on the
`node_events` channel, read by utils/node_events.py), the cluster-wide
`stats` (the stores' bytes, objects and spilled objects summed over the
nodes' heartbeats), the state API's tables (`list_tasks` with each task's
transition history, `list_objects`, `node_summary`), the user and internal
metrics tables (`report_metrics`, `report_internal_metrics`), the error
table (`report_error`, published on `error_reports`), each node's labels
(`register_node(labels=)`, list_nodes' `Labels`), the per-method RPC count
and latency (`_observe_rpc`, called by core/rpc.py's server), ping and stop.
Its locks come from utils/lock_order.py (`gcs.state`, `gcs.shardNN`,
`gcs.incidents`).
Membership is epoch-fenced: every registration stamps the node's next
epoch, and the raylet's mutations (heartbeat, node_sync, actor reports,
location removals) carry the epoch they were granted. A node declared dead
whose calls resume (the zombie of a healed partition), or a call with a
stale epoch, gets StaleNodeEpochError and never flips the node back alive:
its raylet kills its workers and registers again as a fresh incarnation
(`node_fenced` on `node_events`).

Hot tables in shards (core/gcs_shards.py). Nodes with their epochs, actors,
and the object directory with its frees, borrows and deferred frees live in
RAY_TPU_GCS_SHARDS (default 8) key-hashed shards, `crc32(key) % count`, each
with its own lock (`gcs.shardNN`), its own log segment and an alive-node
counter, so a heartbeat reads the alive count in O(shards) and touches only
its node's shard. Names, placement groups, the KV, tasks, incidents and the
metrics tables stay under `gcs.state`. Lock order: `gcs.state` may be held
while a shard lock is taken, never the other way round, and shard locks
nest in ascending index only; a join across shards (placement, the
stranded-actor sweep, frees, listings) takes them one at a time, in
ascending order. `register_nodes` admits a batch with one group commit per
shard touched. With RAY_TPU_GCS_SHARDS=1 it is one lock and one segment.

Durability: with a snapshot path, the tables are pickled to it every
GCS_SNAPSHOT_INTERVAL_S (tmp file + os.replace), the sharded ones merged
under their table names, and every mutation between two snapshots is
appended to a write-ahead log beside it: the control tables' to
`<snapshot>.wal`, each shard's to `<snapshot>.wal.sNN`. A GCS restarted on
the same path loads the snapshot and replays every `<snapshot>.wal*` file
over it, routing each record by its table and key under the current shard
count (so a log of a single-file GCS, or of another shard count, recovers
whole), then snapshots and truncates every segment at once. Actors, named
actors, placement groups, the KV and the node epochs survive; raylets keep
beating with their epochs, and one the GCS lost registers again.

Incidents (observability/postmortem.py): the GCS arms the trigger bus in
its own process, and takes remote triggers through `report_trigger`. A
trigger opens an incident, or joins the open one while its last trigger
is within the coalesce window; a fresh incident runs one harvest in a
thread of its own, off the RPC handlers and outside the lock: `flight_dump`
on every alive raylet (each SIGUSR2s its workers), this process's ring, the
raylets' log tails, then a bundle under `<session_dir>/incidents/` with the
manifest's per-pid clock offsets (each node's offset sampled from its
heartbeats' wall clock) and the merged trace. `node.dead` and
`node.fenced` fire from the membership paths; `list_incidents`,
`get_incident` and `debug_harvest` read them.

History and alerts (observability/{history,watchdog}.py): every merge into
the internal-metrics table also lands a cumulative sample in the history
rings (`metrics_history` reads them), the health loop samples each alive
node's heartbeat lag once a second into the same table, and the SLO
watchdog evaluates its rules on a thread of its own (never on an RPC
handler), publishing `slo_alert` firing and cleared events on
`node_events` with a flight dump and a `watchdog.alert` trigger
(`active_alerts` reads the firing ones). An incident's bundle holds the
history of its window as `metrics.json`, and the last goodput and MFU in
its manifest.

SLICE_GANG places every bundle of a group on the hosts of ONE slice (nodes
labelled with one `slice_name`: a GPU host's NVLink domain, or a slice a
provider labelled), smallest fitting slice first, or nowhere. A CREATED gang
with a member on a dead node co-fails: it goes RESCHEDULING, every sibling
bundle is released and the whole gang is placed again on another slice; it
stays RESCHEDULING, retried on each registration and every 2 s, while none
fits. Its state is in the snapshot and the log like every group's, so a
restarted GCS carries a RESCHEDULING gang on. `mark_node_dead` is the
counterpart of the JAX copy's `drain_node`. This module never imports
torch.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import logging
import os
import pickle
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Set, Tuple

from . import gcs_shards as _gsh
from . import heartbeat as _hb
from .gcs_shards import encode_wal_record, iter_wal_records  # noqa: F401 - the codec's old home
from ..chaos.net import ChaosPartitionRpc
from ..exceptions import (ActorNameTakenError, PlacementGroupError, SchedulingError,
                          StaleNodeEpochError)
from ..observability import history as _history
from ..observability import postmortem as _postmortem
from ..observability import watchdog as _watchdog
from ..observability.flight_recorder import record as _flight_record
from ..utils import config
from ..utils import internal_metrics as imet
from ..utils import lock_order

_log = logging.getLogger("ray_tpu_torch.gcs")

TASK_TABLE_CAP = 50_000
FREED_CAP = 200_000  # free tombstones kept, split over the shards (1024 each at least)


def _is_hard_affinity(strategy: str) -> bool:
    from .placement_group import decode_node_affinity

    aff = decode_node_affinity(strategy)
    return aff is not None and not aff[1]


class GcsService(ChaosPartitionRpc):
    # The tables a snapshot holds, the sharded ones merged under these names
    # (the single-lock GCS's format). Object locations, frees and borrows
    # ride the snapshot only (a high-rate data plane, rebuilt by the
    # raylets' syncs); the rest is also written ahead, mutation by mutation.
    _PERSISTED = ("_nodes", "_node_epochs", "_actors", "_named", "_pgs", "_kv",
                  "_objects", "_freed", "_borrows", "_deferred_free")
    _WAL_TABLES = ("_nodes", "_node_epochs", "_actors", "_named", "_pgs", "_kv")
    _CONTROL = ("_named", "_pgs", "_kv")
    # Sharded table -> its attribute on a GcsShard.
    _SHARD_ATTRS = {"_nodes": "nodes", "_node_epochs": "node_epochs", "_actors": "actors",
                    "_objects": "objects", "_freed": "freed", "_borrows": "borrows",
                    "_deferred_free": "deferred_free"}

    def __init__(self, snapshot_path: Optional[str] = None,
                 session_dir: Optional[str] = None, shards: Optional[int] = None):
        # The control lock, over every table that is not in a shard.
        self._lock = lock_order.tracked_rlock("gcs.state")
        self._nshards = _gsh.resolve_shard_count(shards)
        self._shards = _gsh.make_shards(self._nshards)
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
        # registration consumes one unit. Replaced whole on every write, so
        # the heartbeat reads it without the control lock.
        self._demand_forecast: Dict[str, Tuple[int, float]] = {}
        # The pubsub log: channel -> [(seq, message)], a bounded ring per
        # channel; subscribers long-poll with their cursor.
        self._pubsub: Dict[str, List[Tuple[int, Any]]] = {}
        self._pubsub_cv = threading.Condition()
        # Metrics tables, (name, sorted tags) -> aggregate (reference:
        # src/ray/stats/metric.h registry + exporter), and the error ring.
        self._user_metrics: Dict[Tuple, dict] = {}
        self._internal_metrics: Dict[Tuple, dict] = {}
        self._errors: List[dict] = []
        # Per-series time series: each internal-metrics merge also lands a
        # bounded, rolled-up history sample (observability/history.py).
        self._history = (_history.MetricsHistory() if _history.history_enabled()
                         else None)
        self._stop = threading.Event()
        self._session_dir = session_dir or (os.path.dirname(snapshot_path)
                                            if snapshot_path else None)
        # The anomaly trigger bus: incident records (a bounded ring) under
        # their own lock; the open incident takes triggers in its window.
        self._incident_lock = lock_order.tracked_lock("gcs.incidents")
        self._incidents: "collections.OrderedDict[str, dict]" = collections.OrderedDict()
        self._open_incident: Optional[str] = None
        self._snapshot_path = snapshot_path
        self._wal_path = snapshot_path + ".wal" if snapshot_path else None
        self._wal_f = None
        self._wal_warned = False
        if snapshot_path:
            self._load_snapshot()
            self._replay_wal()
            for pg in self._pgs.values():
                # A gang snapshotted mid-replan resumes as RESCHEDULING: only
                # that state is retried.
                if pg.get("state") == "REPLANNING":
                    pg["state"] = "RESCHEDULING"
            self._wal_f = open(self._wal_path, "ab")
            for sh in self._shards:
                sh.wal_open(_gsh.wal_segment_path(snapshot_path, sh.index))
                sh.recount_alive()
            # What was replayed (a single-file log, segments of another shard
            # count) is folded into one snapshot at once and every segment
            # starts empty, so each live segment is of this shard count.
            self._save_snapshot()
        self._health = threading.Thread(target=self._health_loop, daemon=True, name="health")
        self._health.start()
        # The SLO watchdog: rules over the history, alerts onto node_events
        # (observability/watchdog.py). Its poll runs on its own thread.
        self._watchdog = None
        if self._history is not None and _watchdog.watchdog_enabled():
            self._watchdog = _watchdog.Watchdog(
                history=self._history,
                publish=lambda msg: self.pubsub_publish("node_events", msg),
                metrics_fn=self.internal_metrics)
            self._watchdog.start()
        # Anomalies raised in this process (its chaos injections, the
        # watchdog's alerts) publish straight to _trigger.
        _postmortem.arm(self._trigger)

    # ------------------------------------------------------ shard routing
    def _shard_for(self, key: str) -> _gsh.GcsShard:
        """The shard of a node id, an actor id or an object id."""
        return self._shards[_gsh.shard_index(key, self._nshards)]

    def _by_shard(self, keys) -> Dict[int, List[str]]:
        """Groups keys by shard index; callers walk the groups in ascending
        order."""
        out: Dict[int, List[str]] = {}
        for k in keys:
            out.setdefault(_gsh.shard_index(k, self._nshards), []).append(k)
        return out

    @contextlib.contextmanager
    def _locked(self, sh: _gsh.GcsShard):
        """A shard's lock with its wait measured
        (raytpu_gcs_shard_lock_wait_ms). `gcs.state` may be held on entry;
        never take it while a shard lock is held."""
        t0 = time.perf_counter()
        with sh.lock:
            imet.GCS_SHARD_LOCK_WAIT.observe((time.perf_counter() - t0) * 1e3,
                                             shard=str(sh.index))
            yield sh

    def _alive_nodes(self) -> int:
        """The alive count off the shards' counters, without a lock (a torn
        read across counters is at worst one heartbeat stale)."""
        return sum(sh.alive_count for sh in self._shards)

    # -------------------------------------------------------- persistence
    def _load_snapshot(self) -> None:
        """Loads the snapshot, each sharded table's records onto their
        shards (the constructor's, before any other thread)."""
        try:
            with open(self._snapshot_path, "rb") as f:
                data = pickle.load(f)
        except (OSError, EOFError, pickle.UnpicklingError):
            return
        for name in self._CONTROL:
            if name in data:
                setattr(self, name, data[name])
        now = time.monotonic()
        for name, attr in self._SHARD_ATTRS.items():
            merged = data.get(name)
            if merged is None:
                continue
            if isinstance(merged, (set, frozenset)):
                for key in merged:
                    getattr(self._shard_for(key), attr).add(key)
                continue
            for key, value in merged.items():
                if name == "_nodes":
                    # A loaded node gets a fresh heartbeat window; one that
                    # is really gone expires through the health loop.
                    value["last_hb"] = now
                getattr(self._shard_for(key), attr)[key] = value

    def _replay_wal(self) -> None:
        """Applies every log of this snapshot over it: the control segment
        (with the sharded tables' records of a single-file GCS) first, then
        the shard segments, each record routed by its table and key under
        the current shard count. A torn tail is dropped (iter_wal_records).
        Runs in the constructor, before any other thread."""
        for path in _gsh.discover_wal_paths(self._snapshot_path):
            try:
                with open(path, "rb") as f:
                    data = f.read()
            except OSError:
                continue
            for table, key, value in iter_wal_records(data):
                if table not in self._WAL_TABLES:
                    continue
                attr = self._SHARD_ATTRS.get(table)
                d = (getattr(self, table) if attr is None
                     else getattr(self._shard_for(key), attr))
                if value is None:
                    d.pop(key, None)
                else:
                    d[key] = value
                    if table == "_nodes":
                        value["last_hb"] = time.monotonic()

    def _persist_delta(self, table: str, key: Any, value: Any) -> None:
        """Appends one control-table mutation (_named, _pgs, _kv) to the
        control segment (value None deletes). Called with self._lock held,
        as the snapshot's cut of the segment is taken under it: no record
        can fall between the two. A sharded table's mutation goes to its
        shard's segment under that shard's lock (GcsShard.wal_append)."""
        if self._wal_f is None:
            return
        try:
            self._wal_f.write(encode_wal_record(table, key, value))
            self._wal_f.flush()
        except Exception as e:  # noqa: BLE001 - said once; snapshots go on
            if not self._wal_warned:
                self._wal_warned = True
                _log.warning("WAL append failed; durability degraded to snapshots: %r", e)

    def _save_snapshot(self) -> None:
        """Copies the control tables under the control lock and each shard's
        tables under its lock, with each segment's length at that moment;
        pickles and writes the file outside every lock (tmp + os.replace);
        only then drops each segment's covered prefix, so a failed write or
        a crash in between loses nothing."""
        if not self._snapshot_path:
            return
        data: Dict[str, Any] = {}
        with self._lock:
            for name in self._CONTROL:
                data[name] = copy.copy(getattr(self, name))
            covered = 0
            if self._wal_f is not None:
                self._wal_f.flush()
                covered = self._wal_f.tell()
        for name in self._SHARD_ATTRS:
            data[name] = set() if name == "_deferred_free" else {}
        data["_freed"] = collections.OrderedDict()
        shard_covered: List[int] = []
        for sh in self._shards:
            with self._locked(sh):
                for name, attr in self._SHARD_ATTRS.items():
                    part = getattr(sh, attr)
                    if isinstance(part, set):
                        data[name] |= part
                    elif name == "_objects":
                        data[name].update((h, set(locs)) for h, locs in part.items())
                    elif name in ("_nodes", "_actors"):
                        # Deep: a heartbeat rewrites a record's nested dicts
                        # while the pickle (outside the lock) walks them.
                        data[name].update(copy.deepcopy(part))
                    else:
                        data[name].update(part)
                shard_covered.append(sh.wal_covered())
        try:
            blob = pickle.dumps(data)
        except Exception as e:  # noqa: BLE001 - the logs still hold everything
            _log.warning("GCS snapshot failed to pickle: %r", e)
            return
        tmp = self._snapshot_path + ".tmp"
        try:
            with open(tmp, "wb") as f:
                f.write(blob)
            os.replace(tmp, self._snapshot_path)
        except OSError as e:
            _log.warning("GCS snapshot write failed (retried next interval): %r", e)
            return
        if covered:
            with self._lock:
                self._rotate_control_wal(covered)
        for sh, cov in zip(self._shards, shard_covered):
            if cov:
                with self._locked(sh):
                    sh.wal_rotate(cov)

    def _rotate_control_wal(self, covered: int) -> None:
        """Drops the control segment's first `covered` bytes (now in the
        snapshot); self._lock held."""
        if self._wal_f is None:
            return
        try:
            self._wal_f.flush()
            with open(self._wal_path, "rb") as rf:
                rf.seek(covered)
                suffix = rf.read()
            self._wal_f.close()
            with open(self._wal_path, "wb") as wf:
                wf.write(suffix)
            self._wal_f = open(self._wal_path, "ab")
        except OSError as e:
            _log.warning("WAL rotation failed: %r", e)
            try:  # never leave the log closed
                self._wal_f = open(self._wal_path, "ab")
            except OSError:
                self._wal_f = None

    def _nodes_view_for(self, nids) -> Dict[str, dict]:
        """Resolves node ids to {sock, store, alive}, one shard at a time in
        ascending order: the join of object reads and frees."""
        out: Dict[str, dict] = {}
        groups = self._by_shard(set(nids))
        for idx in sorted(groups):
            with self._locked(self._shards[idx]) as sh:
                for nid in groups[idx]:
                    n = sh.nodes.get(nid)
                    if n is not None:
                        out[nid] = {"sock": n["sock"], "store": n["store"],
                                    "alive": n["alive"]}
        return out

    def _node_sock(self, node_id: str, alive_only: bool = True) -> Optional[str]:
        with self._locked(self._shard_for(node_id)) as sh:
            n = sh.nodes.get(node_id)
            if n is None or (alive_only and not n["alive"]):
                return None
            return n["sock"]

    # -------------------------------------------------------------- nodes
    @staticmethod
    def _register_node_locked(sh: _gsh.GcsShard, node_id: str, sock_path: str,
                              store_path: str, resources: dict, labels: Optional[dict],
                              wal_out: List[Tuple[str, Any, Any]]) -> int:
        """Inserts one node record with its next epoch (its shard's lock
        held), collecting the log records into `wal_out` for one group
        commit; returns the epoch."""
        epoch = sh.node_epochs.get(node_id, 0) + 1
        sh.node_epochs[node_id] = epoch
        prev = sh.nodes.get(node_id)
        if prev is None or not prev["alive"]:
            sh.alive_count += 1
        sh.nodes[node_id] = {
            "sock": sock_path,
            "store": store_path,
            "resources": dict(resources),
            "available": dict(resources),
            "labels": dict(labels or {}),
            "alive": True,
            "epoch": epoch,
            "last_hb": time.monotonic(),
        }
        wal_out.append(("_node_epochs", node_id, epoch))
        wal_out.append(("_nodes", node_id, sh.nodes[node_id]))
        return epoch

    def _post_register(self, registered: List[Tuple[str, int]]) -> None:
        """After registrations, outside every lock: the flight records, the
        stranded-actor sweep (new capacity is its retry trigger), and each
        node's `node_added` event and node-table row."""
        for node_id, epoch in registered:
            _flight_record("node.added", (node_id[:12], epoch))
        self._kick_stranded_gangs()
        self._kick_stranded_restarts()
        for node_id, epoch in registered:
            # Capacity waiters (TorchTrainer's renegotiation) block on
            # node_events: a join is as much a lifecycle event as a drain.
            self.pubsub_publish("node_events", {"event": "node_added", "node_id": node_id,
                                                "epoch": epoch, "ts": time.time()})
            self._publish_node_delta(node_id)

    def register_node(self, node_id: str, sock_path: str, store_path: str,
                      resources: dict, labels: Optional[dict] = None) -> dict:
        """Registers a node with its next epoch: a fenced incarnation that
        rejoins gets a new number, and whatever still carries the old one
        stays rejected. `labels` (the node's key/value tags: a provider's
        cloud id, a slice's name and index) ride the record, the snapshot
        and the log, and come back in list_nodes' `Labels`."""
        wal: List[Tuple[str, Any, Any]] = []
        with self._locked(self._shard_for(node_id)) as sh:
            epoch = self._register_node_locked(sh, node_id, sock_path, store_path,
                                               resources, labels, wal)
            sh.wal_append_many(wal)
        nodes = self._alive_nodes()
        self._post_register([(node_id, epoch)])
        return {"ok": True, "nodes": nodes, "epoch": epoch}

    def register_nodes(self, specs: List[dict]) -> List[dict]:
        """Batched registration: one RPC admits a storm of nodes. The batch
        is applied per shard, in ascending shard order, each shard's records
        landing as one group commit (one write and one flush per shard
        touched). Spec keys: node_id, sock, store, resources, labels."""
        epochs: Dict[str, int] = {}
        groups: Dict[int, List[dict]] = {}
        for s in specs:
            groups.setdefault(_gsh.shard_index(s["node_id"], self._nshards), []).append(s)
        for idx in sorted(groups):
            wal: List[Tuple[str, Any, Any]] = []
            with self._locked(self._shards[idx]) as sh:
                for s in groups[idx]:
                    epochs[s["node_id"]] = self._register_node_locked(
                        sh, s["node_id"], s["sock"], s["store"], s.get("resources") or {},
                        s.get("labels"), wal)
                sh.wal_append_many(wal)
        nodes = self._alive_nodes()
        self._post_register([(s["node_id"], epochs[s["node_id"]]) for s in specs])
        return [{"ok": True, "nodes": nodes, "epoch": epochs[s["node_id"]]} for s in specs]

    # ------------------------------------------------------------ fencing
    @staticmethod
    def _mark_fenced_locked(sh: _gsh.GcsShard, node_id: str, n: dict) -> bool:
        """Stamps FENCED on a dead or stale node record (its shard's lock
        held); True on the first fencing of this incarnation."""
        if n.get("fenced"):
            return False
        if n["alive"]:
            sh.alive_count -= 1
        n["alive"] = False  # fencing implies dead: never resurrected in place
        n["fenced"] = True
        n["fenced_ts"] = time.time()
        sh.wal_append("_nodes", node_id, n)
        return True

    def _fence_verdict_locked(self, sh: _gsh.GcsShard, node_id: str, n: dict,
                              epoch: Optional[int]) -> Optional[Tuple[Optional[int], bool]]:
        """Judges one raylet call against the membership record (its shard's
        lock held, so a handler that also mutates the record does both
        under one acquisition). None when the caller is current, else
        (current epoch, newly fenced). Only a dead-marked record is stamped
        FENCED: a stale epoch against an alive record is an old incarnation
        talking after its successor registered, and the successor's record
        stays as it is."""
        cur = n.get("epoch")
        stale = epoch is not None and cur is not None and epoch != cur
        if n["alive"] and not stale:
            return None
        newly = self._mark_fenced_locked(sh, node_id, n) if not n["alive"] else False
        return cur, newly

    def _reject_stale_node(self, node_id: str, epoch: Optional[int], context: str) -> None:
        """The fence: raises StaleNodeEpochError when `node_id` is
        dead-marked or `epoch` is not its current one. A caller that never
        registered (a driver) passes. Judged under the node's shard lock,
        which is released before the caller takes the shard of what it
        mutates: sequential, never nested."""
        with self._locked(self._shard_for(node_id)) as sh:
            n = sh.nodes.get(node_id)
            if n is None:
                return
            verdict = self._fence_verdict_locked(sh, node_id, n, epoch)
        if verdict is not None:
            self._raise_fenced(node_id, epoch, verdict, context)

    def _raise_fenced(self, node_id: str, epoch: Optional[int],
                      verdict: Tuple[Optional[int], bool], context: str) -> None:
        """Outside the lock: on the first fencing of an incarnation counts,
        records and publishes it; raises the typed error every time."""
        cur, newly = verdict
        if newly:
            imet.NODES_FENCED.inc()
            _flight_record("node.fence", (node_id[:12], epoch, cur, context))
            _log.warning("fencing node %s (%s; claimed epoch %s, current %s): rejecting its "
                         "RPCs until it registers again", node_id[:12], context, epoch, cur)
            # Supervisors treat fencing as death: the same channel, its own
            # event.
            self.pubsub_publish("node_events", {"event": "node_fenced", "node_id": node_id,
                                                "epoch": epoch, "current_epoch": cur,
                                                "ts": time.time()})
            self._trigger("node.fenced", {"node_id": node_id[:12], "epoch": epoch,
                                          "current": cur}, source="gcs")
            self._publish_node_delta(node_id)
        raise StaleNodeEpochError(node_id, claimed_epoch=epoch, current_epoch=cur,
                                  reason=f"{context}: node is dead-marked or its epoch is stale")

    def heartbeat(self, node_id: str, available: Optional[dict] = None,
                  stats: Optional[dict] = None, epoch: Optional[int] = None) -> dict:
        """The 1 Hz fan-in. Payloads are deltas (core/heartbeat.py). A beat
        touches only its node's shard: never the control lock, never a scan
        of the node table. A beat from a dead-marked node or an old epoch
        is fenced, never applied: a zombie flipped back alive in place would
        keep its workers, and a named actor the GCS already rescheduled
        would run twice. An unknown node (a GCS that lost it) gets ok False
        and registers again."""
        alive = self._alive_nodes()
        now = time.monotonic()
        expected = sum(k for k, exp in self._demand_forecast.values() if k > 0 and now < exp)
        raylet_drained = False
        with self._locked(self._shard_for(node_id)) as sh:
            n = sh.nodes.get(node_id)
            if n is None:
                return {"ok": False, "nodes": alive}
            verdict = self._fence_verdict_locked(sh, node_id, n, epoch)
            if verdict is None:
                if stats:
                    _hb.apply_heartbeat(n, available, dict(stats))
                    merged = n.get("stats") or {}
                    if merged.get("draining") and not n.get("draining"):
                        raylet_drained = True
                    # The node's clock offset, gcs_now - its send time (one
                    # hop of latency folds in): the incident merge shifts
                    # the node's flight and span stamps by it.
                    wall = merged.get("wall_ts")
                    if isinstance(wall, (int, float)):
                        n["clock_offset_us"] = int((time.time() - wall) * 1e6)
                elif available is not None:
                    n["available"] = dict(available)
                n["last_hb"] = time.monotonic()
        if verdict is not None:
            self._raise_fenced(node_id, epoch, verdict, "heartbeat")
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
            fc = dict(self._demand_forecast)
            fc[str(source)] = (max(0, int(n)), time.monotonic() + max(0.0, float(ttl_s)))
            self._demand_forecast = fc
        return True

    def _consume_forecast(self, n: int) -> None:
        """Registered launches are no longer expected: they draw the
        forecasts down, sources in sorted order."""
        with self._lock:
            fc = dict(self._demand_forecast)
            for src in sorted(fc):
                if n <= 0:
                    break
                k, exp = fc[src]
                take = min(k, n)
                fc[src] = (k - take, exp)
                n -= take
            self._demand_forecast = fc

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
        with self._locked(self._shard_for(node_id)) as sh:
            n = sh.nodes.get(node_id)
            if n is None:
                return False
            already = bool(n.get("draining"))
            n["draining"] = True
            n["drain_reason"] = reason
            n["drain_deadline"] = time.time() + max(0.0, deadline_s)
            sh.wal_append("_nodes", node_id, n)
            sock = n["sock"] if n["alive"] else None
        if already:
            return True
        imet.NODES_DRAINED.inc()
        _log.warning("node %s draining (%s; deadline %.1f s)", node_id[:12], reason, deadline_s)
        self.pubsub_publish("node_events", {"event": "node_draining", "node_id": node_id,
                                            "deadline_s": deadline_s, "reason": reason,
                                            "ts": time.time()})
        self._publish_node_delta(node_id)
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
        """ALIVE -> DRAINING (a preemption notice) -> DEAD (heartbeat expiry)
        -> FENCED (a dead incarnation's calls came back and were rejected);
        a rejoin registers anew with the next epoch."""
        if n["alive"]:
            return "DRAINING" if n.get("draining") else "ALIVE"
        return "FENCED" if n.get("fenced") else "DEAD"

    @classmethod
    def _node_entry(cls, nid: str, n: dict) -> dict:
        return {
            "NodeID": nid, "Alive": n["alive"], "Resources": dict(n["resources"]),
            "Available": dict(n["available"]), "Stats": dict(n.get("stats") or {}),
            "Draining": bool(n.get("draining")),
            "DrainReason": n.get("drain_reason"),
            "DrainDeadline": n.get("drain_deadline"),
            "Epoch": n.get("epoch"),
            "Fenced": bool(n.get("fenced")),
            "State": cls._node_state(n),
            "Labels": dict(n.get("labels") or {}),
            "sock": n["sock"], "store": n["store"],
        }

    def list_nodes(self, limit: Optional[int] = None) -> List[dict]:
        """Every node's record; `limit` bounds the reply, in node-id order."""
        out: List[dict] = []
        for sh in self._shards:
            with self._locked(sh):
                out.extend(self._node_entry(nid, n) for nid, n in sh.nodes.items())
        if limit is not None:
            out.sort(key=lambda e: e["NodeID"])
            out = out[:max(0, int(limit))]
        return out

    def node_summary(self) -> dict:
        """Membership counts by state and the summed capacity and availability
        of the alive nodes: the rollup that does not ship every record."""
        by_state: Dict[str, int] = {}
        resources: Dict[str, float] = {}
        available: Dict[str, float] = {}
        draining = total = 0
        for sh in self._shards:
            with self._locked(sh):
                for n in sh.nodes.values():
                    total += 1
                    st = self._node_state(n)
                    by_state[st] = by_state.get(st, 0) + 1
                    draining += bool(n.get("draining"))
                    if n["alive"]:
                        for k, v in n["resources"].items():
                            resources[k] = resources.get(k, 0.0) + v
                        for k, v in n["available"].items():
                            available[k] = available.get(k, 0.0) + v
        return {"total": total, "alive": self._alive_nodes(), "draining": draining,
                "by_state": by_state, "resources": resources, "available": available}

    def stats(self) -> dict:
        """Cluster-wide counters (reference: src/ray/stats/metric.h, the
        aggregate half): tasks and actors by state, and the object stores
        summed over the alive nodes' heartbeats."""
        tasks: Dict[str, int] = {}
        actors: Dict[str, int] = {}
        store = {"bytes_in_use": 0, "num_objects": 0, "num_spilled": 0}
        with self._lock:
            for rec in self._tasks.values():
                tasks[rec["state"]] = tasks.get(rec["state"], 0) + 1
            n_pgs = len(self._pgs)
        objects_indexed = 0
        for sh in self._shards:
            with self._locked(sh):
                for a in sh.actors.values():
                    actors[a["state"]] = actors.get(a["state"], 0) + 1
                objects_indexed += len(sh.objects)
                for n in sh.nodes.values():
                    if n["alive"]:
                        s = n.get("stats") or {}
                        for k in store:
                            store[k] += int(s.get(k, 0))
        return {"tasks": tasks, "actors": actors, "objects_indexed": objects_indexed,
                "store": store, "nodes_alive": self._alive_nodes(),
                "placement_groups": n_pgs}

    # The `node_table` channel: one slim row per membership or lifecycle
    # change (registered, draining, dead), so a subscriber mirrors the table
    # by applying rows in seq order instead of polling list_nodes. The
    # per-heartbeat `available` and `stats` stay out of the rows.
    @classmethod
    def _slim_node(cls, nid: str, n: dict) -> dict:
        return {"op": "upsert", "NodeID": nid, "Alive": bool(n["alive"]),
                "Draining": bool(n.get("draining")), "Fenced": bool(n.get("fenced")),
                "Epoch": n.get("epoch", 0), "State": cls._node_state(n),
                "Labels": dict(n.get("labels") or {}), "Resources": dict(n["resources"]),
                "sock": n["sock"], "store": n["store"]}

    def _publish_node_delta(self, node_id: str) -> None:
        with self._locked(self._shard_for(node_id)) as sh:
            n = sh.nodes.get(node_id)
            row = self._slim_node(node_id, n) if n is not None else None
        if row is not None:
            self.pubsub_publish("node_table", row)

    def node_table_snapshot(self) -> dict:
        """The resync point of a `node_table` (or `node_events`) subscriber
        whose cursor fell behind the ring: every node's slim row, and the
        `node_table` seq to resume from. The seq is read before the table, so
        a row published meanwhile is delivered again (upserts are
        idempotent), never lost."""
        with self._pubsub_cv:
            log = self._pubsub.get("node_table", [])
            seq = log[-1][0] if log else 0
        nodes: List[dict] = []
        for sh in self._shards:
            with self._locked(sh):
                nodes.extend(self._slim_node(nid, n) for nid, n in sh.nodes.items())
        imet.GCS_PUBSUB_RESYNCS.inc(channel="node_table.snapshot")
        return {"seq": seq, "nodes": nodes}

    def node_info(self, node_id: str) -> Optional[dict]:
        with self._locked(self._shard_for(node_id)) as sh:
            n = sh.nodes.get(node_id)
            return dict(n) if n else None

    def _resource_sum(self, key: str) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for sh in self._shards:
            with self._locked(sh):
                for n in sh.nodes.values():
                    if n["alive"]:
                        for k, v in n[key].items():
                            out[k] = out.get(k, 0.0) + v
        return out

    def cluster_resources(self) -> Dict[str, float]:
        return self._resource_sum("resources")

    def available_resources(self) -> Dict[str, float]:
        return self._resource_sum("available")

    def _live_nodes(self, exclude: Set[str] = frozenset()) -> List[Tuple[str, dict]]:
        """(node id, record copy) of every alive, not-draining node outside
        `exclude`, one shard at a time, in node-id order (a stable order
        under any shard layout). A draining node is leaving: work placed
        there would be lost at the preemption deadline."""
        out: List[Tuple[str, dict]] = []
        for sh in self._shards:
            with self._locked(sh):
                out.extend((nid, {"sock": n["sock"], "store": n["store"],
                                  "resources": dict(n["resources"]),
                                  "available": dict(n["available"])})
                           for nid, n in sh.nodes.items()
                           if n["alive"] and not n.get("draining") and nid not in exclude)
        out.sort(key=lambda e: e[0])
        return out

    def pick_node(self, resources: dict, exclude: Optional[List[str]] = None,
                  mode: str = "pack") -> Optional[dict]:
        """Best-fit node for a resource request (the cluster-level half of the
        two-level scheduler; reference: cluster_resource_scheduler.h:44 and
        the spread policy). "pack" picks the most-utilized feasible node,
        "spread" round-robins over feasible nodes."""
        feasible: List[dict] = []
        for nid, n in self._live_nodes(set(exclude or [])):
            avail = n["available"]
            if all(avail.get(k, 0.0) >= v for k, v in resources.items()):
                used = 1.0 - sum(avail.values()) / (sum(n["resources"].values()) or 1.0)
                feasible.append({"node_id": nid, "sock": n["sock"], "store": n["store"],
                                 "_used": used})
        if not feasible:
            return None
        if mode == "spread":
            with self._lock:
                self._spread_rr += 1
                chosen = feasible[self._spread_rr % len(feasible)]
        else:
            chosen = max(feasible, key=lambda e: e["_used"])
        return {k: v for k, v in chosen.items() if k != "_used"}

    def _health_loop(self):
        tick = 0
        snap_every = max(1, int(config.GCS_SNAPSHOT_INTERVAL_S / 0.1))
        while not self._stop.wait(0.1):
            self._process_frees()
            tick += 1
            if tick % snap_every == 0:
                self._save_snapshot()
            if tick % 20 == 0:
                # Stranded gangs retry as capacity frees, not only when a
                # node registers.
                self._kick_stranded_gangs()
                self._kick_stranded_restarts()
            dead = []
            lag_records: List[dict] = []
            sample_lag = tick % 10 == 0 and self._history is not None
            lag = imet.NODE_HEARTBEAT_LAG
            for sh in self._shards:
                with self._locked(sh):
                    now = time.monotonic()
                    for nid, n in sh.nodes.items():
                        if not n["alive"]:
                            continue
                        if now - n["last_hb"] > config.HEARTBEAT_TIMEOUT_S:
                            n["alive"] = False
                            sh.alive_count -= 1
                            sh.wal_append("_nodes", nid, n)
                            dead.append(nid)
                        elif sample_lag:
                            # Each alive node's heartbeat lag once a second,
                            # the signal of the heartbeat_lag rule. Built by
                            # hand from the catalog entry and merged at once:
                            # an in-process GcsService has no flusher wired
                            # to it.
                            lag_records.append({
                                "name": lag.name, "kind": lag.kind,
                                "value": now - n["last_hb"],
                                "tags": {"component": lag.component, "node_id": "gcs",
                                         lag.tag_keys[0]: nid[:12]}})
            if lag_records:
                self.report_internal_metrics("gcs", lag_records)
            for nid in dead:
                self._on_node_death(nid)

    def mark_node_dead(self, node_id: str) -> bool:
        """A node known to be gone (its raylet was killed by the cluster that
        started it): declared dead now instead of after the heartbeat
        timeout. The counterpart of the JAX copy's `drain_node`."""
        with self._locked(self._shard_for(node_id)) as sh:
            n = sh.nodes.get(node_id)
            if n is None or not n["alive"]:
                return False
            n["alive"] = False
            sh.alive_count -= 1
            sh.wal_append("_nodes", node_id, n)
        self._on_node_death(node_id)
        return True

    def _on_node_death(self, node_id: str) -> None:
        """Node failure: objects there leave the directory, its queued and
        running tasks fail, its actors restart elsewhere or die (reference:
        gcs_node_manager death handling -> gcs_actor_manager restart :548)."""
        _log.warning("node %s declared dead", node_id[:12])
        _flight_record("node.dead", (node_id[:12],))
        # Death is a node event too: supervisors subscribed for drain
        # notices learn of a failure without one from the same stream.
        self.pubsub_publish("node_events", {"event": "node_dead", "node_id": node_id,
                                            "ts": time.time()})
        self._trigger("node.dead", {"node_id": node_id[:12]}, source="gcs")
        self._publish_node_delta(node_id)
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
        name_drops: List[Tuple[str, dict]] = []
        for sh in self._shards:
            with self._locked(sh):
                for locs in sh.objects.values():
                    locs.discard(node_id)
                for aid, a in sh.actors.items():
                    if a.get("node_id") == node_id and a["state"] in (
                            "ALIVE", "PENDING", "RESTARTING"):
                        a["state"] = "RESTARTING" if self._can_restart(a) else "DEAD"
                        a["node_id"] = None
                        if a["state"] == "DEAD":
                            a["death_reason"] = f"node {node_id[:8]} died"
                            # The name table is under the control lock, never
                            # taken while a shard lock is held: dropped below.
                            name_drops.append((aid, dict(a)))
                        else:
                            restart.append(aid)
                        sh.wal_append("_actors", aid, a)
        if name_drops:
            with self._lock:
                for aid, a in name_drops:
                    self._drop_name(aid, a)
        if restart:
            threading.Thread(target=lambda: [self._restart_actor(a) for a in restart],
                             daemon=True).start()
        # A SLICE_GANG with a member here co-fails: the whole gang moves.
        gangs: List[str] = []
        with self._lock:
            for pg_id, pg in self._pgs.items():
                if (pg["strategy"] == "SLICE_GANG" and pg.get("state") == "CREATED"
                        and node_id in pg["placements"]):
                    pg["state"] = "RESCHEDULING"
                    self._persist_delta("_pgs", pg_id, pg)
                    gangs.append(pg_id)
        if gangs:
            _flight_record("node.gang_cofail", (node_id[:12], len(gangs)))
            threading.Thread(target=lambda: [self._reschedule_gang(g) for g in gangs],
                             daemon=True, name="gang-reschedule").start()

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
            self._persist_delta("_named", key, None)

    def _restart_actor(self, actor_id: str) -> None:
        """Re-places and re-creates one RESTARTING actor. No capacity now:
        it stays RESTARTING and is retried when a node registers and on the
        health loop's cadence."""
        sh = self._shard_for(actor_id)
        with self._lock:
            if actor_id in self._actor_restarting:
                return
            with self._locked(sh):
                a = sh.actors.get(actor_id)
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
                    with self._lock, self._locked(sh):
                        a = sh.actors.get(actor_id)
                        if a is not None and a["state"] == "RESTARTING" and not a.get("node_id"):
                            a["state"] = "DEAD"
                            a["death_reason"] = reason
                            self._drop_name(actor_id, a)
                            sh.wal_append("_actors", actor_id, a)
                return
            with self._locked(sh):
                a = sh.actors.get(actor_id)
                if a is None or a["state"] != "RESTARTING" or a.get("node_id"):
                    return
                a["node_id"] = node["node_id"]
                spec_blob = a["spec_blob"]
                sh.wal_append("_actors", actor_id, a)
            try:
                self._raylet_call(node["sock"], "create_actor", spec_blob,
                                  node.get("bundle_index", -1))
            except Exception as e:  # noqa: BLE001 - retried on the health loop's cadence
                _log.warning("restart of actor %s on %s failed (%r); will retry",
                             actor_id[:8], node["node_id"][:8], e)
                with self._locked(sh):
                    a = sh.actors.get(actor_id)
                    if a is not None and a["state"] == "RESTARTING":
                        # Stranded again, and so persisted: a record still
                        # pinned to the failed target after a GCS restart
                        # would hide from the stranded sweep for good.
                        a["node_id"] = None
                        sh.wal_append("_actors", actor_id, a)
                return
            with self._locked(sh):
                a = sh.actors.get(actor_id)
                if a is not None:
                    # Counted once the create has landed: one logical
                    # restart, however many placement attempts it took.
                    a["num_restarts"] += 1
                    sh.wal_append("_actors", actor_id, a)
            imet.ACTOR_RESTARTS.inc()
        finally:
            with self._lock:
                self._actor_restarting.discard(actor_id)

    def _stranded_actors(self) -> List[str]:
        """RESTARTING actors without a node, one shard at a time."""
        out: List[str] = []
        for sh in self._shards:
            with self._locked(sh):
                out.extend(aid for aid, a in sh.actors.items()
                           if a["state"] == "RESTARTING" and not a.get("node_id"))
        return out

    def _kick_stranded_restarts(self) -> None:
        """One off-thread sweep over RESTARTING actors without a node, only
        when there is one."""
        with self._lock:
            if self._stranded_sweep_inflight or not self._stranded_actors():
                return
            self._stranded_sweep_inflight = True

        def sweep():
            try:
                for aid in self._stranded_actors():
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
            with self._locked(self._shard_for(target_id)) as sh:
                n = sh.nodes.get(target_id)
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
                self._persist_delta("_named", key, actor_id)
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
            feasible = [{"node_id": nid, "sock": n["sock"], "store": n["store"]}
                        for nid, n in self._live_nodes()
                        if all(n["resources"].get(k, 0.0) >= v for k, v in resources.items())]
            if feasible:
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
        burst of actors, the records are committed per actor shard (one
        group commit each, in ascending order), and the GCS forwards the
        creations grouped per target raylet. Per-spec failures come back as
        the exception object in that spec's slot."""
        results: List[Optional[dict]] = [None] * len(specs)
        placed = []
        for i, s in enumerate(specs):
            key = None
            try:
                key = self._claim_name(s["actor_id"], s.get("name"), s.get("namespace"))
                node = self._place_actor(s.get("resources") or {}, s.get("pg_id"),
                                         s.get("bundle_index", -1), s.get("strategy", "DEFAULT"))
            except Exception as e:  # noqa: BLE001 - returned in this spec's slot
                self._release_name_claim(key, s["actor_id"])
                results[i] = {"error": e}
                continue
            placed.append((i, s, node))
        self._consume_forecast(len(placed))
        groups: Dict[int, list] = {}
        for entry in placed:
            groups.setdefault(_gsh.shard_index(entry[1]["actor_id"], self._nshards),
                              []).append(entry)
        for idx in sorted(groups):
            wal: List[Tuple[str, Any, Any]] = []
            with self._locked(self._shards[idx]) as sh:
                for i, s, node in groups[idx]:
                    sh.actors[s["actor_id"]] = rec = self._actor_record(s, node)
                    wal.append(("_actors", s["actor_id"], rec))
                sh.wal_append_many(wal)
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
                    with self._lock, self._locked(self._shard_for(aid)) as sh:
                        a = sh.actors.get(aid)
                        if a is not None and a["state"] == "PENDING":
                            a["state"] = "DEAD"
                            a["death_reason"] = f"creation forward failed: {e!r}"
                            a["node_id"] = None
                            self._drop_name(aid, a)
                            sh.wal_append("_actors", aid, a)
                    results[i] = {"error": e}
        return results

    def register_actor(self, actor_id: str, spec_blob: bytes, resources: dict,
                       max_restarts: int, name: Optional[str], namespace: Optional[str],
                       pg_id: Optional[str] = None, bundle_index: int = -1,
                       strategy: str = "DEFAULT") -> dict:
        """Registers and places one actor; returns the chosen node (the
        caller forwards the creation there)."""
        key = self._claim_name(actor_id, name, namespace)
        try:
            node = self._place_actor(resources, pg_id, bundle_index, strategy)
        except BaseException:
            self._release_name_claim(key, actor_id)
            raise
        self._consume_forecast(1)
        spec = {"spec_blob": spec_blob, "resources": resources, "max_restarts": max_restarts,
                "pg_id": pg_id, "strategy": strategy, "name": name, "namespace": namespace}
        with self._locked(self._shard_for(actor_id)) as sh:
            sh.actors[actor_id] = rec = self._actor_record(spec, node)
            sh.wal_append("_actors", actor_id, rec)
        return node

    def _release_name_claim(self, key: Optional[Tuple[str, str]], actor_id: str) -> None:
        if key is not None:
            with self._lock:
                if self._named.get(key) == actor_id:
                    del self._named[key]
                    self._persist_delta("_named", key, None)

    @staticmethod
    def _actor_record(s: dict, node: dict) -> dict:
        return {
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

    def actor_started(self, actor_id: str, node_id: str, epoch: Optional[int] = None) -> bool:
        """One actor_started report; False: the instance is a duplicate."""
        return self.actor_started_batch(node_id, [actor_id], epoch)[actor_id]

    def actor_started_batch(self, node_id: str, actor_ids: List[str],
                            epoch: Optional[int] = None) -> Dict[str, bool]:
        """Coalesced actor_started reports from one raylet. False tells the
        raylet its instance is a duplicate (the record moved) to kill.
        Fenced: a zombie reporting "started" for an actor the GCS already
        rescheduled would point the record at the duplicate."""
        self._reject_stale_node(node_id, epoch, "actor_started")
        out: Dict[str, bool] = {}
        groups = self._by_shard(actor_ids)
        for idx in sorted(groups):
            wal: List[Tuple[str, Any, Any]] = []
            with self._locked(self._shards[idx]) as sh:
                for aid in groups[idx]:
                    a = sh.actors.get(aid)
                    if a and (a["state"] == "DEAD" or a.get("node_id") not in (None, node_id)):
                        out[aid] = False
                        continue
                    if a:
                        a["state"] = "ALIVE"
                        a["node_id"] = node_id
                        wal.append(("_actors", aid, a))
                    out[aid] = True
                if wal:
                    sh.wal_append_many(wal)
        return out

    def actor_died(self, actor_id: str, reason: str, no_restart: bool = False,
                   node_id: Optional[str] = None, epoch: Optional[int] = None) -> dict:
        """Returns {restart: bool}; on True the GCS re-places and re-creates
        the actor itself, off-thread (reference: design_docs/actor_states.rst).
        A raylet's report carries (node_id, epoch): a fenced incarnation's
        report must not flip the rescheduled successor to RESTARTING."""
        if node_id is not None:
            self._reject_stale_node(node_id, epoch, "actor_died")
        # The control lock first (the name drop needs it), then the actor's
        # shard: the one legal nesting.
        with self._lock, self._locked(self._shard_for(actor_id)) as sh:
            a = sh.actors.get(actor_id)
            if a is None:
                return {"restart": False}
            if node_id is not None and a.get("node_id") not in (None, node_id):
                return {"restart": False}
            if no_restart or not self._can_restart(a):
                a["state"] = "DEAD"
                a["death_reason"] = reason
                a["node_id"] = None
                self._drop_name(actor_id, a)
                sh.wal_append("_actors", actor_id, a)
                return {"restart": False}
            a["state"] = "RESTARTING"
            a["node_id"] = None
            sh.wal_append("_actors", actor_id, a)
        self._kick_stranded_restarts()
        return {"restart": True}

    def get_actor(self, actor_id: str) -> Optional[dict]:
        with self._locked(self._shard_for(actor_id)) as sh:
            a = sh.actors.get(actor_id)
            if a is None:
                return None
            out = {k: v for k, v in a.items() if k != "spec_blob"}
        # The node's shard is taken after the actor's is released.
        out["sock"] = self._node_sock(out["node_id"], alive_only=False) if out["node_id"] else None
        return out

    def lookup_named_actor(self, name: str, namespace: Optional[str]) -> Optional[str]:
        with self._lock:
            return self._named.get((namespace or "default", name))

    def list_actors(self, limit: int = 1000) -> List[dict]:
        """The actor table's summary (reference: the state API's
        list_actors); supervisors map actors to nodes with it."""
        out: List[dict] = []
        for sh in self._shards:
            with self._locked(sh):
                out.extend({"actor_id": aid, "state": a["state"], "node_id": a.get("node_id"),
                            "name": a.get("name"), "namespace": a.get("namespace"),
                            "num_restarts": a.get("num_restarts", 0),
                            "max_restarts": a.get("max_restarts", 0), "pg_id": a.get("pg_id"),
                            "death_reason": a.get("death_reason", "")}
                           for aid, a in sh.actors.items())
        return out[-limit:]

    # ------------------------------------------------------------ objects
    def list_objects(self, limit: int = 1000) -> List[dict]:
        """The object directory: each object's locations, borrows and whether
        its free waits on a borrower."""
        out: List[dict] = []
        for sh in self._shards:
            with self._locked(sh):
                out.extend({"object_id": h, "locations": sorted(locs),
                            "borrows": sh.borrows.get(h, 0),
                            "pending_free": h in sh.deferred_free}
                           for h, locs in list(sh.objects.items())[-limit:])
        return out[-limit:]

    def add_object_location(self, oid_hex: str, node_id: str) -> bool:
        """Indexes one copy of an object on a node (a raylet's syncs batch
        these through node_sync)."""
        with self._locked(self._shard_for(oid_hex)) as sh:
            sh.objects.setdefault(oid_hex, set()).add(node_id)
        return True

    def remove_object_location(self, oid_hex: str, node_id: str,
                               epoch: Optional[int] = None) -> bool:
        """A node dropped its copy (replica eviction); fenced like every
        raylet mutation."""
        self._reject_stale_node(node_id, epoch, "remove_object_location")
        with self._locked(self._shard_for(oid_hex)) as sh:
            locs = sh.objects.get(oid_hex)
            if locs is not None:
                locs.discard(node_id)
                if not locs:
                    del sh.objects[oid_hex]
        return True

    def get_object_locations(self, oid_hex: str) -> List[dict]:
        with self._locked(self._shard_for(oid_hex)) as sh:
            locs = list(sh.objects.get(oid_hex, ()))
        view = self._nodes_view_for(locs)
        return [{"node_id": nid, "sock": view[nid]["sock"], "store": view[nid]["store"]}
                for nid in locs if nid in view and view[nid]["alive"]]

    def get_object_locations_batch(self, oid_hexes: List[str]) -> Dict[str, List[dict]]:
        """One round trip for a raylet's whole wait set."""
        found: Dict[str, List[str]] = {}
        groups = self._by_shard(oid_hexes)
        for idx in sorted(groups):
            with self._locked(self._shards[idx]) as sh:
                for h in groups[idx]:
                    if sh.objects.get(h):
                        found[h] = list(sh.objects[h])
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
        groups = self._by_shard(h for b in ready for h in b)
        for idx in sorted(groups):
            with self._locked(self._shards[idx]) as sh:
                for h in groups[idx]:
                    if sh.borrows.get(h, 0) > 0:
                        sh.deferred_free.add(h)
                    else:
                        self._release_locked(sh, h, freed)
        self._delete_on_nodes(freed)

    def _release_locked(self, sh: _gsh.GcsShard, h: str,
                        freed: List[Tuple[str, List[str]]]) -> None:
        """Tombstones `h` and collects (h, its locations) for the delete
        (its shard's lock held; the nodes are resolved after it is
        released)."""
        sh.freed[h] = True
        cap = max(1024, FREED_CAP // self._nshards)
        while len(sh.freed) > cap:
            sh.freed.popitem(last=False)
        locs = sh.objects.pop(h, None)
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
            except Exception:  # lint: swallow-ok(node going away frees its pool anyway)
                pass

    def update_borrows(self, deltas: Dict[str, int]) -> bool:
        """Batched borrow-count adjustments from non-owner processes."""
        freed: List[Tuple[str, List[str]]] = []
        groups = self._by_shard(deltas)
        for idx in sorted(groups):
            with self._locked(self._shards[idx]) as sh:
                for h in groups[idx]:
                    c = sh.borrows.get(h, 0) + deltas[h]
                    if c > 0:
                        sh.borrows[h] = c
                        continue
                    sh.borrows.pop(h, None)
                    if h in sh.deferred_free:
                        sh.deferred_free.discard(h)
                        self._release_locked(sh, h, freed)
        self._delete_on_nodes(freed)
        return True

    def node_sync(self, node_id: str, sealed: List[str], events: List[dict],
                  epoch: Optional[int] = None) -> bool:
        """Batched raylet -> GCS sync: object locations and task state events
        (reference: task_event_buffer.h batching + object directory adds).
        A location for an object already freed is deleted on its node.
        Fenced: a dead or stale incarnation's copies are already gone from
        the directory, and indexing them again would hand readers dangling
        locations."""
        self._reject_stale_node(node_id, epoch, "node_sync")
        stale: List[str] = []
        groups = self._by_shard(sealed)
        for idx in sorted(groups):
            with self._locked(self._shards[idx]) as sh:
                for h in groups[idx]:
                    if h in sh.freed:
                        stale.append(h)
                    else:
                        sh.objects.setdefault(h, set()).add(node_id)
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
                    if evt.get("retry"):
                        rec["retries"] = evt["retry"]
                    # The last 8 transitions, (state, ts, node): the timeline
                    # export reads RUNNING -> FINISHED/FAILED spans from them.
                    hist = rec.setdefault("history", [])
                    hist.append((evt["state"], rec["ts"], node_id))
                    del hist[:-8]
        if stale:
            self._delete_on_nodes([(h, [node_id]) for h in stale])
        return True

    @staticmethod
    def _task_copy(rec: dict) -> dict:
        # The history list is copied under the lock: the RPC layer pickles
        # the reply while node_sync may append to it.
        out = dict(rec)
        if "history" in out:
            out["history"] = list(out["history"])
        return out

    def get_task_states(self, task_ids: List[str]) -> Dict[str, dict]:
        with self._lock:
            return {tid: self._task_copy(self._tasks[tid]) for tid in task_ids
                    if tid in self._tasks}

    def list_tasks(self, limit: int = 1000) -> List[dict]:
        """The task table, oldest first: state, node, name, retries and the
        transition history."""
        with self._lock:
            out = [self._task_copy(rec) for rec in self._tasks.values()]
        return out[-limit:]

    # ----------------------------------------------------------------- KV
    def kv_put(self, key: str, value: bytes) -> bool:
        with self._lock:
            self._kv[key] = value
            self._persist_delta("_kv", key, value)
        return True

    def kv_get(self, key: str) -> Optional[bytes]:
        with self._lock:
            return self._kv.get(key)

    def kv_del(self, key: str) -> bool:
        with self._lock:
            hit = self._kv.pop(key, None) is not None
            if hit:
                self._persist_delta("_kv", key, None)
            return hit

    def kv_keys(self, prefix: str = "") -> List[str]:
        with self._lock:
            return [k for k in self._kv if k.startswith(prefix)]

    # --------------------------------------------------- placement groups
    def _plan_bundles(self, bundles: List[dict], strategy: str, banned: Set[str]) -> List[str]:
        """Placement planning against the current resource view (reference:
        bundle_scheduling_policy.h PACK/SPREAD/STRICT_PACK/STRICT_SPREAD, and
        SLICE_GANG)."""
        if strategy == "SLICE_GANG":
            return self._plan_slice_gang(bundles, banned)
        avail = {nid: n["available"] for nid, n in self._live_nodes(banned)}
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

    def _plan_slice_gang(self, bundles: List[dict], banned: Set[str]) -> List[str]:
        """SLICE_GANG: every bundle on the hosts of ONE slice (alive nodes
        labelled with one slice_name, in worker_index order), one bundle per
        host in turn, or the group fails as a whole: a program sharded over
        a slice must see all of it. The smallest slice that fits goes first,
        so a large one is not fragmented (reference: the TPU-{pod}-head idiom,
        python/ray/_private/accelerators/tpu.py:334-397, as the JAX package
        makes it a policy of its own)."""
        slices: Dict[str, List[Tuple[int, str, dict]]] = {}
        for sh in self._shards:
            with self._locked(sh):
                for nid, n in sh.nodes.items():
                    labels = n.get("labels") or {}
                    if (not n["alive"] or nid in banned or n.get("draining")
                            or not labels.get("slice_name")):
                        continue
                    slices.setdefault(str(labels["slice_name"]), []).append(
                        (int(labels.get("worker_index", 0)), nid, dict(n["available"])))
        for name in sorted(slices, key=lambda sl: (len(slices[sl]), sl)):
            hosts = sorted(slices[name], key=lambda h: (h[0], h[1]))
            avail = {nid: av for _, nid, av in hosts}
            order = [nid for _, nid, _ in hosts]
            placements: List[str] = []
            for bundle in bundles:
                chosen = None
                for j in range(len(order)):
                    nid = order[(len(placements) + j) % len(order)]
                    if all(avail[nid].get(k, 0.0) >= v for k, v in bundle.items()):
                        chosen = nid
                        break
                if chosen is None:
                    break
                for k, v in bundle.items():
                    avail[chosen][k] = avail[chosen].get(k, 0.0) - v
                placements.append(chosen)
            if len(placements) == len(bundles):
                return placements
        raise PlacementGroupError(
            f"no slice can host all {len(bundles)} bundles of the gang at once")

    def _reschedule_gang(self, pg_id: str) -> None:
        """A gang member died: release every sibling bundle and place the
        WHOLE gang again (no partial restart). One rescheduler at a time
        (REPLANNING); a gang no slice can take goes back to RESCHEDULING,
        retried on the next registration or health tick."""
        with self._lock:
            pg = self._pgs.get(pg_id)
            if pg is None or pg.get("state") != "RESCHEDULING":
                return
            pg["state"] = "REPLANNING"  # not logged: the log keeps RESCHEDULING
            placements, bundles = list(pg["placements"]), pg["bundles"]
        self._release_bundles(pg_id, list(zip(placements, range(len(placements)))),
                              alive_only=True)
        for nid, bundle in zip(placements, bundles):
            self._give_back(nid, bundle)
        try:
            self.create_placement_group(pg_id, bundles, "SLICE_GANG")
            _flight_record("node.gang_replaced", (pg_id[:12],))
        except Exception as e:  # noqa: BLE001 - no slice fits yet: retried
            with self._lock:
                pg = self._pgs.get(pg_id)
                if pg is not None and pg.get("state") == "REPLANNING":
                    pg["state"] = "RESCHEDULING"
            _log.info("gang %s waits for a slice: %s", pg_id[:12], e)

    def _give_back(self, nid: str, bundle: dict) -> Optional[str]:
        """Returns a released bundle's resources to the node's view at once
        (its next heartbeat confirms them); the node's socket if it is
        alive."""
        with self._locked(self._shard_for(nid)) as sh:
            n = sh.nodes.get(nid)
            if n is None:
                return None
            for k, v in bundle.items():
                n["available"][k] = min(n["resources"].get(k, 0.0),
                                        n["available"].get(k, 0.0) + v)
            return n["sock"] if n["alive"] else None

    def _kick_stranded_gangs(self) -> None:
        """Retries every RESCHEDULING gang (new capacity may complete a
        slice) on a thread of its own: a refused lease's RPCs must not hold
        the health loop."""
        with self._lock:
            stranded = [g for g, pg in self._pgs.items() if pg.get("state") == "RESCHEDULING"]
        if not stranded:
            return
        threading.Thread(target=lambda: [self._reschedule_gang(g) for g in stranded],
                         daemon=True, name="gang-reschedule").start()

    def _release_bundles(self, pg_id: str, reserved: List[Tuple[str, int]],
                         alive_only: bool = False) -> None:
        for nid, i in reserved:
            sock = self._node_sock(nid, alive_only=alive_only)
            if sock:
                try:
                    self._raylet_call(sock, "release_bundle", pg_id, i)
                except Exception:  # lint: swallow-ok(bundle release on a dead/gone node)
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
                        except Exception:  # lint: swallow-ok(advisory resource-view refresh)
                            continue
                        with self._locked(self._shard_for(nid)) as sh:
                            if nid in sh.nodes:
                                sh.nodes[nid]["available"] = dict(avail)
                with self._lock:
                    removed = pg_id in self._removed_pgs
                    if not removed:
                        self._pgs[pg_id] = {"bundles": bundles, "strategy": strategy,
                                            "placements": placements, "state": "CREATED",
                                            "rr": 0}
                        self._persist_delta("_pgs", pg_id, self._pgs[pg_id])
                if removed:
                    self._release_bundles(pg_id, reserved)
                    raise PlacementGroupError(f"placement group {pg_id[:8]} was removed")
                return {"placements": placements}
            self._release_bundles(pg_id, reserved)
            banned.add(failed)
            last_err = f"node {failed[:8]} refused bundle lease"
        raise PlacementGroupError(f"placement group {pg_id[:8]} creation failed: {last_err}")

    def _raylet_call(self, sock: str, method: str, *args, timeout: Optional[float] = None):
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
        return cli.call(method, *args, timeout=timeout)

    def remove_placement_group(self, pg_id: str) -> bool:
        with self._lock:
            pg = self._pgs.pop(pg_id, None)
            if pg is not None:
                self._persist_delta("_pgs", pg_id, None)
            self._removed_pgs[pg_id] = True
            while len(self._removed_pgs) > 10_000:
                self._removed_pgs.popitem(last=False)
        if pg:
            for i, (nid, bundle) in enumerate(zip(pg["placements"], pg["bundles"])):
                sock = self._give_back(nid, bundle)
                if sock:
                    try:
                        self._raylet_call(sock, "release_bundle", pg_id, i)
                    except Exception:  # lint: swallow-ok(bundle release on a dead/gone node)
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
        with self._locked(self._shard_for(nid)) as sh:
            n = sh.nodes.get(nid)
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
            self._persist_delta("_pgs", pg_id, self._pgs[pg_id])
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
                # A RESCHEDULING gang is the GCS's own to retry.
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

    # ------------------------------------------------------------ metrics
    def _merge_metric_records(self, table: Dict[Tuple, dict], worker_id: str,
                              records: List[dict], history=None) -> bool:
        """Aggregates flushed records per (name, tags): counters add their
        deltas, gauges keep the last value per reporter, histograms add their
        sums and bucket counts. Each aggregate also names its latest 64
        reporters (a raylet, a worker id, a driver, the GCS), which the JAX
        copy does not keep: an operator sees which processes feed a series.
        With `history`, each merged series lands a cumulative sample (a
        gauge: the sum over its reporters heard from in the last 30 s, the
        rule of `_metrics_view`)."""
        with self._lock:
            for rec in records:
                tags = dict(rec.get("tags") or {})
                entry = table.setdefault((rec["name"], tuple(sorted(tags.items()))), {
                    "name": rec["name"], "kind": rec["kind"], "tags": tags,
                    "value": 0.0, "gauges": {}, "reporters": {}})
                reporters = entry["reporters"]
                reporters.pop(worker_id, None)
                reporters[worker_id] = True
                while len(reporters) > 64:
                    reporters.pop(next(iter(reporters)))
                if rec["kind"] == "counter":
                    entry["value"] += float(rec["value"])
                elif rec["kind"] == "gauge":
                    entry["gauges"][worker_id] = (float(rec["value"]), time.monotonic())
                elif rec["kind"] == "histogram":
                    entry["value"] += float(rec["value"])
                    counts = rec.get("counts") or []
                    have = entry.setdefault("counts", [0] * len(counts))
                    if len(have) == len(counts):
                        entry["counts"] = [a + b for a, b in zip(have, counts)]
                    entry.setdefault("boundaries", rec.get("boundaries"))
                if history is None:
                    continue
                if rec["kind"] == "counter":
                    history.observe(entry["name"], "counter", entry["tags"], entry["value"])
                elif rec["kind"] == "gauge":
                    now_m = time.monotonic()
                    total = sum(v for v, ts in entry["gauges"].values() if now_m - ts < 30.0)
                    history.observe(entry["name"], "gauge", entry["tags"], total)
                elif rec["kind"] == "histogram":
                    history.observe(entry["name"], "histogram", entry["tags"],
                                    float(sum(entry.get("counts") or [])),
                                    hist_sum=entry["value"])
        return True

    def _metrics_view(self, table: Dict[Tuple, dict]) -> List[dict]:
        """Every aggregate; a gauge is the sum over its reporters heard from
        in the last 30 s (a dead worker's last value is pruned)."""
        now = time.monotonic()
        out: List[dict] = []
        with self._lock:
            for v in table.values():
                if v["kind"] == "gauge":
                    for w in [w for w, (_, ts) in v["gauges"].items() if now - ts >= 30.0]:
                        del v["gauges"][w]
                    v["value"] = sum(val for val, _ in v["gauges"].values())
                entry = dict(v)
                entry["reporters"] = list(v["reporters"])
                if entry["kind"] == "gauge":
                    entry["gauges"] = {w: val for w, (val, _) in v["gauges"].items()}
                elif "counts" in entry:
                    entry["counts"] = list(entry["counts"])
                out.append(entry)
        return out

    def report_metrics(self, worker_id: str, records: List[dict]) -> bool:
        """User-defined application metrics (utils/metrics.py)."""
        return self._merge_metric_records(self._user_metrics, worker_id, records)

    def user_metrics(self) -> List[dict]:
        return self._metrics_view(self._user_metrics)

    def report_internal_metrics(self, worker_id: str, records: List[dict]) -> bool:
        """The runtime's `raytpu_*` catalog (utils/internal_metrics.py),
        flushed by raylets, workers, drivers and this daemon itself."""
        return self._merge_metric_records(self._internal_metrics, worker_id, records,
                                          history=self._history)

    def internal_metrics(self) -> List[dict]:
        return self._metrics_view(self._internal_metrics)

    def metrics_history(self, name: Optional[str] = None, tags: Optional[dict] = None,
                        window_s: Optional[float] = None, as_rate: bool = False) -> List[dict]:
        """The internal metrics' time series: matching series with [ts, value]
        samples ([ts, count, sum] for histograms), fine-resolution recent
        and rolled-up old. Empty when retention is off
        (RAY_TPU_METRICS_HISTORY=0)."""
        if self._history is None:
            return []
        return self._history.query(name=name, tags=tags, window_s=window_s, as_rate=as_rate)

    def _observe_rpc(self, method: str, latency_ms: float) -> None:
        """Per-method RPC accounting, called by core/rpc.py's server after
        each request (the raylet defines no such hook, so its task path pays
        nothing). A long poll's duration is its subscriber's wait, not GCS
        work, and stays out of the latency histogram."""
        imet.GCS_RPC_TOTAL.inc(method=method)
        if method not in ("pubsub_poll", "pubsub_poll2"):
            imet.GCS_RPC_LATENCY.observe(latency_ms, method=method)

    def active_alerts(self) -> List[dict]:
        """The SLO watchdog's firing alerts (empty when it is disarmed)."""
        if self._watchdog is None:
            return []
        return self._watchdog.active_alerts()

    # ------------------------------------------------------- error reports
    # Workers report uncaught task exceptions and raylets worker crashes
    # (with the dying process's output tail): a bounded ring, also published
    # on the `error_reports` channel.
    _ERRORS_RETAIN = 256

    def report_error(self, payload: dict) -> bool:
        if not isinstance(payload, dict):
            return False
        payload = dict(payload)
        payload.setdefault("ts", time.time())
        with self._lock:
            self._errors.append(payload)
            del self._errors[:-self._ERRORS_RETAIN]
        imet.ERROR_REPORTS.inc()
        self.pubsub_publish("error_reports", payload)
        return True

    def cluster_errors(self, limit: int = 100) -> List[dict]:
        with self._lock:
            return list(self._errors)[-limit:]

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
            backlog = sum(len(entries) for entries in self._pubsub.values())
            self._pubsub_cv.notify_all()
        imet.GCS_PUBSUB_BACKLOG.set(backlog)
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
                    out, gap = [], True
                    break
                out, gap = [(q, m) for q, m in log if q > after_seq], False
                remaining = deadline - time.monotonic()
                if out or remaining <= 0:
                    break
                self._pubsub_cv.wait(timeout=min(remaining, 1.0))
        if gap:
            imet.GCS_PUBSUB_RESYNCS.inc(channel=channel)
        elif out:
            imet.GCS_PUBSUB_DELTAS.inc(len(out), channel=channel)
        return {"entries": out, "gap": gap}

    # ---------------------------------------------------------- lifecycle
    def ping(self) -> str:
        return "pong"

    def flight_dump(self) -> Optional[str]:
        """Dumps this process's flight ring (node.dead, node.fence,
        node.added, incident.*), so a post-mortem orders the membership
        transitions exactly."""
        from ..observability import flight_recorder as _frec

        return _frec.dump(reason="gcs flight_dump rpc")

    # ------------------------------------------------------- trigger bus
    @staticmethod
    def _postmortem_enabled() -> bool:
        return os.environ.get("RAY_TPU_POSTMORTEM") != "0"

    @staticmethod
    def _env_float(name: str, default: float) -> float:
        try:
            return float(os.environ.get(name, default))
        except ValueError:
            return default

    def report_trigger(self, kind: str, detail: Any = None,
                       source: Optional[str] = None) -> dict:
        """The remote half of the trigger bus: raylets, drivers and workers
        forward their anomaly triggers here (postmortem.arm_client)."""
        return self._trigger(kind, detail, source)

    def _trigger(self, kind: str, detail: Any = None, source: Optional[str] = None) -> dict:
        """One anomaly trigger: it joins the open incident while that
        incident's last trigger is within the (sliding) coalesce window, so a
        storm of faults is one incident's chain, not a harvest each; else it
        opens a fresh incident and starts its harvest in a thread (the
        harvest calls every raylet: never on an RPC handler, never under a
        lock)."""
        if not self._postmortem_enabled():
            return {"ok": False, "disabled": True}
        ev = {"ts": time.time(), "ts_us": time.time_ns() // 1000, "kind": kind,
              "detail": _postmortem.safe_detail(detail), "source": source}
        imet.POSTMORTEM_TRIGGERS.inc(kind=kind)
        fresh = False
        window = self._env_float("RAY_TPU_INCIDENT_WINDOW_S", 10.0)
        with self._incident_lock:
            inc = self._incidents.get(self._open_incident) if self._open_incident else None
            now_mono = time.monotonic()
            if inc is not None and now_mono - inc["last_mono"] <= window:
                inc["last_mono"] = now_mono
                inc["triggers"].append(ev)
                inc["coalesced"] += 1
                iid = inc["id"]
            else:
                iid = f"inc-{ev['ts_us']}-{kind.replace('.', '-')}"
                self._incidents[iid] = {"id": iid, "opened_ts": ev["ts"],
                                        "opened_mono": now_mono, "last_mono": now_mono,
                                        "state": "open", "triggers": [ev], "coalesced": 0,
                                        "bundle": None}
                self._open_incident = iid
                fresh = True
                while len(self._incidents) > 64:
                    self._incidents.popitem(last=False)
        if fresh:
            _flight_record("incident.open", (iid, kind))
            imet.POSTMORTEM_INCIDENTS.inc()
            _log.warning("incident %s opened by trigger %s (source=%s); harvesting",
                         iid, kind, source)
            self.pubsub_publish("node_events", {"event": "incident", "incident_id": iid,
                                                "trigger": kind, "ts": ev["ts"]})
            threading.Thread(target=self._harvest, args=(iid,), daemon=True,
                             name=f"harvest-{iid[:20]}").start()
        return {"ok": True, "incident": iid, "coalesced": not fresh}

    def _harvest(self, incident_id: str) -> None:
        """One incident's harvest: after a settle delay (the trigger chain
        accumulates, secondary failures land) it calls `flight_dump` on
        every alive raylet (each SIGUSR2s its workers) and takes their log
        tails, dumps this process's ring, gives the signalled rings half a
        second to land, and stages the bundle with its clock-offset
        manifest and the merged trace. The node list is read under the lock
        and every call is made outside it."""
        from ..observability import flight_recorder as _frec

        time.sleep(max(0.0, self._env_float("RAY_TPU_HARVEST_DELAY_S", 0.75)))
        with self._incident_lock:
            inc = self._incidents.get(incident_id)
            if inc is None or self._stop.is_set():
                return  # a GCS that stopped meanwhile harvests nothing
            inc["state"] = "harvesting"
        try:
            nodes = []
            for sh in self._shards:
                with self._locked(sh):
                    nodes.extend((nid, n["sock"], int(n.get("clock_offset_us") or 0))
                                 for nid, n in sh.nodes.items() if n["alive"])
            pids: Dict[str, dict] = {str(os.getpid()): {"node": "gcs", "offset_us": 0}}
            node_info: Dict[str, dict] = {}
            logs: List[dict] = []
            for nid, sock, offset_us in nodes:
                node_info[nid[:12]] = {"offset_us": offset_us}
                try:
                    res = self._raylet_call(sock, "flight_dump", timeout=30.0)
                except Exception as e:  # noqa: BLE001 - harvest the reachable rings
                    node_info[nid[:12]]["error"] = repr(e)[:200]
                    continue
                node_info[nid[:12]]["dump"] = (res or {}).get("path")
                for pid in (res or {}).get("pids") or ():
                    pids[str(pid)] = {"node": nid[:12], "offset_us": offset_us}
                try:
                    logs.extend(self._raylet_call(sock, "tail_logs", {"tail": 300},
                                                  timeout=30.0) or [])
                except Exception:
                    pass  # lint: swallow-ok(log tails are enrichment; the rings are the contract)
            _frec.dump(reason=f"incident harvest {incident_id}")
            time.sleep(0.5)  # the signalled workers' rings land
            with self._incident_lock:
                triggers = list(inc["triggers"])
            # The metrics of the incident's window: from 30 s before its
            # first trigger, at least a minute; the last goodput and MFU in
            # it are the incident's impact on training.
            window_s = max(60.0, time.time() - (triggers[0]["ts"] - 30.0))
            metrics = self.metrics_history(window_s=window_s)
            goodput: Dict[str, Any] = {}
            for series in metrics:
                if series["name"] == "raytpu_train_goodput" and series["samples"]:
                    goodput["goodput"] = series["samples"][-1][1]
                if series["name"] == "raytpu_train_mfu" and series["samples"]:
                    goodput["mfu"] = series["samples"][-1][1]
            logs.sort(key=lambda r: r.get("ts") or 0.0)
            manifest = {"incident_id": incident_id, "opened_ts": triggers[0]["ts"],
                        "triggers": triggers, "nodes": node_info, "pids": pids,
                        "goodput": goodput, "impact_window_s": window_s}
            bundle_dir = os.path.join(_postmortem.incidents_dir(self._session_dir),
                                      incident_id)
            # The dumps and spans of this incident's minute only: the flight
            # dir of a long session holds every earlier incident's rings, which
            # each harvest would copy and merge again (the JAX copy takes an
            # hour's).
            _postmortem.stage_bundle(bundle_dir, manifest, log_records=logs[-1000:],
                                     metrics=metrics,
                                     max_age_s=time.time() - triggers[0]["ts"] + 60.0)
            _postmortem.merge_trace(bundle_dir)
            with self._incident_lock:
                inc["state"] = "staged"
                inc["bundle"] = bundle_dir
            _flight_record("incident.staged", (incident_id, bundle_dir))
            _log.warning("incident %s staged: %s (postmortem.render_report renders it)",
                         incident_id, bundle_dir)
        except Exception:  # noqa: BLE001 - recorded on the incident
            _log.exception("incident %s harvest failed", incident_id)
            with self._incident_lock:
                inc["state"] = "failed"

    def list_incidents(self) -> List[dict]:
        """Incident records, oldest first."""
        with self._incident_lock:
            return [{"incident_id": i["id"], "opened_ts": i["opened_ts"], "state": i["state"],
                     "trigger": i["triggers"][0]["kind"] if i["triggers"] else None,
                     "triggers": len(i["triggers"]), "bundle": i["bundle"]}
                    for i in self._incidents.values()]

    def get_incident(self, incident_id: str) -> Optional[dict]:
        with self._incident_lock:
            inc = self._incidents.get(incident_id)
            if inc is None:
                return None
            out = dict(inc)
            out["triggers"] = list(inc["triggers"])
            return out

    def debug_harvest(self, timeout_s: float = 20.0) -> dict:
        """An operator's harvest: raises a `debug.manual` trigger and waits
        for its incident's bundle, so the caller gets one bundle path. It
        coalesces like any trigger: a harvest asked for mid-incident
        returns that incident's bundle."""
        res = self._trigger("debug.manual", None, source="debug_harvest")
        if not res.get("ok"):
            return {"ok": False, "reason": "trigger bus disabled"}
        iid = res["incident"]
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            inc = self.get_incident(iid)
            if inc is None:
                break
            if inc["state"] in ("staged", "failed"):
                return {"ok": inc["state"] == "staged", "incident": iid, "state": inc["state"],
                        "bundle": inc["bundle"], "triggers": inc["triggers"]}
            time.sleep(0.1)
        return {"ok": False, "incident": iid, "reason": "harvest timed out"}

    # chaos_partition / chaos_heal come from ChaosPartitionRpc (chaos/net.py),
    # one definition shared with the raylet.

    def stop(self) -> bool:
        self._stop.set()
        if self._watchdog is not None:
            self._watchdog.stop()
        _postmortem.disarm(self._trigger)
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


def main(sock_path: str, snapshot_path: Optional[str] = None,
         tcp_address: Optional[str] = None) -> None:
    """GCS daemon: serves the cluster's control plane on `sock_path`, and on
    `tcp_address` too for a cluster other hosts join (its bound address is
    printed as GCS_TCP_ADDRESS=... for the head to read). Its tables persist
    to `snapshot_path` (default `<sock_path>.snapshot`) and its log; a GCS
    started again on the same path takes them up."""
    from ..observability import logs as _logs
    from ..utils.sampling_profiler import maybe_start_from_env
    from .rpc import RpcServer

    session_dir = os.path.dirname(sock_path) or "."
    _logs.configure("gcs", node_id="gcs", directory=os.path.join(session_dir, "logs"))
    maybe_start_from_env("gcs")
    _log.info("gcs started (pid %d)", os.getpid())
    service = GcsService(snapshot_path=snapshot_path or sock_path + ".snapshot",
                         session_dir=session_dir)
    # The daemon's own `raytpu_*` records merge straight into its table.
    imet.configure(node_id="gcs", reporter="gcs",
                   sink=lambda recs: service.report_internal_metrics("gcs", recs))
    servers = [RpcServer(sock_path, service)]
    if tcp_address:
        servers.append(RpcServer(tcp_address, service))
        # console-output: bootstrap protocol, read from gcs.out by the head's Cluster
        print(f"GCS_TCP_ADDRESS={servers[-1].address}", flush=True)
    exit_with_parent(service._stop)
    try:
        while not service._stop.wait(0.5):
            pass
    finally:
        for server in servers:
            server.shutdown()


if __name__ == "__main__":
    main(*sys.argv[1:4])
