"""The sharded GCS, the port against the JAX package: every case of
tests/test_gcs_shards.py runs on both packages (ray_tpu_torch/core/
gcs_shards.py and the shard routing of core/gcs.py) with the same
assertions: routing and the shard count's clamp, the same `shard_index` for
the same keys in both packages, the log codec and torn tails (one in the
middle of a batch), replay across a restart and across a shard-count
change, the epoch fence on every shard and across a restart, batched
registration and concurrent cross-shard batches against a model, pubsub's
gap-aware poll, the node-table mirror, the heartbeat delta codec,
`list_nodes`' limit with `node_summary`, and the catalog entry.

One more case, on both packages: a log written by the single-file GCS (one
`<snapshot>.wal` holding every table's records, the port's layout before its
shards) replays into the sharded GCS with every epoch, actor and KV entry.

The cases drive GcsService in process (no cluster, no RPC); each runs under
torch_modes.case_time_limit.
"""

import importlib
import os
import random
import threading
import types

import pytest

import torch_modes

PKGS = ("jax", "torch")
ROOT = {"jax": "ray_tpu", "torch": "ray_tpu_torch"}
LIMIT_S = 60


@pytest.fixture(params=PKGS)
def p(request):
    mod = lambda m: importlib.import_module(f"{ROOT[request.param]}.{m}")  # noqa: E731
    with torch_modes.case_time_limit(request, LIMIT_S):
        yield types.SimpleNamespace(
            name=request.param, gsh=mod("core.gcs_shards"), gcs=mod("core.gcs"),
            hb=mod("core.heartbeat"), exc=mod("exceptions"), pubsub=mod("utils.pubsub"),
            imet=mod("utils.internal_metrics"))


def _service(p, tmp_path, shards=4, tag="gcs"):
    return p.gcs.GcsService(snapshot_path=str(tmp_path / f"{tag}.snapshot"),
                            session_dir=str(tmp_path), shards=shards)


def _node_id_on_shard(p, shard: int, nshards: int, salt: str = "") -> str:
    """A synthetic node id that hashes onto `shard` (the fence cases must
    reach every shard, not whichever crc32 happens to pick)."""
    for i in range(10_000):
        nid = f"node-{salt}{i:05d}" + "0" * 16
        if p.gsh.shard_index(nid, nshards) == shard:
            return nid
    raise AssertionError("no id found for shard")


def _register(svc, nid, cpus=4.0):
    return svc.register_node(nid, f"/tmp/{nid}.sock", f"/tmp/{nid}.store", {"CPU": cpus}, {})


# ---------------------------------------------------------------- routing
def test_shard_index_deterministic_and_spread(p):
    n = 8
    ids = [f"node-{i:04d}" for i in range(400)]
    first = [p.gsh.shard_index(i, n) for i in ids]
    assert first == [p.gsh.shard_index(i, n) for i in ids]
    assert all(0 <= s < n for s in first)
    hit = {s: first.count(s) for s in range(n)}
    assert all(hit[s] > 0 for s in range(n))
    assert max(hit.values()) < 400 // 2
    # The same key lands on the same shard in both packages, at any count.
    from ray_tpu.core import gcs_shards as jgsh

    for count in (1, 2, 3, 8, 64):
        assert [p.gsh.shard_index(i, count) for i in ids] == [jgsh.shard_index(i, count)
                                                             for i in ids]


def test_resolve_shard_count_clamps(p, monkeypatch):
    assert p.gsh.resolve_shard_count(3) == 3
    assert p.gsh.resolve_shard_count(0) == 1
    assert p.gsh.resolve_shard_count(10_000) == p.gsh.MAX_SHARDS == 64
    monkeypatch.setenv("RAY_TPU_GCS_SHARDS", "5")
    assert p.gsh.resolve_shard_count(None) == 5
    monkeypatch.setenv("RAY_TPU_GCS_SHARDS", "junk")
    assert p.gsh.resolve_shard_count(None) >= 1  # falls back to the config


# ------------------------------------------------------------ log format
def test_wal_records_roundtrip_and_torn_tail(p):
    recs = [("_nodes", f"n{i}", {"epoch": i}) for i in range(20)]
    blob = b"".join(p.gsh.encode_wal_record(t, k, v) for t, k, v in recs)
    assert list(p.gsh.iter_wal_records(blob)) == recs
    # A crash mid-write leaves a torn tail: every strict prefix yields the
    # records whose bytes fully landed, and never raises.
    for cut in range(len(blob)):
        got = list(p.gsh.iter_wal_records(blob[:cut]))
        assert got == recs[:len(got)]
        assert len(got) <= 20


# ---------------------------------------------------- replay (property)
def test_wal_replay_matches_model_across_restart(p, tmp_path):
    """A seeded mix of single and batched registrations and re-registrations
    against a model; a crash (stop() saves no snapshot) and a reboot give
    the model's epochs, each record on its key's shard."""
    rng = random.Random(1234)
    svc = _service(p, tmp_path)
    model = {}
    try:
        pool = [f"replay-{i:03d}" + "0" * 12 for i in range(60)]
        for _ in range(30):
            if rng.random() < 0.5:
                batch = rng.sample(pool, rng.randint(1, 8))
                out = svc.register_nodes([
                    {"node_id": n, "sock": f"/t/{n}", "store": f"/s/{n}",
                     "resources": {"CPU": 2.0}, "labels": {}} for n in batch])
                for n, r in zip(batch, out):
                    assert r["ok"]
                    model[n] = r["epoch"]
            else:
                n = rng.choice(pool)
                r = _register(svc, n)
                assert r["ok"]
                model[n] = r["epoch"]
    finally:
        svc.stop()

    svc2 = _service(p, tmp_path)
    try:
        seen = {}
        for sh in svc2._shards:
            for nid, rec in sh.nodes.items():
                seen[nid] = rec["epoch"]
                assert svc2._shards[p.gsh.shard_index(nid, 4)] is sh, (
                    f"{nid} replayed onto the wrong shard")
        assert seen == model
        victim = max(model, key=model.get)
        assert _register(svc2, victim)["epoch"] == model[victim] + 1
    finally:
        svc2.stop()


def test_wal_replay_tolerates_mid_batch_torn_tail(p, tmp_path):
    """A crash mid group commit: a shard segment ending in half a record
    replays its intact prefix, and the other shards' segments are whole."""
    svc = _service(p, tmp_path)
    nids = [_node_id_on_shard(p, s, 4, salt="torn") for s in range(4)]
    try:
        for n in nids:
            assert _register(svc, n)["ok"]
    finally:
        svc.stop()
    seg = p.gsh.wal_segment_path(str(tmp_path / "gcs.snapshot"), 2)
    full = p.gsh.encode_wal_record("_nodes", nids[2], {"garbage": True})
    with open(seg, "ab") as f:
        f.write(full[:len(full) // 2])

    svc2 = _service(p, tmp_path)
    try:
        for s, n in enumerate(nids):
            rec = svc2._shards[s].nodes.get(n)
            assert rec is not None, f"shard {s} lost its node to a torn tail"
            assert "garbage" not in rec
    finally:
        svc2.stop()


def test_wal_replay_reroutes_on_shard_count_change(p, tmp_path):
    """State written at 4 shards boots at 2: replay routes by table and key
    under the current count."""
    svc = _service(p, tmp_path, shards=4)
    nids = [f"retune-{i:03d}" + "0" * 10 for i in range(20)]
    try:
        for n in nids:
            assert _register(svc, n)["ok"]
    finally:
        svc.stop()
    svc2 = _service(p, tmp_path, shards=2)
    try:
        assert svc2._alive_nodes() == 20
        for n in nids:
            assert n in svc2._shards[p.gsh.shard_index(n, 2)].nodes
    finally:
        svc2.stop()


# ------------------------------------------------------------- fencing
def test_epoch_fence_rejects_on_every_shard(p, tmp_path):
    """A stale-epoch heartbeat is rejected whichever shard owns the node."""
    svc = _service(p, tmp_path)
    try:
        for s in range(4):
            nid = _node_id_on_shard(p, s, 4, salt="fence")
            old = _register(svc, nid)["epoch"]
            new = _register(svc, nid)["epoch"]
            assert new == old + 1
            with pytest.raises(p.exc.StaleNodeEpochError):
                svc.heartbeat(nid, {"CPU": 1.0}, {"full": True}, old)
            assert svc.heartbeat(nid, {"CPU": 1.0}, {"full": True}, new)["ok"]
    finally:
        svc.stop()


def test_fence_survives_restart_via_shard_wal(p, tmp_path):
    """The epoch record lives in the node's shard segment: a rebooted GCS
    still fences the old incarnation."""
    nid = _node_id_on_shard(p, 3, 4, salt="fwal")
    svc = _service(p, tmp_path)
    try:
        old = _register(svc, nid)["epoch"]
        new = _register(svc, nid)["epoch"]
    finally:
        svc.stop()
    svc2 = _service(p, tmp_path)
    try:
        with pytest.raises(p.exc.StaleNodeEpochError):
            svc2.heartbeat(nid, {"CPU": 1.0}, {"full": True}, old)
        assert svc2.heartbeat(nid, {"CPU": 1.0}, {"full": True}, new)["ok"]
    finally:
        svc2.stop()


# ------------------------------------------------------- batched commits
def test_register_nodes_batch_all_land(p, tmp_path):
    svc = _service(p, tmp_path)
    try:
        specs = [{"node_id": f"batch-{i:03d}" + "0" * 10, "sock": f"/t/{i}",
                  "store": f"/s/{i}", "resources": {"CPU": 1.0}, "labels": {}}
                 for i in range(50)]
        out = svc.register_nodes(specs)
        assert len(out) == 50 and all(r["ok"] for r in out)
        assert svc._alive_nodes() == 50
        assert sum(sh.alive_count for sh in svc._shards) == 50
    finally:
        svc.stop()


def test_actor_records_shard_and_survive_restart(p, tmp_path):
    svc = _service(p, tmp_path)
    aids = [f"actor-{i:04d}" + "0" * 24 for i in range(12)]
    try:
        _register(svc, "anode-000" + "0" * 16, cpus=32.0)
        for aid in aids:
            r = svc.register_actor(aid, b"spec", {"CPU": 1.0}, 0, f"named-{aid[:10]}", "default")
            assert r["node_id"]
            svc.actor_started(aid, r["node_id"])
        for aid in aids:
            assert svc.get_actor(aid)["state"] == "ALIVE"
    finally:
        svc.stop()
    svc2 = _service(p, tmp_path)
    try:
        for aid in aids:
            assert aid in svc2._shards[p.gsh.shard_index(aid, 4)].actors
            assert svc2.get_actor(aid) is not None
    finally:
        svc2.stop()


# ------------------------------------------------------- delta pubsub
def test_pubsub_poll2_entries_and_gap(p, tmp_path):
    svc = _service(p, tmp_path, shards=2)
    try:
        for i in range(5):
            svc.pubsub_publish("chan", {"i": i})
        r = svc.pubsub_poll2("chan", 0, 0.0)
        assert not r["gap"]
        assert [m["i"] for _, m in r["entries"]] == [0, 1, 2, 3, 4]
        assert svc.pubsub_poll2("chan", 5, 0.0) == {"entries": [], "gap": False}
        for i in range(svc._PUBSUB_RETAIN + 10):
            svc.pubsub_publish("chan", {"i": 5 + i})
        assert svc.pubsub_poll2("chan", 2, 10.0)["gap"]  # at once, no long poll
    finally:
        svc.stop()


def test_node_table_snapshot_then_deltas(p, tmp_path):
    """The resync contract: the snapshot's seq plus the deltas after it
    converge on the live table (upserts are idempotent)."""
    svc = _service(p, tmp_path)
    try:
        nids = [f"snapd-{i:03d}" + "0" * 12 for i in range(20)]
        for n in nids:
            _register(svc, n)
        snap = svc.node_table_snapshot()
        assert len(snap["nodes"]) == 20
        rows = {r["NodeID"]: r for r in snap["nodes"]}
        sample = snap["nodes"][0]
        assert {"NodeID", "Alive", "Epoch", "State"} <= set(sample)
        assert "Available" not in sample and "Stats" not in sample
        bumped = nids[7]
        _register(svc, bumped)
        r = svc.pubsub_poll2("node_table", snap["seq"], 2.0)
        assert not r["gap"] and r["entries"]
        for _, row in r["entries"]:
            rows[row["NodeID"]] = row
        assert rows[bumped]["Epoch"] == 2
    finally:
        svc.stop()


class _Shim:
    """In-process stand-in for the GCS RpcClient (the same .call)."""

    def __init__(self, svc):
        self._svc = svc

    def call(self, method, *args, timeout=None):
        return getattr(self._svc, method)(*args)


def test_node_table_mirror_applies_and_resyncs(p, tmp_path):
    svc = _service(p, tmp_path)
    try:
        nids = [f"mirr-{i:03d}" + "0" * 12 for i in range(10)]
        for n in nids:
            _register(svc, n)
        m = p.pubsub.NodeTableMirror(_Shim(svc))
        assert m.alive() == set(nids)
        late = "mirr-late" + "0" * 12
        _register(svc, late)
        m.poll(timeout=2.0)
        assert late in m.alive()
        before = m.resyncs
        m.seq = 0
        for _ in range(svc._PUBSUB_RETAIN + 5):
            svc.pubsub_publish("node_table", {"NodeID": "noise", "Alive": False})
        m.poll(timeout=2.0)
        assert m.resyncs == before + 1
        assert late in m.alive() and set(nids) <= m.alive()
    finally:
        svc.stop()


# -------------------------------------------------- heartbeat delta codec
def test_heartbeat_codec_full_then_deltas(p):
    c = p.hb.HeartbeatCodec()
    avail = {"CPU": 4.0}
    stats = {"bytes_in_use": 100, "num_workers": 2, "wall_ts": 1.0}
    a1, s1 = c.encode(dict(avail), dict(stats))
    assert a1 == avail and s1.get("full") is True
    a2, s2 = c.encode(dict(avail), {**stats, "wall_ts": 2.0})
    assert a2 is None and "full" not in s2
    assert set(s2) == set(p.hb.ALWAYS_KEYS)
    a3, s3 = c.encode(dict(avail), {**stats, "wall_ts": 3.0, "num_workers": 5})
    assert a3 is None and s3["num_workers"] == 5
    assert set(s3) == {"num_workers", *p.hb.ALWAYS_KEYS}
    c.force_full()
    a4, s4 = c.encode(dict(avail), {**stats, "wall_ts": 4.0})
    assert a4 == avail and s4.get("full") is True


def test_heartbeat_codec_key_removal_rides_the_full_beat(p):
    c = p.hb.HeartbeatCodec()
    rec = {"available": {}, "stats": {}}
    _, s1 = c.encode({"CPU": 1.0}, {"a": 1, "b": 2, "wall_ts": 1.0})
    p.hb.apply_heartbeat(rec, {"CPU": 1.0}, dict(s1))
    assert rec["stats"]["b"] == 2
    _, s2 = c.encode({"CPU": 1.0}, {"a": 1, "wall_ts": 2.0})
    p.hb.apply_heartbeat(rec, None, dict(s2))
    assert rec["stats"]["b"] == 2  # lingers between fulls, by design
    c.force_full()
    a3, s3 = c.encode({"CPU": 1.0}, {"a": 1, "wall_ts": 3.0})
    p.hb.apply_heartbeat(rec, a3, dict(s3))
    assert "b" not in rec["stats"]
    assert rec["stats"]["a"] == 1
    assert rec["available"] == {"CPU": 1.0}


def test_apply_heartbeat_full_replaces(p):
    rec = {"available": {"CPU": 1.0}, "stats": {"stale": 99, "wall_ts": 1.0}}
    p.hb.apply_heartbeat(rec, {"CPU": 2.0}, {"full": True, "fresh": 1, "wall_ts": 2.0})
    assert rec["stats"] == {"fresh": 1, "wall_ts": 2.0}
    assert rec["available"] == {"CPU": 2.0}


# ------------------------------------------------- at-scale read paths
def test_list_nodes_limit_and_node_summary(p, tmp_path):
    svc = _service(p, tmp_path)
    try:
        for i in range(30):
            _register(svc, f"reads-{i:03d}" + "0" * 12, cpus=2.0)
        assert len(svc.list_nodes()) == 30
        lim = svc.list_nodes(5)
        assert len(lim) == 5
        assert lim == sorted(lim, key=lambda n: n["NodeID"])
        s = svc.node_summary()
        assert s["total"] == 30 and s["alive"] == 30
        assert s["resources"]["CPU"] == 60.0
        assert s["by_state"].get("ALIVE") == 30
    finally:
        svc.stop()


def test_shard_metrics_in_catalog(p):
    names = set(p.imet._registry)
    assert "raytpu_gcs_shard_lock_wait_ms" in names
    assert "raytpu_pubsub_deltas_total" in names
    assert "raytpu_pubsub_resyncs_total" in names


def test_concurrent_cross_shard_batches_consistent(p, tmp_path):
    """register_nodes from several threads with overlapping batches: every
    node ends at an epoch equal to the times it was registered, and the
    shards' alive counters agree with the tables."""
    svc = _service(p, tmp_path)
    nids = [f"conc-{i:03d}" + "0" * 12 for i in range(40)]
    errors = []

    def storm(seed):
        rng = random.Random(seed)
        try:
            for _ in range(10):
                batch = rng.sample(nids, 10)
                out = svc.register_nodes([{"node_id": n, "sock": "/t", "store": "/s",
                                           "resources": {"CPU": 1.0}, "labels": {}}
                                          for n in batch])
                assert all(r["ok"] for r in out)
        except Exception as e:  # noqa: BLE001 - surfaced through errors
            errors.append(e)

    try:
        threads = [threading.Thread(target=storm, args=(s,)) for s in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errors
        assert sum(sh.nodes[n]["epoch"] for sh in svc._shards for n in sh.nodes) == 6 * 10 * 10
        assert svc._alive_nodes() == len(nids)
        assert sum(sh.alive_count for sh in svc._shards) == len(nids)
    finally:
        svc.stop()


# ------------------------------------------- a single-file GCS's log
def _single_file_log(p, path):
    """The records, in order, that the single-file GCS appended to its one
    `<snapshot>.wal` for: three nodes registered (node-b twice), a named
    actor and an unnamed one registered and started, a KV put, a KV put
    then deleted, and a placement group."""
    recs = []

    def reg(nid, epoch):
        rec = {"sock": f"/t/{nid}", "store": f"/s/{nid}", "resources": {"CPU": 4.0},
               "available": {"CPU": 4.0}, "labels": {"zone": nid[-1]}, "alive": True,
               "epoch": epoch, "last_hb": 0.0}
        recs.extend([("_node_epochs", nid, epoch), ("_nodes", nid, rec)])

    def actor(aid, name, state):
        recs.append(("_actors", aid, {
            "state": state, "node_id": "node-a", "spec_blob": b"spec", "resources": {"CPU": 1.0},
            "max_restarts": 0, "num_restarts": 0, "pg_id": None, "bundle_index": -1,
            "strategy": "DEFAULT", "name": name, "namespace": "default", "death_reason": ""}))

    reg("node-a", 1)
    reg("node-b", 1)
    reg("node-b", 2)
    reg("node-c", 1)
    recs.append(("_named", ("default", "keeper"), "actor-1"))
    actor("actor-1", "keeper", "PENDING")
    actor("actor-2", None, "PENDING")
    actor("actor-1", "keeper", "ALIVE")
    actor("actor-2", None, "ALIVE")
    recs.append(("_kv", "k1", b"v1"))
    recs.append(("_kv", "k2", b"v2"))
    recs.append(("_kv", "k2", None))
    recs.append(("_pgs", "pg-1", {"bundles": [{"CPU": 1.0}], "strategy": "PACK",
                                   "placements": ["node-a"], "state": "CREATED", "rr": 0}))
    with open(path, "wb") as f:
        f.write(b"".join(p.gsh.encode_wal_record(*r) for r in recs))


@pytest.mark.parametrize("shards", [1, 4])
def test_single_file_log_replays_into_the_sharded_gcs(p, tmp_path, shards):
    """A crash of the single-file GCS left its snapshot-less `.wal`: the
    sharded GCS started on the same path gets every epoch, label, actor,
    name, KV entry and placement group back and fences the old epoch; its
    boot folds the log into its snapshot (every segment empty), and a
    second boot from that snapshot alone gets the same."""
    snap = str(tmp_path / "gcs.snapshot")
    _single_file_log(p, snap + ".wal")
    for boot in ("from the log", "from the snapshot"):
        svc = _service(p, tmp_path, shards=shards)
        try:
            epochs = {nid: rec["epoch"] for sh in svc._shards for nid, rec in sh.nodes.items()}
            assert epochs == {"node-a": 1, "node-b": 2, "node-c": 1}, boot
            for nid in epochs:
                rec = svc._shards[p.gsh.shard_index(nid, shards)].nodes[nid]
                assert rec["labels"] == {"zone": nid[-1]}, boot
            assert svc._alive_nodes() == 3
            assert svc.get_actor("actor-1")["state"] == "ALIVE"
            assert svc.get_actor("actor-2")["state"] == "ALIVE"
            assert svc.lookup_named_actor("keeper", "default") == "actor-1"
            assert svc.kv_get("k1") == b"v1" and svc.kv_get("k2") is None
            assert svc.get_placement_group("pg-1")["placements"] == ["node-a"]
            with pytest.raises(p.exc.StaleNodeEpochError):
                svc.heartbeat("node-b", {"CPU": 1.0}, {"full": True}, 1)
            assert svc.heartbeat("node-b", {"CPU": 1.0}, {"full": True}, 2)["ok"]
        finally:
            svc.stop()
        assert all(os.path.getsize(path) == 0 for path in p.gsh.discover_wal_paths(snap)), boot
