"""GCS persistence and restart, the port against the JAX package: each case of
tests/test_gcs_restart.py runs on both packages with the same assertions.

  - A cluster whose GCS is killed and started again keeps its actors (an old
    handle still calls its actor), its named actors and its KV; new tasks
    flow and the node table fills again; with the snapshot pushed out to an
    hour, the write-ahead log alone brings the KV and a named actor back.
  - The log's record codec round-trips and tolerates a torn tail; a seeded
    mix of single and batched registrations replays to a model's epochs
    after a crash; a torn half record at the end of a shard's log segment
    leaves every node whole; a fence survives a restart; actor records
    survive one.

Both GCSes split nodes, actors and objects into key-hashed shards with a log
segment each (core/gcs_shards.py); the in-process cases here run both at the
JAX file's shard count. tests/test_torch_gcs_shards.py runs the rest of
tests/test_gcs_shards.py's cases on both packages, and a log written by the
single-file GCS replaying into the sharded one.

Every case runs under its own time limit (torch_modes.case_time_limit).
"""

import importlib
import random
import sys
import time
import types

import pytest

from ray_tpu_torch.core import serialization
import torch_modes

serialization.register_pickle_by_value(sys.modules[__name__])

PKGS = ("jax", "torch")
ROOT = {"jax": "ray_tpu", "torch": "ray_tpu_torch"}
UNIT_LIMIT_S = 60
CLUSTER_LIMIT_S = 300
SHARDS = 4  # tests/test_gcs_shards.py's shard count


def _pkg(name):
    mod = lambda m: importlib.import_module(f"{ROOT[name]}.{m}")  # noqa: E731
    return types.SimpleNamespace(
        name=name, rt=importlib.import_module(ROOT[name]), gcs=mod("core.gcs"),
        exc=mod("exceptions"), base=mod("core.runtime_base"),
        cluster_mod=mod("core.cluster_runtime"))


@pytest.fixture(params=PKGS)
def p(request):
    return _pkg(request.param)


@pytest.fixture
def unit_limit(request):
    with torch_modes.case_time_limit(request, UNIT_LIMIT_S):
        yield


# ------------------------------------------------------------ in process
def _service(p, tmp_path, tag="gcs"):
    """A GcsService persisting under tmp_path, at the JAX file's shard count."""
    return p.gcs.GcsService(snapshot_path=str(tmp_path / f"{tag}.snapshot"),
                            session_dir=str(tmp_path), shards=SHARDS)


def _node_tables(svc):
    """[(node records, actor records)] per shard."""
    return [(sh.nodes, sh.actors) for sh in svc._shards]


def _shards_mod(p):
    return importlib.import_module(f"{ROOT[p.name]}.core.gcs_shards")


def _wal_codec(p):
    return _shards_mod(p).encode_wal_record, _shards_mod(p).iter_wal_records


def _register(svc, nid, cpus=4.0):
    return svc.register_node(nid, f"/tmp/{nid}.sock", f"/tmp/{nid}.store", {"CPU": cpus}, {})


def _register_batch(svc, batch):
    """One batched registration (register_nodes)."""
    return svc.register_nodes([{"node_id": n, "sock": f"/t/{n}", "store": f"/s/{n}",
                                "resources": {"CPU": 2.0}, "labels": {}} for n in batch])


def test_wal_records_roundtrip_and_torn_tail(p, unit_limit):
    encode, iterate = _wal_codec(p)
    recs = [("_nodes", f"n{i}", {"epoch": i}) for i in range(20)]
    blob = b"".join(encode(t, k, v) for t, k, v in recs)
    assert list(iterate(blob)) == recs
    # A crash mid-write leaves a torn tail: every strict prefix yields the
    # records whose bytes fully landed and never raises.
    for cut in range(len(blob)):
        got = list(iterate(blob[:cut]))
        assert got == recs[:len(got)]
    # One format: each package reads the other's log.
    other = "torch" if p.name == "jax" else "jax"
    assert list(_wal_codec(_pkg(other))[1](blob)) == recs


def test_wal_replay_matches_model_across_restart(p, tmp_path, unit_limit):
    """A seeded mix of single and batched registrations and re-registrations
    against a model; a GCS rebuilt on the same path (stop() saves no
    snapshot) reproduces the model's epochs, and the next registration of
    any node advances past its persisted epoch."""
    rng = random.Random(1234)
    svc = _service(p, tmp_path)
    model = {}
    try:
        pool = [f"replay-{i:03d}" + "0" * 12 for i in range(60)]
        for _ in range(30):
            if rng.random() < 0.5:
                batch = rng.sample(pool, rng.randint(1, 8))
                for n, r in zip(batch, _register_batch(svc, batch)):
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
        seen = {nid: rec["epoch"] for nodes, _ in _node_tables(svc2) for nid, rec in nodes.items()}
        assert seen == model
        victim = max(model, key=model.get)
        assert _register(svc2, victim)["epoch"] == model[victim] + 1
    finally:
        svc2.stop()


def _log_path(p, tmp_path, nid):
    """The log segment that holds `nid`'s records: its shard's."""
    gsh = _shards_mod(p)
    return gsh.wal_segment_path(str(tmp_path / "gcs.snapshot"), gsh.shard_index(nid, SHARDS))


def test_wal_replay_tolerates_mid_batch_torn_tail(p, tmp_path, unit_limit):
    """A crash mid-append leaves half a record at the end of the log: the
    intact prefix replays and no node is lost or overwritten."""
    encode, _ = _wal_codec(p)
    svc = _service(p, tmp_path)
    nids = [f"torn-{i:05d}" + "0" * 16 for i in range(4)]
    try:
        for n in nids:
            assert _register(svc, n)["ok"]
    finally:
        svc.stop()
    full = encode("_nodes", nids[2], {"garbage": True})
    with open(_log_path(p, tmp_path, nids[2]), "ab") as f:
        f.write(full[:len(full) // 2])

    svc2 = _service(p, tmp_path)
    try:
        nodes = {nid: rec for ns, _ in _node_tables(svc2) for nid, rec in ns.items()}
        for n in nids:
            assert n in nodes, f"{n} lost to a torn tail"
            assert "garbage" not in nodes[n]
    finally:
        svc2.stop()


def test_fence_survives_restart_via_wal(p, tmp_path, unit_limit):
    """The node's epoch record is in the log: a rebooted GCS still fences
    the old incarnation and takes the current one's beats."""
    nid = "fwal-00003" + "0" * 16
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


def test_actor_records_survive_restart(p, tmp_path, unit_limit):
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
        actors = {aid for _, acts in _node_tables(svc2) for aid in acts}
        for aid in aids:
            assert aid in actors
            assert svc2.get_actor(aid)["state"] == "ALIVE"
            assert svc2.lookup_named_actor(f"named-{aid[:10]}", "default") == aid
    finally:
        svc2.stop()


# ------------------------------------------------------- cluster restarts
@pytest.fixture
def cluster(p, request):
    with torch_modes.case_time_limit(request, CLUSTER_LIMIT_S):
        p.rt.shutdown()
        if p.name == "jax":
            c = torch_modes.boot_jax_cluster(num_cpus=4)
        else:
            c = p.cluster_mod.Cluster(num_cpus=4, num_gpus=0)
        runtime = c.runtime()
        p.base.set_runtime(runtime)
        try:
            yield c, runtime
        finally:
            try:
                runtime.shutdown()
            finally:
                c.shutdown()
                p.base.set_runtime(None)


def _counter_class():
    class Counter:
        def __init__(self):
            self.n = 0

        def incr(self):
            self.n += 1
            return self.n

    return Counter


def test_gcs_restart_preserves_actors_and_kv(p, cluster):
    c, runtime = cluster
    rt = p.rt
    a = rt.remote(_counter_class()).options(name="survivor").remote()
    assert rt.get(a.incr.remote(), timeout=60) == 1
    runtime._gcs.call("kv_put", "mykey", b"myvalue")
    time.sleep(1.5)  # a snapshot interval passes

    c.restart_gcs()

    # The old handle still works (the actor's process never died).
    assert rt.get(a.incr.remote(), timeout=60) == 2
    b = rt.get_actor("survivor")
    assert rt.get(b.incr.remote(), timeout=60) == 3
    assert runtime._gcs.call("kv_get", "mykey") == b"myvalue"


def test_gcs_restart_tasks_still_flow(p, cluster):
    c, runtime = cluster
    rt = p.rt

    def double(x):  # made here, so the JAX package sends it by value
        return x * 2

    f = rt.remote(double)
    assert rt.get(f.remote(4), timeout=60) == 8
    time.sleep(1.2)
    c.restart_gcs()
    assert rt.get(f.remote(5), timeout=60) == 10
    deadline = time.monotonic() + 15
    while time.monotonic() < deadline and not any(n["Alive"] for n in runtime.nodes()):
        time.sleep(0.3)
    assert any(n["Alive"] for n in runtime.nodes())


def _keeper_class():
    class Keeper:
        def ping(self):
            return "pong"

    return Keeper


def test_wal_preserves_mutations_between_snapshots(p, monkeypatch, request):
    """With the snapshot pushed out to an hour, the write-ahead log alone
    brings a KV entry and a named actor back after the GCS is killed."""
    monkeypatch.setenv("RAY_TPU_GCS_SNAPSHOT_INTERVAL_S", "3600")
    with torch_modes.case_time_limit(request, CLUSTER_LIMIT_S):
        p.rt.shutdown()
        if p.name == "jax":
            c = torch_modes.boot_jax_cluster(num_cpus=2)
        else:
            c = p.cluster_mod.Cluster(num_cpus=2, num_gpus=0)
        runtime = c.runtime()
        p.base.set_runtime(runtime)
        rt = p.rt
        try:
            runtime._gcs.call("kv_put", "wal-test-key", b"survives")
            k = rt.remote(_keeper_class()).options(name="wal_keeper").remote()
            assert rt.get(k.ping.remote(), timeout=60) == "pong"

            c.restart_gcs()
            assert runtime._gcs.call("kv_get", "wal-test-key") == b"survives"
            k2 = rt.get_actor("wal_keeper")
            assert rt.get(k2.ping.remote(), timeout=60) == "pong"
        finally:
            try:
                runtime.shutdown()
            finally:
                c.shutdown()
                p.base.set_runtime(None)


def test_gcs_restart_keeps_its_tcp_address(p, monkeypatch, request):
    """A head that other hosts joined over TCP: the restarted GCS comes back on
    the address it announced (the port is pinned in its command), so a client
    of that address carries on, and the KV written before the kill is there."""
    monkeypatch.setenv("RAY_TPU_AUTH_TOKEN", "restart-token")
    with torch_modes.case_time_limit(request, CLUSTER_LIMIT_S):
        p.rt.shutdown()
        if p.name == "jax":
            c = torch_modes.boot_jax_cluster(num_cpus=1, head_port=0)
        else:
            c = p.cluster_mod.Cluster(num_cpus=1, num_gpus=0, head_port=0)
        rpc = importlib.import_module(f"{ROOT[p.name]}.core.rpc")
        try:
            address = c.gcs_tcp_address
            remote = rpc.RpcClient(address)
            remote.call("kv_put", "tcp-key", b"kept")
            c.restart_gcs()
            assert c.gcs_tcp_address == address
            assert remote.call("kv_get", "tcp-key") == b"kept"
            assert rpc.RpcClient(address).call("ping") == "pong"
        finally:
            c.shutdown()
