"""Partition-tolerant membership, the port against the JAX package: each case
of tests/test_partition.py runs on both packages with the same scenario and
the same assertions.

  (a) the fencing units on an in-process GcsService: a heartbeat from a
      dead-marked node is fenced with StaleNodeEpochError and never flips
      it back alive in place; stale-epoch mutations are rejected the same
      way; the error keeps its fields through pickling;
  (b) the net.* chaos points (a net.call drop rule, a net.connect drop
      that uses up its own deadline), the partition module's specs
      (stacking, self-heal deadlines) and the partition API's validation;
  (c) the acceptance e2e: a node holding a named actor is cut off from the
      GCS while a client keeps calling the actor; the node is declared dead
      and the actor rescheduled; on heal the zombie is fenced, its workers
      die and it rejoins with the next epoch; the exactly-once audit and
      `raytpu_nodes_fenced_total` hold. The JAX case orders the flight
      ring's records; the port has no flight dumps (ROADMAP Queue 1 item
      10), so both packages are held to the same order read from the GCS's
      `node_events` log: node_dead < node_fenced < node_added for the
      victim, after the partition's install;
  (d) a collective op stalled mid-op by a `coll.op` delay fails with
      CollectiveTimeoutError naming the stalled rank, not a hang;
  (e) the port's seeded membership soak (ray_tpu_torch/chaos/soak.py, the
      port of tools/chaos_soak.py), bounded to 25 s: the exactly-once and
      singleton invariants through partition, heal, kill and preempt events.
      It runs on the port only: test_partition.py runs the JAX tool.

test_partition.py's cgraph case is in tests/test_torch_cgraph.py.

Each cluster case boots its own cluster (the daemons read the heartbeat
settings at start) and runs under its own time limit
(torch_modes.case_time_limit): a hang of either package's runtime fails that
case alone, with its stack, instead of holding its xdist worker.
"""

import importlib
import json
import os
import pickle
import sys
import threading
import time
import types
import uuid

import pytest

from ray_tpu_torch.core import serialization
import torch_modes

serialization.register_pickle_by_value(sys.modules[__name__])

PKGS = ("jax", "torch")
ROOT = {"jax": "ray_tpu", "torch": "ray_tpu_torch"}
UNIT_LIMIT_S = 60
CLUSTER_LIMIT_S = 300
SOAK_SEED = int(os.environ.get("RAY_TPU_CHAOS_SEED", "1030") or 1030)


def _pkg(name):
    mod = lambda m: importlib.import_module(f"{ROOT[name]}.{m}")  # noqa: E731
    return types.SimpleNamespace(
        name=name, rt=importlib.import_module(ROOT[name]), gcs=mod("core.gcs"),
        rpc=mod("core.rpc"), exc=mod("exceptions"), chaos=mod("chaos"), net=mod("chaos.net"),
        base=mod("core.runtime_base"), state=mod("utils.state"),
        cluster_mod=mod("core.cluster_runtime"))


@pytest.fixture(params=PKGS)
def p(request):
    return _pkg(request.param)


@pytest.fixture
def unit_limit(request):
    with torch_modes.case_time_limit(request, UNIT_LIMIT_S):
        yield


@pytest.fixture
def cluster_limit(request):
    with torch_modes.case_time_limit(request, CLUSTER_LIMIT_S):
        yield


def _wait_for(pred, timeout=20.0, interval=0.05):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return pred()


def _boot(p, **kwargs):
    """A fresh cluster of `p`'s package with its runtime current."""
    p.rt.shutdown()
    if p.name == "jax":
        cluster = torch_modes.boot_jax_cluster(**kwargs)
    else:
        cluster = p.cluster_mod.Cluster(num_gpus=0, **kwargs)
    runtime = cluster.runtime()
    p.base.set_runtime(runtime)
    return cluster, runtime


def _declare_dead(p, svc, node_id):
    """The GCS declares a node dead at once (JAX: drain_node, the port:
    mark_node_dead, its counterpart by design), as the heartbeat expiry
    does."""
    if p.name == "jax":
        svc.drain_node(node_id)
    else:
        svc.mark_node_dead(node_id)


def _teardown(p, cluster, runtime):
    try:
        runtime.shutdown()
    finally:
        cluster.shutdown()
        p.base.set_runtime(None)


# ================================ (a) fencing units (in-process GcsService)
def test_heartbeat_from_dead_node_fenced_not_resurrected(p, unit_limit):
    """A dead-marked node's heartbeat gets the typed fence error, the FENCED
    state and the counter bump, never a resurrection in place; only a fresh
    register_node (the next epoch) brings it back."""
    svc = p.gcs.GcsService()
    try:
        reg = svc.register_node("nodeA", "/tmp/nope.sock", "/tmp/nope", {"CPU": 2.0})
        assert reg["epoch"] == 1
        _declare_dead(p, svc, "nodeA")

        with pytest.raises(p.exc.StaleNodeEpochError) as ei:
            svc.heartbeat("nodeA", {"CPU": 2.0}, None, 1)
        assert ei.value.node_id == "nodeA"
        nodes = {n["NodeID"]: n for n in svc.list_nodes()}
        assert nodes["nodeA"]["Alive"] is False
        assert nodes["nodeA"]["Fenced"] is True
        assert nodes["nodeA"]["State"] == "FENCED"

        # A heartbeat without an epoch from a dead node: the same rejection.
        with pytest.raises(p.exc.StaleNodeEpochError):
            svc.heartbeat("nodeA", {"CPU": 2.0})

        reg2 = svc.register_node("nodeA", "/tmp/nope.sock", "/tmp/nope", {"CPU": 2.0})
        assert reg2["epoch"] == 2
        nodes = {n["NodeID"]: n for n in svc.list_nodes()}
        assert nodes["nodeA"]["State"] == "ALIVE" and nodes["nodeA"]["Epoch"] == 2

        # The old incarnation's epoch is fenced though the node id is alive.
        with pytest.raises(p.exc.StaleNodeEpochError):
            svc.heartbeat("nodeA", {"CPU": 2.0}, None, 1)
        assert svc.heartbeat("nodeA", {"CPU": 2.0}, None, 2)["ok"] is True
        events = [m["event"] for _, m in svc.pubsub_poll("node_events", 0, 0.0)]
        assert events.count("node_fenced") == 1
    finally:
        svc.stop()


def test_stale_epoch_rejected_on_mutation_rpcs(p, unit_limit):
    svc = p.gcs.GcsService()
    try:
        svc.register_node("nodeB", "/tmp/b.sock", "/tmp/b", {"CPU": 1.0})
        _declare_dead(p, svc, "nodeB")
        with pytest.raises(p.exc.StaleNodeEpochError):
            svc.node_sync("nodeB", ["ab" * 12], [], 1)
        with pytest.raises(p.exc.StaleNodeEpochError):
            svc.actor_started("actorX", "nodeB", 1)
        with pytest.raises(p.exc.StaleNodeEpochError):
            svc.remove_object_location("ab" * 12, "nodeB", 1)
        # The zombie's sealed objects never entered the directory.
        assert svc.get_object_locations("ab" * 12) == []
        # A caller that never registered (a driver) passes.
        assert svc.node_sync("never_registered", [], [], None) is True
    finally:
        svc.stop()


def test_stale_node_epoch_error_pickles_with_fields(p, unit_limit):
    err = p.exc.StaleNodeEpochError("n1", 3, 5, "heartbeat")
    back = pickle.loads(pickle.dumps(err))
    assert back.node_id == "n1" and back.claimed_epoch == 3
    assert back.current_epoch == 5 and isinstance(back, ConnectionError)


# ======================================= (b) net.* chaos + partition units
def test_net_call_drop_rule_typed_error(p, tmp_path, unit_limit):
    """A net.call drop rule black-holes one two-way call: RpcUnavailableError,
    no hang, while the server is alive; the next call flows."""
    svc = p.gcs.GcsService()
    server = p.rpc.RpcServer(str(tmp_path / "gcs.sock"), svc)
    try:
        cli = p.rpc.RpcClient(server.address)
        assert cli.call("ping") == "pong"
        p.chaos.configure([{"point": "net.call", "action": "drop", "match": "ping",
                            "times": 1}], seed=0)
        with pytest.raises(p.exc.RpcUnavailableError):
            cli.call("ping")
        assert cli.call("ping") == "pong"
    finally:
        p.chaos.disable()
        svc.stop()
        server.shutdown()


def test_net_connect_drop_burns_deadline(p, tmp_path, unit_limit):
    svc = p.gcs.GcsService()
    server = p.rpc.RpcServer(str(tmp_path / "gcs2.sock"), svc)
    try:
        p.chaos.configure([{"point": "net.connect", "action": "drop", "times": -1}], seed=0)
        t0 = time.monotonic()
        with pytest.raises(p.exc.RpcUnavailableError):
            p.rpc.RpcClient(server.address, connect_timeout=0.5)
        elapsed = time.monotonic() - t0
        assert 0.4 <= elapsed < 5.0  # used up its own deadline, no instant failure
    finally:
        p.chaos.disable()
        svc.stop()
        server.shutdown()


def test_partition_module_units(p, unit_limit):
    net = p.net
    assert not net.active()
    net.install(["raylet_abc"], heal_after=None, spec_id="t1")
    try:
        assert net.active()
        assert net.blocked_addr("/tmp/s/raylet_abc.sock") == "raylet_abc"
        assert net.blocked_addr("/tmp/s/raylet_xyz.sock") is None
    finally:
        assert net.heal("t1")
    assert not net.active()

    # The self-heal deadline: every process enforces its own clock.
    net.install(["raylet_abc"], heal_after=0.2, spec_id="t2")
    try:
        assert net.blocked_addr("raylet_abc") is not None
        time.sleep(0.3)
        assert net.blocked_addr("raylet_abc") is None
        assert not net.active()
    finally:
        net.heal("t2")

    # Specs stack, and each heals on its own.
    net.install(["raylet_one"], spec_id="o1")
    net.install(["raylet_two"], spec_id="o2")
    try:
        assert net.blocked_addr("raylet_one.sock") == "raylet_one"
        assert net.blocked_addr("raylet_two.sock") == "raylet_two"
        assert net.heal("o1")
        assert net.blocked_addr("raylet_one.sock") is None
        assert net.blocked_addr("raylet_two.sock") == "raylet_two"
    finally:
        net.heal()
    assert not net.active()


def test_partition_api_validation(p, unit_limit):
    p.rt.shutdown()
    with pytest.raises((ValueError, RuntimeError)):
        p.chaos.partition([["only_one_group"]])


# =========================================== (c) the acceptance e2e
def _counter_class(root):
    """The named counter actor, made in a function so both packages send it
    by value; `root` names the package whose GCS client it writes through."""

    class PartCounter:
        def incr(self, op_id):
            import os as _os
            import uuid as _uuid

            base = importlib.import_module(f"{root}.core.runtime_base")
            base.current_runtime()._gcs.call(
                "kv_put", f"partctr/{op_id}/{_os.getpid()}-{_uuid.uuid4().hex[:6]}", b"1")
            return True

        def whereami(self):
            import os as _os

            return _os.getpid()

    return PartCounter


def _node_events(gcs):
    return [(seq, m) for seq, m in gcs.call("pubsub_poll", "node_events", 0, 0.0)
            if isinstance(m, dict)]


def test_partition_acceptance_e2e(p, monkeypatch, cluster_limit):
    """Partition a node from the GCS for longer than the heartbeat timeout
    while its named actor keeps running: the GCS declares it dead and
    reschedules the actor; on heal the zombie's first call is fenced, its
    workers die, and it rejoins with the next epoch. Exactly one live
    instance after the heal, no acknowledged increment lost, none applied
    twice, none from nowhere; the node events in order."""
    monkeypatch.setenv("RAY_TPU_HEARTBEAT_INTERVAL_S", "0.25")
    monkeypatch.setenv("RAY_TPU_HEARTBEAT_TIMEOUT_S", "1.5")
    cluster, runtime = _boot(p, num_cpus=2)
    rt, state = p.rt, p.state
    stop = threading.Event()
    acked, errored = set(), set()
    t = None
    try:
        workers = [cluster.add_node(num_cpus=2, resources={"ctr": 1.0}) for _ in range(2)]
        gcs = runtime._gcs
        Counter = rt.remote(max_restarts=-1, resources={"ctr": 0.5})(_counter_class(ROOT[p.name]))
        counter = Counter.options(name="part_ctr").remote()
        zombie_pid = rt.get(counter.whereami.remote(), timeout=60)

        def actor_node():
            for a in state.list_actors():
                if a.get("name") == "part_ctr" and a["state"] == "ALIVE":
                    return a.get("node_id")
            return None

        victim = actor_node()
        assert victim in workers

        def client():
            while not stop.is_set():
                op = uuid.uuid4().hex[:12]
                try:
                    rt.get(counter.incr.remote(op), timeout=20)
                    acked.add(op)
                except Exception:  # noqa: BLE001 - counted as errored; the audit decides
                    errored.add(op)
                    time.sleep(0.2)
                time.sleep(0.03)

        t = threading.Thread(target=client, daemon=True)
        t.start()
        assert _wait_for(lambda: len(acked) >= 5, timeout=30)

        def node(nid):
            return {n["NodeID"]: n for n in gcs.call("list_nodes")}[nid]

        before = max([seq for seq, _ in _node_events(gcs)] or [0])
        part = p.chaos.partition([[victim], ["gcs"]], heal_after=60.0, runtime=runtime)
        assert _wait_for(lambda: not node(victim)["Alive"], timeout=20), (
            "partitioned node never declared dead")
        procs = getattr(cluster, "_node_procs", None) or cluster._procs
        os.kill(procs[victim].pid, 0)  # the zombie raylet still runs
        assert _wait_for(lambda: actor_node() not in (None, victim), timeout=30), (
            "named actor was not rescheduled off the dead node")

        old_epoch = node(victim)["Epoch"]
        part.heal()
        assert _wait_for(lambda: node(victim)["Alive"] and node(victim)["Epoch"] == old_epoch + 1,
                         timeout=30), f"no fresh-epoch rejoin: {node(victim)['State']}"
        assert _wait_for(lambda: not os.path.exists(f"/proc/{zombie_pid}"), timeout=20), (
            "zombie actor instance survived the fence")

        stop.set()
        t.join(timeout=60)
        alive_records = [a for a in state.list_actors()
                         if a.get("name") == "part_ctr" and a["state"] == "ALIVE"]
        assert len(alive_records) == 1, alive_records
        assert rt.get(counter.whereami.remote(), timeout=60) != zombie_pid

        applied = {}
        for key in gcs.call("kv_keys", "partctr/"):
            op = key[len("partctr/"):].split("/", 1)[0]
            applied[op] = applied.get(op, 0) + 1
        lost = [op for op in acked if applied.get(op, 0) == 0]
        duped = [op for op, n in applied.items() if n > 1]
        phantom = [op for op in applied if op not in acked | errored]
        assert not lost, f"acked increments lost: {lost[:5]}"
        assert not duped, f"increments double-applied: {duped[:5]}"
        assert not phantom, f"phantom increments: {phantom[:5]}"

        def fenced_total():
            return sum(m["value"] for m in state.internal_metrics()
                       if m["name"] == "raytpu_nodes_fenced_total")

        # The GCS flushes its own counters about once a second.
        assert _wait_for(lambda: fenced_total() >= 1, timeout=15)

        # The membership story of this partition, in the GCS's own order.
        seqs = {}
        for seq, m in _node_events(gcs):
            if m.get("node_id") == victim and seq > before:
                seqs.setdefault(m["event"], []).append(seq)
        for expected in ("node_dead", "node_fenced", "node_added"):
            assert expected in seqs, f"{expected} missing from {sorted(seqs)}"
        assert min(seqs["node_dead"]) < min(seqs["node_fenced"]) < max(seqs["node_added"])
    finally:
        stop.set()
        if t is not None:
            t.join(timeout=30)
        _teardown(p, cluster, runtime)


# ============================== (d) partition vs a collective op
def _member_class(root):
    class Member:
        def reduce(self, v):
            import numpy as _np

            coll = importlib.import_module(f"{root}.collective")
            exc = importlib.import_module(f"{root}.exceptions")
            try:
                return ("ok", float(coll.allreduce(_np.array([v]), "pgrp")[0]))
            except exc.CollectiveTimeoutError as e:
                return ("timeout", e.group, e.rank, list(e.missing))

        def ping(self):
            return True

    return Member


def test_collective_mid_op_partition_times_out_naming_ranks(p, monkeypatch, cluster_limit):
    """A one-way stall mid-op (rank 1's op delayed past the op deadline, as
    a one-way partition of the ring looks to rank 0) surfaces
    CollectiveTimeoutError naming the stalled rank, not a hang."""
    rules = [{"point": "coll.op", "action": "delay", "match": "allreduce:pgrp:1",
              "delay_s": 15.0, "times": 1}]
    monkeypatch.setenv("RAY_TPU_COLLECTIVE_TIMEOUT_S", "2.0")
    monkeypatch.setenv("RAY_TPU_COLLECTIVE_OP_TIMEOUT_S", "2.0")
    monkeypatch.setenv("RAY_TPU_CHAOS", json.dumps(rules))
    monkeypatch.setenv("RAY_TPU_CHAOS_SEED", "1030")
    cluster, runtime = _boot(p, num_cpus=4, num_workers=2)
    rt = p.rt
    try:
        coll = importlib.import_module(f"{ROOT[p.name]}.collective")
        Member = rt.remote(_member_class(ROOT[p.name]))
        members = [Member.remote() for _ in range(2)]
        rt.get([m.ping.remote() for m in members], timeout=60)
        coll.create_collective_group(members, "pgrp")
        t0 = time.monotonic()
        refs = [m.reduce.remote(float(i + 1)) for i, m in enumerate(members)]
        r0 = rt.get(refs[0], timeout=60)
        assert r0[0] == "timeout", f"rank 0 did not time out: {r0}"
        assert r0[1] == "pgrp" and r0[2] == 0 and 1 in r0[3]
        assert time.monotonic() - t0 < 12.0  # a typed error, not a hang
        try:
            rt.get(refs[1], timeout=60)  # drained: delayed, then its peer is gone
        except Exception:  # noqa: BLE001 - either outcome is fine here
            pass
    finally:
        _teardown(p, cluster, runtime)


# ===================================== (e) the port's bounded soak
def test_partition_soak_port(monkeypatch, cluster_limit):
    """A 25-second seeded membership soak on the port: partition, heal, kill
    and preempt events against a named counter and a task workload, with
    the exactly-once and singleton invariants held throughout.
    RAY_TPU_CHAOS_SEED pins the campaign; a failure prints its events."""
    from ray_tpu_torch.chaos.soak import run_soak

    # The campaign's settings, put back after the case.
    monkeypatch.setenv("RAY_TPU_HEARTBEAT_INTERVAL_S", "0.25")
    monkeypatch.setenv("RAY_TPU_HEARTBEAT_TIMEOUT_S", "1.5")
    monkeypatch.setenv("RAY_TPU_CHAOS_SEED", str(SOAK_SEED))
    importlib.import_module("ray_tpu_torch").shutdown()
    result = run_soak(SOAK_SEED, 25.0, nodes=2, event_period_s=1.5)
    assert result.ok, f"soak violations: {result.summary()}\n{result.events}"
    assert len(result.ops_acked) > 25, result.summary()
    assert result.task_rounds > 5, result.summary()
