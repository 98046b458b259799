"""The port's lock-order detector (ray_tpu_torch/utils/lock_order.py)
against the JAX package's (tests/test_lock_order.py's cases, each on both
packages): the same lock script gives the same violation reports and the
same order graph in both; an inversion reaches the flight recorder and
`raytpu_lock_order_violations_total`; reentrant and consistent use reports
nothing; disarmed factories give plain stdlib locks; the port's GCS, raylet
and Serve controller make their locks through the armed factory.
"""

import importlib
import threading
import time

import pytest

PKGS = ("ray_tpu", "ray_tpu_torch")
_SEEN = {}


@pytest.fixture(params=PKGS)
def lo(request, monkeypatch):
    monkeypatch.setenv("RAY_TPU_LOCK_ORDER", "1")
    mod = importlib.import_module(f"{request.param}.utils.lock_order")
    mod.reset()
    yield mod
    mod.reset()


def _agree(case, lo, seen):
    """The JAX package's case runs first (parametrize order); the port's
    result must equal it."""
    name = lo.__name__.split(".")[0]
    _SEEN.setdefault(case, {})[name] = seen
    if name == "ray_tpu_torch" and "ray_tpu" in _SEEN[case]:
        assert seen == _SEEN[case]["ray_tpu"], (case, seen, _SEEN[case]["ray_tpu"])


def _reports(lo):
    """Violations without what differs by run (thread ids, hold times)."""
    return [{k: v for k, v in sorted(r.items()) if k not in ("thread", "held_s")}
            for r in lo.violations()]


def _script(lo, tag):
    """One fixed script: a consistent pair, an AB/BA inversion on another
    thread, a reentrant RLock around a nested lock, a three-lock chain
    closed into a cycle."""
    a, b = lo.tracked_lock(f"{tag}.A"), lo.tracked_lock(f"{tag}.B")
    x, y = lo.tracked_lock(f"{tag}.X"), lo.tracked_lock(f"{tag}.Y")
    r = lo.tracked_rlock(f"{tag}.R")
    for _ in range(3):
        with x:
            with y:
                pass
    with a:
        with b:
            pass

    def inverted():
        with b:
            with a:
                pass

    t = threading.Thread(target=inverted)
    t.start()
    t.join(timeout=10)
    with r:
        with r:
            with x:
                pass
    p, q, s = (lo.tracked_lock(f"{tag}.{n}") for n in "PQS")
    with p:
        with q:
            pass
    with q:
        with s:
            pass
    with s:
        with p:
            pass


def test_same_script_same_reports_and_graph(lo):
    _script(lo, "test")
    reports, graph = _reports(lo), lo.order_graph()
    assert [r["kind"] for r in reports] == ["cycle", "cycle"]
    assert reports[0]["acquiring"] == "test.A" and reports[0]["while_holding"] == "test.B"
    assert reports[0]["established_order"] == "test.A->test.B"
    assert reports[1]["established_order"] == "test.P->test.Q->test.S"
    _agree("script", lo, (reports, graph))


def test_ab_ba_inversion_detected(lo):
    a, b = lo.tracked_lock("test.A"), lo.tracked_lock("test.B")
    with a:
        with b:
            pass

    def inverted():
        with b:
            with a:
                pass

    t = threading.Thread(target=inverted)
    t.start()
    t.join(timeout=10)
    v = next(v for v in lo.violations() if v["kind"] == "cycle")
    assert v["acquiring"] == "test.A" and v["while_holding"] == "test.B"
    assert "test.A->test.B" in v["established_order"]
    _agree("ab_ba", lo, _reports(lo))


def _cycle_count(lo):
    imet = importlib.import_module(f"{lo.__name__.split('.')[0]}.utils.internal_metrics")
    bound = imet.LOCK_ORDER_VIOLATIONS.labels(kind="cycle")
    if hasattr(bound, "read"):
        return bound.read()
    return sum(c[0] for _t, c in bound._cells)


def test_inversion_reports_flight_and_metric(lo):
    fr = importlib.import_module(f"{lo.__name__.split('.')[0]}.observability.flight_recorder")
    before = _cycle_count(lo)
    a, b = lo.tracked_lock("test.FA"), lo.tracked_lock("test.FB")
    with a:
        with b:
            pass
    with b:
        with a:  # the same thread: still a proven inversion in the graph
            pass
    assert any(v["kind"] == "cycle" for v in lo.violations())
    assert "lock.order_cycle" in [e[1] for e in fr.RECORDER.snapshot()]
    assert _cycle_count(lo) == before + 1


def test_no_false_positive_on_consistent_order_and_reentrancy(lo):
    x, y = lo.tracked_lock("test.X"), lo.tracked_lock("test.Y")
    for _ in range(5):
        with x:
            with y:
                pass
    r = lo.tracked_rlock("test.R")
    with r:
        with r:
            with x:
                pass
    assert lo.violations() == []
    _agree("consistent", lo, lo.order_graph())


def test_inversion_deduplicated_per_signature(lo):
    a, b = lo.tracked_lock("test.DA"), lo.tracked_lock("test.DB")
    with a:
        with b:
            pass
    for _ in range(3):
        with b:
            with a:
                pass
    assert len([v for v in lo.violations() if v["kind"] == "cycle"]) == 1


def test_self_deadlock_reported_before_blocking(lo):
    s = lo.tracked_lock("test.S")

    def doomed():
        s.acquire()
        s.acquire()  # blocks for good, but only after reporting

    threading.Thread(target=doomed, daemon=True).start()
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline and not any(
            v["kind"] == "self" for v in lo.violations()):
        time.sleep(0.02)
    assert any(v["kind"] == "self" for v in lo.violations())
    _agree("self", lo, _reports(lo))


def test_long_hold_reported(lo, monkeypatch):
    monkeypatch.setenv("RAY_TPU_LOCK_ORDER_HOLD_S", "0.05")
    h = lo.tracked_lock("test.H")
    with h:
        time.sleep(0.08)
    v = [v for v in lo.violations() if v["kind"] == "long_hold"]
    assert len(v) == 1 and v[0]["lock"] == "test.H" and v[0]["held_s"] >= 0.05


def test_timeout_and_nonblocking_acquire_paths(lo):
    s = lo.tracked_lock("test.T")
    assert s.acquire(timeout=0.1)
    assert s.locked()
    s.release()
    assert s.acquire(blocking=False)
    s.release()
    assert lo.violations() == []


def test_disarmed_factories_return_plain_stdlib_locks(lo, monkeypatch):
    monkeypatch.delenv("RAY_TPU_LOCK_ORDER", raising=False)
    assert type(lo.tracked_lock("test.plain")) is type(threading.Lock())
    assert type(lo.tracked_rlock("test.rplain")) is type(threading.RLock())


def test_condition_protocol_compat(lo):
    lock = lo.tracked_lock("test.CV")
    cv = threading.Condition(lock)
    hits = []

    def waiter():
        with cv:
            cv.wait(timeout=5)
            hits.append(1)

    t = threading.Thread(target=waiter)
    t.start()
    time.sleep(0.1)
    with cv:
        cv.notify()
    t.join(timeout=5)
    assert hits == [1]
    assert not [v for v in lo.violations() if v["kind"] != "long_hold"]


def test_control_plane_boot_paths_create_tracked_locks(lo):
    """The GCS's, the raylet's and the Serve controller's locks come from
    the armed factory, under the JAX package's names."""
    pkg = lo.__name__.split(".")[0]
    gcs = importlib.import_module(f"{pkg}.core.gcs")
    svc = gcs.GcsService()
    try:
        assert isinstance(svc._lock, lo.TrackedRLock)
        assert svc._lock.name == "gcs.state"
        assert isinstance(svc._incident_lock, lo.TrackedLock)
        assert svc._incident_lock.name == "gcs.incidents"
    finally:
        svc._stop.set()
        if getattr(svc, "_watchdog", None) is not None:
            svc._watchdog.stop()
    # The raylet and the controller need a cluster to construct: their
    # names ride the code objects of their constructors.
    raylet = importlib.import_module(f"{pkg}.core.raylet")
    names = raylet.RayletService.__init__.__code__.co_consts
    for name in ("raylet.resources", "raylet.workers", "raylet.seen_submits",
                 "raylet.actors", "raylet.gcs_sync_buf", "raylet.evict"):
        assert name in names, name
    controller = importlib.import_module(f"{pkg}.serve.controller")
    assert "serve.controller" in controller.ServeController.__init__.__code__.co_consts


def test_sharded_gcs_paths_keep_one_lock_order(lo, tmp_path):
    """The GCS's paths over its shards, armed: registrations (single and
    batched), heartbeats, actor registration, start and death with restart,
    object syncs, borrows and frees, the listings, a node's death and a
    snapshot leave no cycle, no edge from a shard lock to `gcs.state`, and
    shard locks nested only in ascending index."""
    pkg = lo.__name__.split(".")[0]
    gcs = importlib.import_module(f"{pkg}.core.gcs")
    svc = gcs.GcsService(snapshot_path=str(tmp_path / "gcs.snapshot"),
                         session_dir=str(tmp_path), shards=4)
    try:
        nodes = [f"lock-node-{i:02d}" + "0" * 12 for i in range(6)]
        epochs = {n: svc.register_node(n, f"/t/{n}", f"/s/{n}", {"CPU": 4.0}, {})["epoch"]
                  for n in nodes[:3]}
        for n, r in zip(nodes[3:], svc.register_nodes([
                {"node_id": n, "sock": f"/t/{n}", "store": f"/s/{n}",
                 "resources": {"CPU": 4.0}, "labels": {}} for n in nodes[3:]])):
            epochs[n] = r["epoch"]
        for n in nodes:
            svc.heartbeat(n, {"CPU": 4.0}, {"full": True, "wall_ts": time.time()}, epochs[n])
        aids = [f"lock-actor-{i:02d}" + "0" * 20 for i in range(8)]
        for i, aid in enumerate(aids):
            r = svc.register_actor(aid, b"spec", {"CPU": 0.5}, 1, f"a{i}", "default")
            svc.actor_started(aid, r["node_id"], epochs[r["node_id"]])
        oids = [f"{i:040x}" for i in range(16)]
        svc.node_sync(nodes[0], oids, [{"task_id": "t1", "state": "RUNNING"}], epochs[nodes[0]])
        svc.update_borrows({oids[0]: 1})
        svc.free_objects(oids[:4])
        svc.flush_frees()
        svc.update_borrows({oids[0]: -1})
        svc.actor_died(aids[0], "test", node_id=svc.get_actor(aids[0])["node_id"],
                       epoch=epochs[svc.get_actor(aids[0])["node_id"]])
        svc.list_nodes(), svc.list_nodes(3), svc.node_summary(), svc.stats()
        svc.list_actors(), svc.list_objects(), svc.node_table_snapshot()
        svc.get_object_locations_batch(oids)
        svc.pick_node({"CPU": 1.0}), svc.pick_node({"CPU": 1.0}, mode="spread")
        (svc.mark_node_dead if pkg == "ray_tpu_torch" else svc.drain_node)(nodes[1])
        svc._save_snapshot()
        time.sleep(0.5)  # the restart threads run their placements
    finally:
        svc.stop()  # also disarms the trigger bus the service armed in this process
    assert not [v for v in lo.violations() if v["kind"] == "cycle"], lo.violations()
    graph = lo.order_graph()
    # The shard locks were tracked: gcs.state is held while they are taken.
    assert any(a.startswith("gcs.shard") for a in graph.get("gcs.state", ())), graph
    for held, acquired in graph.items():
        if held.startswith("gcs.shard"):
            assert "gcs.state" not in acquired, (held, acquired)
            for a in acquired:
                if a.startswith("gcs.shard"):
                    assert a > held, (held, a)
