"""Pubsub channels on the port's cluster runtime (ray_tpu_torch/utils/pubsub.py
over core/gcs.py) against the JAX package's: tests/test_pubsub.py's four
cases, then `poll_deltas`'s gap and the `node_table` delta channel mirrored
by NodeTableMirror, each run on both packages with the same messages.

One cluster of each package serves the file (a module fixture per package;
the JAX one booted through tests/torch_modes.py's `boot_jax_cluster`).
Channel names differ per case, so the cases do not see each other's
messages.
"""

import importlib
import sys
import time
import types

import pytest

import ray_tpu as jrt
import ray_tpu_torch as trt
import torch_modes
from ray_tpu_torch.core import serialization

serialization.register_pickle_by_value(sys.modules[__name__])

PKGS = ("jax", "torch")
# What each package's run of a case saw, for the port's run to equal.
_SEEN = {}


@pytest.fixture(scope="module")
def jax_cluster():
    from ray_tpu.core import runtime_base as jbase

    jrt.shutdown()
    jc = torch_modes.boot_jax_cluster(num_cpus=2, num_workers=1)
    try:
        jbase.set_runtime(jc.runtime())
        yield types.SimpleNamespace(name="jax", rt=jrt, cluster=jc, base=jbase)
    finally:
        torch_modes.shutdown_cluster(jc, jrt.shutdown)


@pytest.fixture(scope="module")
def torch_cluster():
    from ray_tpu_torch.core import runtime_base as tbase
    from ray_tpu_torch.core.cluster_runtime import Cluster

    trt.shutdown()
    tc = torch_modes.boot_cluster(Cluster, num_cpus=2, num_gpus=0, num_workers=1)
    try:
        tbase.set_runtime(tc.runtime())
        yield types.SimpleNamespace(name="torch", rt=trt, cluster=tc, base=tbase)
    finally:
        torch_modes.shutdown_cluster(tc, trt.shutdown)


@pytest.fixture(params=PKGS)
def c(request):
    c = request.getfixturevalue(f"{request.param}_cluster")
    c.pubsub = importlib.import_module(f"{c.rt.__name__}.utils.pubsub")
    return c


def _agree(case, name, seen):
    _SEEN.setdefault(case, {})[name] = seen
    if name == "torch" and "jax" in _SEEN[case]:
        assert seen == _SEEN[case]["jax"], f"{case}: the port saw {seen}, JAX {_SEEN[case]['jax']}"


def test_publish_poll_ordering_and_cursor(c):
    pubsub = c.pubsub
    sub = pubsub.subscribe("chan1")
    seen = [sub.poll(timeout=0.05)]
    pubsub.publish("chan1", "a")
    pubsub.publish("chan1", {"b": 2})
    seen.append(sub.poll(timeout=5.0))
    seen.append(sub.poll(timeout=0.05))  # the cursor moved past them
    pubsub.publish("chan1", "c")
    seen.append(sub.poll(timeout=5.0))
    assert seen == [[], ["a", {"b": 2}], [], ["c"]]
    _agree("ordering", c.name, seen)


def test_subscribe_at_tail_skips_history(c):
    pubsub = c.pubsub
    pubsub.publish("chan2", "old")
    sub = pubsub.subscribe("chan2")
    pubsub.publish("chan2", "new")
    seen = [sub.poll(timeout=5.0)]
    replay = pubsub.subscribe("chan2", from_beginning=True)
    seen.append(replay.poll(timeout=5.0))
    assert seen == [["new"], ["old", "new"]]
    _agree("tail", c.name, seen)


def test_cross_process_pubsub(c):
    """A worker task's publishes wake the driver's long poll."""
    rt = c.rt
    sub = c.pubsub.subscribe("events")

    @rt.remote
    def announce(pkg, n):
        ps = importlib.import_module(f"{pkg}.utils.pubsub")
        for i in range(n):
            ps.publish("events", f"msg{i}")
        return n

    ref = announce.remote(rt.__name__, 3)
    got = []
    deadline = time.time() + 30
    while len(got) < 3 and time.time() < deadline:
        got += sub.poll(timeout=2.0)
    assert got == ["msg0", "msg1", "msg2"]
    assert rt.get(ref, timeout=30) == 3
    _agree("cross_process", c.name, got)


def test_retention_bound(c):
    gcs_mod = importlib.import_module(f"{c.rt.__name__}.core.gcs")
    retain = gcs_mod.GcsService._PUBSUB_RETAIN
    sub = c.pubsub.subscribe("flood", from_beginning=True)
    n = retain + 50
    for i in range(n):
        c.pubsub.publish("flood", i)
    msgs = []
    while True:
        batch = sub.poll(timeout=0.05)
        if not batch:
            break
        msgs += batch
    assert len(msgs) == retain  # the oldest 50 were trimmed
    assert msgs[-1] == n - 1
    _agree("retention", c.name, (retain, msgs))


def test_poll_deltas_reports_the_gap(c):
    """A cursor behind the ring gets `gap=True` from poll_deltas (the loss
    plain poll() hides), and a fresh one gets every retained entry."""
    gcs_mod = importlib.import_module(f"{c.rt.__name__}.core.gcs")
    retain = gcs_mod.GcsService._PUBSUB_RETAIN
    c.pubsub.publish("gapped", "first")
    behind = c.pubsub.subscribe("gapped", from_beginning=True)
    assert behind.poll_deltas(timeout=1.0)[0][0][1] == "first"
    for i in range(retain + 5):
        c.pubsub.publish("gapped", i)
    entries, gap = behind.poll_deltas(timeout=1.0)
    fresh, fresh_gap = c.pubsub.subscribe("gapped", from_beginning=True).poll_deltas(1.0)
    seen = (entries, gap, len(fresh), fresh_gap, fresh[-1][1])
    assert seen == ([], True, retain, False, retain + 4)
    _agree("gap", c.name, seen)


def test_node_table_mirror_follows_membership(c):
    """The `node_table` channel: a joined node appears in the mirror as
    ALIVE, a removed one as dead, without a resync."""
    rt_mod = c.base.current_runtime()
    mirror = c.pubsub.NodeTableMirror(rt_mod._gcs)
    head = set(mirror.alive())
    node = c.cluster.add_node(num_cpus=1)
    deadline = time.monotonic() + 30
    while node not in mirror.alive() and time.monotonic() < deadline:
        mirror.poll(timeout=1.0)
    joined = node in mirror.alive()
    c.cluster.remove_node(node)
    while node in mirror.alive() and time.monotonic() < deadline + 30:
        mirror.poll(timeout=1.0)
    seen = (len(head), joined, node in mirror.nodes, node in mirror.alive(),
            mirror.nodes[node]["State"], mirror.resyncs)
    assert seen == (1, True, True, False, "DEAD", 1)
    _agree("node_table", c.name, seen)
