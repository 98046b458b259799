"""Compiled graphs on the port (ray_tpu_torch/cgraph/, dag.py's
`experimental_compile`, the worker's `__ray_dag_*__` builtins) against the
JAX package's ray_tpu/cgraph/, case by case on the same inputs.

tests/test_cgraph.py's 21 cases run on a module-scoped cluster of each
package, each case under its own time limit (torch_modes.case_time_limit),
with every observation of the port held equal to JAX's: exact for values
and float64 arrays, float32 collective edges within 1e-6 relative of each
other and of the float64 sum. Then the port's own: a CPU torch tensor
(float32 and bf16) through a channel, the float32 allreduce edge on seeded
arrays, and the compiled executions' history as a rate. Then the chaos and
elasticity cases: tests/test_elastic.py::test_cgraph_elastic_gang_resize,
tests/test_chaos.py's kill-and-recompile and `auto_rebuild` (the member's
worker SIGKILLs itself), tests/test_partition.py's partitioned member whose
fence closes the channels and re-forms the ElasticGraph (a cluster of its
own with the short heartbeat), and tests/test_observability.py's iteration
spans (a cluster with tracing on) and the timeout's flight dump.

A class used by both packages' actors is made inside a function: the JAX
package cloudpickles a module-level class of a test file by reference, and
the worker cannot import this file.
"""

import importlib
import os
import signal
import sys
import threading
import time
import types

import numpy as np
import pytest

from ray_tpu_torch.core import serialization
import torch_modes
from torch_waits import wait_for

serialization.register_pickle_by_value(sys.modules[__name__])

PKGS = ("jax", "torch")
ROOT = {"jax": "ray_tpu", "torch": "ray_tpu_torch"}
SEED = 1017
CASE_LIMIT_S = 120
CLUSTER_LIMIT_S = 300
F32_RTOL = 1e-6
_SEEN = {}


def _pkg(name):
    mod = lambda m: importlib.import_module(f"{ROOT[name]}.{m}")  # noqa: E731
    return types.SimpleNamespace(
        name=name, rt=importlib.import_module(ROOT[name]), cgraph=mod("cgraph"), dag=mod("dag"),
        channel=mod("core.channel"), base=mod("core.runtime_base"), state=mod("utils.state"),
        chaos=mod("chaos"), tracing=mod("tracing"), frec=mod("observability.flight_recorder"),
        cluster_mod=mod("core.cluster_runtime"), actors=[])


def _agree(request, seen):
    """The port's observation must equal the JAX package's (JAX runs first)."""
    case = request.node.originalname
    name = request.node.callspec.params["c"] if "c" in request.node.callspec.params else None
    _SEEN.setdefault(case, {})[name] = seen
    if name == "torch" and "jax" in _SEEN[case]:
        assert seen == _SEEN[case]["jax"], f"{case}: the port saw {seen}, JAX {_SEEN[case]['jax']}"


def _boot(p, **kwargs):
    if p.name == "jax":
        return torch_modes.boot_jax_cluster(**kwargs)
    return torch_modes.boot_cluster(p.cluster_mod.Cluster, num_gpus=0, **kwargs)


@pytest.fixture(scope="module")
def clusters():
    for name in PKGS:
        importlib.import_module(ROOT[name]).shutdown()
    booted = {}
    try:
        yield booted
    finally:
        for cluster, runtime, base in booted.values():
            try:
                torch_modes.shutdown_cluster(cluster, runtime.shutdown)
            finally:
                base.set_runtime(None)


@pytest.fixture(params=PKGS)
def c(request, clusters):
    """The package's module cluster as its current runtime; the case's actors
    are killed after it."""
    p = _pkg(request.param)
    with torch_modes.case_time_limit(request, CASE_LIMIT_S):
        if p.name not in clusters:
            cluster = _boot(p, num_cpus=8, num_workers=3)
            clusters[p.name] = (cluster, cluster.runtime(), p.base)
        p.base.set_runtime(clusters[p.name][1])
        try:
            yield p
        finally:
            for a in p.actors:
                try:
                    p.rt.kill(a)
                except Exception:  # noqa: BLE001 - already dead
                    pass
            p.base.set_runtime(None)


@pytest.fixture
def limit(request):
    with torch_modes.case_time_limit(request, CLUSTER_LIMIT_S):
        yield


def _stage_class():
    class Stage:
        def __init__(self, k):
            self.k = k

        def add(self, x):
            return x + self.k

        def mul2(self, x):
            return x * 2

        def shard(self, x):
            return np.full(16, float(x + self.k))

        def first(self, arr):
            return float(np.asarray(arr).reshape(-1)[0])

        def seeded(self, x):
            rng = np.random.default_rng(int(x) * 10 + int(self.k))
            return rng.standard_normal(4096).astype(np.float32)

        def ping(self):
            return True

        def stage_die(self):
            os.kill(os.getpid(), signal.SIGKILL)

    return Stage


def _actors(c, cls, *args_list, **options):
    remote = c.rt.remote(**options)(cls) if options else c.rt.remote(cls)
    out = [remote.remote(*args) for args in args_list]
    c.actors.extend(out)
    return out


def _stages(c, *ks):
    return _actors(c, _stage_class(), *[(k,) for k in ks])


# ------------------------------------------------------------- correctness
def test_compile_matches_eager(c, request):
    s1, s2, s3 = _stages(c, 1, 10, 100)
    with c.dag.InputNode() as inp:
        dag = s3.add.bind(s2.add.bind(s1.add.bind(inp)))
    eager = [c.rt.get(dag.execute(i), timeout=60) for i in range(5)]
    compiled = c.cgraph.compile(dag)
    try:
        got = [compiled.execute(i).get(timeout=30) for i in range(5)]
        assert got == eager == [111 + i for i in range(5)]
    finally:
        compiled.teardown()
    _agree(request, got)


def test_multi_output_and_diamond(c, request):
    src, left, right = _stages(c, 1, 0, 0)
    with c.dag.InputNode() as inp:
        mid = src.add.bind(inp)
        dag = c.dag.MultiOutputNode([left.mul2.bind(mid), right.add.bind(mid)])
    compiled = c.cgraph.compile(dag)
    try:
        got = [compiled.execute(i).get(timeout=30) for i in range(4)]
        assert got == [[(i + 1) * 2, i + 1] for i in range(4)]
    finally:
        compiled.teardown()
    _agree(request, got)


def test_200_iterations_bounded_and_clean_teardown(c, request):
    s1, s2 = _stages(c, 2, 5)
    with c.dag.InputNode() as inp:
        dag = s2.add.bind(s1.add.bind(inp))
    compiled = c.cgraph.compile(dag, max_inflight=8)
    got = []
    try:
        refs = []
        for i in range(200):
            refs.append(compiled.execute(i))
            if len(refs) >= 16:
                got.append(refs.pop(0).get(timeout=30))
                assert got[-1] == (i - 15) + 7
        got += [ref.get(timeout=30) for ref in refs]
        assert got == [i + 7 for i in range(200)] and compiled.inflight == 0
    finally:
        compiled.teardown()
    compiled.teardown()
    with pytest.raises(RuntimeError, match="torn down"):
        compiled.execute(0)
    _agree(request, got)


def test_max_inflight_backpressure(c, request):
    (s,) = _stages(c, 1)
    with c.dag.InputNode() as inp:
        dag = s.add.bind(inp)
    compiled = c.cgraph.compile(dag, max_inflight=2)
    try:
        refs = [compiled.execute(i) for i in range(12)]
        inflight = compiled.inflight
        assert inflight <= 2
        got = [r.get(timeout=30) for r in refs]
        assert got == [i + 1 for i in range(12)]
    finally:
        compiled.teardown()
    _agree(request, (inflight, got))


def test_max_inflight_validation(c):
    (s,) = _stages(c, 1)
    with c.dag.InputNode() as inp:
        dag = s.add.bind(inp)
    with pytest.raises(ValueError, match="max_inflight"):
        c.cgraph.compile(dag, max_inflight=0)


# -------------------------------------------------------- collective edges
def test_allreduce_edge_matches_collective(c, request):
    ws = _stages(c, 1, 2)
    with c.dag.InputNode() as inp:
        reduced = c.cgraph.allreduce.bind([w.shard.bind(inp) for w in ws])
        dag = c.dag.MultiOutputNode([w.first.bind(r) for w, r in zip(ws, reduced)])
    compiled = c.cgraph.compile(dag)
    try:
        got = [compiled.execute(i).get(timeout=60) for i in range(3)]
        assert got == [[2 * i + 3.0] * 2 for i in range(3)]
    finally:
        compiled.teardown()
    _agree(request, got)


def test_reduce_scatter_edge(c, request):
    ws = _stages(c, 1, 2)
    with c.dag.InputNode() as inp:
        reduced = c.cgraph.reduce_scatter.bind([w.shard.bind(inp) for w in ws])
        dag = c.dag.MultiOutputNode([w.first.bind(r) for w, r in zip(ws, reduced)])
    compiled = c.cgraph.compile(dag)
    try:
        got = compiled.execute(0).get(timeout=60)
        assert got == [3.0, 3.0]
    finally:
        compiled.teardown()
    _agree(request, got)


def test_p2p_edge(c, request):
    a, b = _stages(c, 10, 100)
    with c.dag.InputNode() as inp:
        dag = b.first.bind(c.cgraph.p2p.bind(a.shard.bind(inp), b))
    compiled = c.cgraph.compile(dag)
    try:
        got = [compiled.execute(i).get(timeout=60) for i in range(3)]
        assert got == [float(i + 10) for i in range(3)]
    finally:
        compiled.teardown()
    _agree(request, got)


def _flaky_class():
    class Flaky:
        def __init__(self, k):
            self.k = k

        def shard(self, x):
            if self.k == 1 and x == 3:
                raise ValueError("shard three")
            return np.full(4, float(x + self.k))

        def first(self, arr):
            return float(np.asarray(arr).reshape(-1)[0])

    return Flaky


def test_gang_survives_member_error(c, request):
    """One member's upstream failure does not wedge the gang: the status lap
    keeps every member in lockstep, the error reaches the driver, and the
    next iteration still works."""
    ws = _actors(c, _flaky_class(), (1,), (2,))
    with c.dag.InputNode() as inp:
        reduced = c.cgraph.allreduce.bind([w.shard.bind(inp) for w in ws])
        dag = c.dag.MultiOutputNode([w.first.bind(r) for w, r in zip(ws, reduced)])
    compiled = c.cgraph.compile(dag)
    try:
        first = compiled.execute(0).get(timeout=60)
        with pytest.raises((ValueError, RuntimeError)) as ei:
            compiled.execute(3).get(timeout=60)
        last = compiled.execute(5).get(timeout=60)
        assert first == [3.0, 3.0] and last == [13.0, 13.0]
    finally:
        compiled.teardown()
    _agree(request, (first, type(ei.value).__name__, last))


def test_p2p_from_input_rejected(c):
    (a,) = _stages(c, 1)
    with c.dag.InputNode() as inp:
        dag = a.first.bind(c.cgraph.p2p.bind(inp, a))
    with pytest.raises(ValueError, match="actor-resident"):
        c.cgraph.compile(dag)


def test_partial_gang_rejected(c):
    ws = _stages(c, 1, 2)
    with c.dag.InputNode() as inp:
        reduced = c.cgraph.allreduce.bind([w.shard.bind(inp) for w in ws])
        dag = ws[0].first.bind(reduced[0])
    with pytest.raises(ValueError, match="partially bound"):
        c.cgraph.compile(dag)


def test_collective_node_has_no_eager_form(c):
    ws = _stages(c, 1, 2)
    with c.dag.InputNode() as inp:
        dag = c.dag.MultiOutputNode(c.cgraph.allreduce.bind([w.shard.bind(inp) for w in ws]))
    with pytest.raises(TypeError, match="compiled graph"):
        dag.execute(1)


# ----------------------------------------------------------- failure paths
def test_actor_death_surfaces_channel_closed(c):
    s1, s2 = _stages(c, 1, 10)
    with c.dag.InputNode() as inp:
        dag = s2.add.bind(s1.add.bind(inp))
    compiled = c.cgraph.compile(dag)
    try:
        assert compiled.execute(0).get(timeout=30) == 11
        c.rt.kill(s1)
        time.sleep(0.5)
        with pytest.raises(c.channel.ChannelClosed):
            compiled.execute(1).get(timeout=15)
        with pytest.raises((c.channel.ChannelClosed, RuntimeError)):
            compiled.execute(2)
    finally:
        compiled.teardown()


def _boomer_class():
    class Boomer:
        def go(self, x):
            if x == 3:
                raise ValueError("x was three")
            return x * 2

    return Boomer


def test_node_error_propagates_and_pipeline_survives(c, request):
    (a,) = _actors(c, _boomer_class(), ())
    with c.dag.InputNode() as inp:
        dag = a.go.bind(inp)
    compiled = c.cgraph.compile(dag)
    try:
        first = compiled.execute(2).get(timeout=30)
        with pytest.raises(ValueError, match="x was three"):
            compiled.execute(3).get(timeout=30)
        last = compiled.execute(4).get(timeout=30)
        assert (first, last) == (4, 8)
    finally:
        compiled.teardown()
    _agree(request, (first, last))


# ----------------------------------------------------------- plan checking
def test_plain_function_nodes_rejected(c):
    def f(x):
        return x

    with c.dag.InputNode() as inp:
        dag = c.rt.remote(f).bind(inp)
    with pytest.raises(ValueError, match="actor method"):
        c.cgraph.compile(dag)


def test_ungated_node_rejected(c):
    (s,) = _stages(c, 1)
    with c.dag.InputNode():
        dag = s.add.bind(7)
    with pytest.raises(ValueError, match="gated"):
        c.cgraph.compile(dag)


def test_compile_rejects_undersized_buffer(c):
    (s,) = _stages(c, 1)
    with c.dag.InputNode() as inp:
        dag = s.add.bind(inp)
    with pytest.raises(ValueError, match="aligned"):
        c.cgraph.compile(dag, buffer_size_bytes=1 << 12, max_message_bytes=1 << 12)


# --------------------------------------------------- channel layer (unit)
@pytest.mark.parametrize("name", PKGS)
def test_writer_close_wakes_blocked_reader(tmp_path, name):
    ch = _pkg(name).channel
    r = ch.ChannelReader(str(tmp_path), capacity=1 << 16)
    w = ch.ChannelWriter(r.spec())
    w.write("warm")
    assert r.read(timeout=5) == "warm"
    got = {}

    def blocked_read():
        t0 = time.monotonic()
        try:
            r.read(timeout=30)
        except ch.ChannelClosed:
            got["latency"] = time.monotonic() - t0

    t = threading.Thread(target=blocked_read)
    t.start()
    time.sleep(0.3)
    w.close()
    t.join(timeout=10)
    assert not t.is_alive(), "reader still blocked after writer close()"
    assert got["latency"] < 5.0
    r.close()


@pytest.mark.parametrize("name", PKGS)
def test_reader_close_unblocks_writer_backpressure(tmp_path, name):
    ch = _pkg(name).channel
    r = ch.ChannelReader(str(tmp_path), capacity=1 << 10)
    w = ch.ChannelWriter(r.spec())

    def fill_then_block():
        try:
            for _ in range(100):
                w.write_bytes(b"x" * 300, timeout=30)
        except ch.ChannelClosed:
            return

    t = threading.Thread(target=fill_then_block)
    t.start()
    time.sleep(0.3)
    r.close()
    t.join(timeout=10)
    assert not t.is_alive(), "writer still blocked after reader close()"
    w.close()


@pytest.mark.parametrize("name", PKGS)
def test_channel_spec_validates_capacity(tmp_path, name):
    ch = _pkg(name).channel
    # Both specs carry the reader's TCP address beside its ring.
    addr = ("127.0.0.1", 1)
    with pytest.raises(ValueError, match="capacity"):
        ch.ChannelSpec("x", "/tmp/r", "/tmp/s", addr, 0)
    with pytest.raises(TypeError):
        ch.ChannelSpec("x", "/tmp/r", "/tmp/s", addr, "big")
    with pytest.raises(ValueError, match="aligned"):
        ch.ChannelReader(str(tmp_path), capacity=1 << 10, max_message=1 << 10)
    assert ch.required_capacity(0) >= 64
    ch.ChannelReader(str(tmp_path), capacity=ch.required_capacity(256), max_message=256).close()


# ----------------------------------------------------------------- metrics
def test_cgraph_metrics_flow_to_state_api(c, request):
    """The data plane's instruments reach the GCS's internal-metrics table,
    and its history: the executions counter as a rate over two flushes."""
    def msgs():
        return sum(m["value"] for m in c.state.internal_metrics()
                   if m["name"] == "raytpu_cgraph_channel_msgs_total")

    base = msgs()
    s1, s2 = _stages(c, 1, 10)
    with c.dag.InputNode() as inp:
        dag = s2.add.bind(s1.add.bind(inp))
    compiled = c.cgraph.compile(dag)
    want = {"raytpu_cgraph_channel_msgs_total", "raytpu_cgraph_channel_bytes_total",
            "raytpu_cgraph_ring_occupancy_hwm_bytes", "raytpu_cgraph_execute_latency_ms",
            "raytpu_cgraph_executions_total"}
    try:
        for i in range(20):
            assert compiled.execute(i).get(timeout=30) == i + 11
        names = wait_for(lambda: want <= {m["name"] for m in c.state.internal_metrics()}
                         and msgs() - base >= 20, timeout=30, interval=0.5)
        assert names, {m["name"] for m in c.state.internal_metrics()}
        graph = compiled._dag_id[:8]
        time.sleep(1.5)  # a second flush interval
        for i in range(20, 30):
            assert compiled.execute(i).get(timeout=30) == i + 11

        def history():
            name = "raytpu_cgraph_executions_total"
            total = c.state.metrics_history(name, tags={"graph": graph})
            rate = c.state.metrics_history(name, tags={"graph": graph}, as_rate=True)
            if total and total[0]["samples"][-1][1] == 30.0 and rate[0]["samples"]:
                return total[0], rate[0]
            return None

        got = wait_for(history, timeout=30, interval=0.5)
        assert got, c.state.metrics_history("raytpu_cgraph_executions_total")
        total, rate = got
        assert all(v > 0 for _, v in rate["samples"]) and c.state.active_alerts() == []
    finally:
        compiled.teardown()
    _agree(request, (total["kind"], sorted(total["tags"]), total["samples"][-1][1]))


# ----------------------------------------------- the port's data plane rule
def _tensor_stage_class():
    class TensorStage:
        def scale(self, x):
            return x * 2

        def kind(self, x):
            return type(x).__name__, str(getattr(x, "dtype", ""))

    return TensorStage


def test_torch_cpu_tensor_through_a_channel(c, request):
    """The same float32 values as a CPU torch tensor (the port) and a numpy
    array (JAX) through a two-hop compiled graph: equal results, and on the
    port a tensor back, bf16 bit for bit."""
    import torch

    rng = np.random.default_rng(SEED)
    x = rng.standard_normal((64, 32)).astype(np.float32)
    a, b = _actors(c, _tensor_stage_class(), (), ())
    with c.dag.InputNode() as inp:
        dag = b.scale.bind(a.scale.bind(inp))
    compiled = c.cgraph.compile(dag)
    try:
        if c.name == "torch":
            out = compiled.execute(torch.from_numpy(x)).get(timeout=30)
            assert isinstance(out, torch.Tensor) and out.device.type == "cpu"
            bf = torch.from_numpy(x).to(torch.bfloat16)
            out_bf = compiled.execute(bf).get(timeout=30)
            assert out_bf.dtype == torch.bfloat16 and torch.equal(out_bf, bf * 4)
            got = out.numpy()
        else:
            got = compiled.execute(x).get(timeout=30)
    finally:
        compiled.teardown()
    np.testing.assert_array_equal(got, x * 4)
    _agree(request, got.tobytes())


def test_float32_allreduce_edge_on_seeded_arrays(c, request):
    """Seeded float32 arrays through an allreduce edge: within 1e-6 relative
    of the float64 sum on both packages, and of each other."""
    ws = _stages(c, 1, 2, 3)
    with c.dag.InputNode() as inp:
        reduced = c.cgraph.allreduce.bind([w.seeded.bind(inp) for w in ws])
        dag = c.dag.MultiOutputNode(reduced)
    compiled = c.cgraph.compile(dag)
    try:
        outs = [compiled.execute(i).get(timeout=60) for i in range(2)]
    finally:
        compiled.teardown()
    for i, out in enumerate(outs):
        want = sum(np.random.default_rng(i * 10 + k).standard_normal(4096).astype(np.float32)
                   .astype(np.float64) for k in (1, 2, 3))
        for member in out:
            assert member.dtype == np.float32
            np.testing.assert_allclose(member, want, rtol=F32_RTOL, atol=F32_RTOL)
    seen = np.stack([np.stack(o) for o in outs])
    case = request.node.originalname
    _SEEN.setdefault(case, {})[c.name] = seen
    if c.name == "torch" and "jax" in _SEEN[case]:
        np.testing.assert_allclose(seen, _SEEN[case]["jax"], rtol=F32_RTOL, atol=F32_RTOL)


# ------------------------------------------------ elasticity and recovery
def _member_class():
    class Member:
        def __init__(self, base):
            self.base = float(base)

        def shard(self, x):
            return np.full(8, float(x) + self.base, dtype=np.float64)

        def first(self, arr):
            return float(arr[0])

    return Member


def test_cgraph_elastic_gang_resize(c, request):
    """tests/test_elastic.py::test_cgraph_elastic_gang_resize: a compiled
    allreduce gang loses a member for good; ElasticGraph re-forms at world
    N-1 and `grow()` folds a replacement back in."""
    cg, dag = c.cgraph, c.dag

    def build(actors):
        with dag.InputNode() as inp:
            reduced = cg.allreduce.bind([a.shard.bind(inp) for a in actors])
            return dag.MultiOutputNode([a.first.bind(r) for a, r in zip(actors, reduced)])

    opts = {"max_restarts": 0, "num_cpus": 0.1}
    members = _actors(c, _member_class(), (1,), (2,), (3,), **opts)
    c.rt.get([m.first.remote(np.zeros(1)) for m in members], timeout=60)
    eg = cg.ElasticGraph(build, members, min_actors=2, rebuild_timeout=90.0)
    try:
        first = eg.run(0, timeout=30)
        c.rt.kill(members[1])
        assert wait_for(lambda: any(a["state"] == "DEAD"
                                    and a["actor_id"] == members[1]._actor_id.hex()
                                    for a in c.state.list_actors()), timeout=30)
        # The survivors wedge in the allreduce: the get's timeout is the
        # break's first sign, as in tests/test_elastic.py (30 s there).
        shrunk = eg.run(0, timeout=10)
        assert eg.world_size == 2
        (replacement,) = _actors(c, _member_class(), (5,), **opts)
        c.rt.get(replacement.first.remote(np.zeros(1)), timeout=60)
        grown = eg.grow([replacement])
        regrown = eg.run(1, timeout=30)
        assert (first, shrunk, grown, regrown) == ([6.0] * 3, [4.0] * 2, 3, [12.0] * 3)
    finally:
        eg.teardown()
    _agree(request, (first, shrunk, grown, regrown))


def _dying_stage_class():
    class Stage:
        def apply(self, x):
            return x + 1

        def double(self, x):
            return x * 2

        def stage_die(self):
            os.kill(os.getpid(), signal.SIGKILL)

        def ping(self):
            return True

    return Stage


def test_cgraph_kill_and_recompile(c, request):
    """tests/test_chaos.py::test_cgraph_kill_and_recompile: a stage's worker
    SIGKILLed mid-graph; the driver sees ChannelClosed and recompile()
    rewires against the restarted incarnation."""
    a, b = _actors(c, _dying_stage_class(), (), (), max_restarts=1)
    c.rt.get([a.ping.remote(), b.ping.remote()], timeout=60)
    with c.dag.InputNode() as inp:
        node = b.apply.bind(a.apply.bind(inp))
    g = c.cgraph.compile(node)
    try:
        first = g.execute(1).get(timeout=30)
        with pytest.raises(Exception):
            c.rt.get(a.stage_die.remote(), timeout=30)
        with pytest.raises(c.channel.ChannelClosed):
            for i in range(50):
                g.execute(10 + i).get(timeout=10)
                time.sleep(0.05)
        g.recompile(timeout=60.0)
        after = g.execute(5).get(timeout=30)
        assert (first, after) == (3, 7)
    finally:
        g.teardown()
    _agree(request, (first, after))


def test_cgraph_auto_rebuild_on_channel_closed(c, request):
    """tests/test_chaos.py::test_cgraph_auto_rebuild_on_channel_closed: after
    the break, the next execute recompiles against the restarted actor."""
    (s,) = _actors(c, _dying_stage_class(), (), max_restarts=-1)
    c.rt.get(s.ping.remote(), timeout=60)
    with c.dag.InputNode() as inp:
        node = s.double.bind(inp)
    g = c.cgraph.compile(node, auto_rebuild=True)
    try:
        first = g.execute(3).get(timeout=30)
        with pytest.raises(Exception):
            c.rt.get(s.stage_die.remote(), timeout=30)
        saw_break, out = False, None
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            try:
                out = g.execute(4).get(timeout=10)
                if saw_break:
                    break
                time.sleep(0.05)
            except c.channel.ChannelClosed:
                saw_break = True
        assert saw_break and out == 8, (saw_break, out)
    finally:
        g.teardown()
    _agree(request, (first, out))


# ------------------------------------------------------------ observability
def _stuck_class():
    class Stuck:
        def apply(self, x):
            time.sleep(30)

    return Stuck


def test_cgraph_timeout_writes_flight_dump(c, request, tmp_path, monkeypatch):
    """tests/test_observability.py::test_cgraph_timeout_writes_flight_dump: a
    stuck graph's get(timeout) raises and the driver dumps its ring, naming
    the blocked output channel."""
    flight = tmp_path / "flight"
    monkeypatch.setenv("RAY_TPU_FLIGHT_DIR", str(flight))
    (s,) = _actors(c, _stuck_class(), ())
    with c.dag.InputNode() as inp:
        node = s.apply.bind(inp)
    cdag = node.experimental_compile()
    try:
        ref = cdag.execute(1)
        with pytest.raises(TimeoutError, match="blocked on channel"):
            ref.get(timeout=2)
        dumps = c.frec.collect(str(flight))
        assert len(dumps) == 1 and "blocked on output channel" in dumps[0]["reason"]
        assert dumps[0]["extra"]["blocked_channel"].endswith("->driver")
        assert "chan.read_wait" in {e[1] for e in dumps[0]["events"]}
    finally:
        cdag.teardown()
    _agree(request, (sorted(dumps[0]["extra"]), dumps[0]["extra"]["seq"]))


@pytest.mark.parametrize("name", PKGS)
def test_cgraph_iteration_spans(name, tmp_path, monkeypatch, limit):
    """tests/test_observability.py::test_cgraph_iteration_spans: a 3-stage
    compiled pipeline under tracing; every actor's exec loop emits iteration
    spans (channel-wait and compute inside) that share the graph's trace id
    with the driver's execute and round spans, chained per iteration by
    cg:<dag>:<seq> flow ids. A cluster of its own, tracing on from boot."""
    p = _pkg(name)
    trace_dir = str(tmp_path / "traces")
    monkeypatch.setenv("RAY_TPU_TRACING", "1")
    monkeypatch.setenv("RAY_TPU_TRACE_DIR", trace_dir)
    p.rt.shutdown()
    cluster = _boot(p, num_cpus=4, num_workers=2)
    runtime = cluster.runtime()
    p.base.set_runtime(runtime)
    p.tracing.enable()
    try:
        stages = _actors(p, _dying_stage_class(), (), (), ())
        with p.dag.InputNode() as inp:
            node = inp
            for s in stages:
                node = s.apply.bind(node)
        cdag = node.experimental_compile()
        assert [cdag.execute(i).get(timeout=60) for i in range(3)] == [3, 4, 5]
        cdag.teardown()
    finally:
        p.tracing.disable()
        try:
            runtime.shutdown()
        finally:
            cluster.shutdown()
            p.base.set_runtime(None)
    spans = p.tracing.collect(trace_dir)
    execs = [s for s in spans if s["name"].startswith("cgraph.execute")]
    iters = [s for s in spans if s["name"].startswith("cgraph.iter")]
    waits = [s for s in spans if s["name"] == "cgraph.channel_wait"]
    computes = [s for s in spans if s["name"].startswith("cgraph.compute")]
    rounds = [s for s in spans if s["name"].startswith("cgraph.round")]
    assert len(execs) == 3 and len(rounds) == 3 and len(iters) >= 9
    assert waits and computes
    tid = execs[0]["trace_id"]
    assert all(s["trace_id"] == tid for s in iters + rounds)
    assert {s["pid"] for s in iters} - {execs[0]["pid"]}
    for seq in range(3):
        fid = f"cg:{execs[0]['attrs']['dag']}:{seq}"
        assert any(s["attrs"].get("flow_out") == fid for s in execs)
        assert any(s["attrs"].get("flow_step") == fid for s in iters)
        assert any(s["attrs"].get("flow_in") == fid for s in rounds)
    iter_ids = {s["span_id"] for s in iters}
    assert all(s["parent_id"] in iter_ids for s in waits + computes)
    seen = sorted({s["name"].split(" ")[0] for s in spans if s["name"].startswith("cgraph")})
    _SEEN.setdefault("spans", {})[name] = seen
    if name == "torch" and "jax" in _SEEN["spans"]:
        assert seen == _SEEN["spans"]["jax"]


@pytest.mark.parametrize("name", PKGS)
def test_cgraph_member_partition_channel_closed_elastic_reform(name, monkeypatch, limit):
    """tests/test_partition.py::
    test_cgraph_member_partition_channel_closed_elastic_reform: a member on a
    node cut off from the GCS is declared dead; the heal-time fence kills its
    worker, its exec loop's channels close, and the ElasticGraph re-forms at
    the survivor. A cluster of its own with test_partition.py's heartbeat."""
    p = _pkg(name)
    monkeypatch.setenv("RAY_TPU_HEARTBEAT_INTERVAL_S", "0.25")
    monkeypatch.setenv("RAY_TPU_HEARTBEAT_TIMEOUT_S", "1.5")
    p.rt.shutdown()
    cluster = _boot(p, num_cpus=2)
    runtime = cluster.runtime()
    p.base.set_runtime(runtime)
    try:
        cluster.add_node(num_cpus=2, resources={"sa": 1.0})
        node_b = cluster.add_node(num_cpus=2, resources={"sb": 1.0})
        cls = p.rt.remote(max_restarts=0)(_dying_stage_class())
        a = cls.options(resources={"sa": 0.5}).remote()
        b = cls.options(resources={"sb": 0.5}).remote()
        p.rt.get([a.ping.remote(), b.ping.remote()], timeout=60)

        def build(actors):
            with p.dag.InputNode() as inp:
                return p.dag.MultiOutputNode([m.apply.bind(inp) for m in actors])

        eg = p.cgraph.ElasticGraph(build, [a, b], min_actors=1, rebuild_timeout=90.0)
        first = eg.run(1, timeout=30)
        assert first == [2, 2] and eg.world_size == 2
        part = p.chaos.partition([[node_b], ["gcs"]], heal_after=45.0, runtime=runtime)
        assert wait_for(lambda: any(x["actor_id"] == b._actor_id.hex() and x["state"] == "DEAD"
                                    for x in p.state.list_actors()), timeout=30), \
            "partitioned member never marked DEAD"
        part.heal()
        deadline = time.monotonic() + 60
        while True:
            out = eg.run(5, timeout=15)
            if eg.world_size == 1:
                break
            assert time.monotonic() < deadline, "elastic graph never re-formed"
            time.sleep(0.3)
        assert out == [6]
        eg.teardown()
    finally:
        try:
            runtime.shutdown()
        finally:
            cluster.shutdown()
            p.base.set_runtime(None)
    _SEEN.setdefault("partition", {})[name] = (first, out)
    if name == "torch" and "jax" in _SEEN["partition"]:
        assert _SEEN["partition"]["torch"] == _SEEN["partition"]["jax"]
