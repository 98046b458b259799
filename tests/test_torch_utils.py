"""ActorPool and the distributed Queue on the port's cluster runtime
(ray_tpu_torch/utils/{actor_pool,queue}.py) against the JAX package's:
tests/test_recovery.py's `test_actor_pool` and `test_distributed_queue`,
each run on both packages with the same functions and inputs. Before them,
the flushers of utils/internal_metrics.py and utils/metrics.py on both
packages: a flush that fails keeps its deltas and a later one sends them
once; and the port's: a forked child reports only what it records.

One cluster of each package serves the file (a module fixture per package;
the JAX one booted through tests/torch_modes.py's `boot_jax_cluster`). The
pool's case comes first: the queue's producer and consumer are the first
tasks a cluster runs, so neither is pipelined behind the other on a task
lease (a producer blocked on a full queue would hold the lease its
consumer waits behind, in both packages).
"""

import importlib
import json
import os
import sys
import types

import pytest

import ray_tpu as jrt
import ray_tpu_torch as trt
import torch_modes
from ray_tpu_torch.core import serialization

serialization.register_pickle_by_value(sys.modules[__name__])

PKGS = ("jax", "torch")
PACKAGES = {"jax": "ray_tpu", "torch": "ray_tpu_torch"}
_SEEN = {}


@pytest.fixture(scope="module")
def jax_cluster():
    from ray_tpu.core import runtime_base as jbase

    jrt.shutdown()
    jc = torch_modes.boot_jax_cluster(num_cpus=4, num_workers=2)
    try:
        jbase.set_runtime(jc.runtime())
        yield types.SimpleNamespace(name="jax", rt=jrt)
    finally:
        torch_modes.shutdown_cluster(jc, jrt.shutdown)


@pytest.fixture(scope="module")
def torch_cluster():
    from ray_tpu_torch.core import runtime_base as tbase
    from ray_tpu_torch.core.cluster_runtime import Cluster

    trt.shutdown()
    tc = torch_modes.boot_cluster(Cluster, num_cpus=4, num_gpus=0, num_workers=2)
    try:
        tbase.set_runtime(tc.runtime())
        yield types.SimpleNamespace(name="torch", rt=trt)
    finally:
        torch_modes.shutdown_cluster(tc, trt.shutdown)


@pytest.fixture(params=PKGS)
def c(request):
    c = request.getfixturevalue(f"{request.param}_cluster")
    c.utils = importlib.import_module(f"{c.rt.__name__}.utils")
    return c


def _agree(case, name, seen):
    _SEEN.setdefault(case, {})[name] = seen
    if name == "torch" and "jax" in _SEEN[case]:
        assert seen == _SEEN[case]["jax"], f"{case}: the port saw {seen}, JAX {_SEEN[case]['jax']}"


class _FlakyGcs:
    """A GCS client whose calls fail until `up` is set; it keeps what it got."""

    def __init__(self):
        self.up, self.got = False, []

    def call(self, method, *args, **kwargs):
        if not self.up:
            raise ConnectionError("GCS unreachable")
        self.got.append((method, args))
        return True


@pytest.mark.parametrize("name", PKGS)
def test_catalog_flush_sends_a_failed_flush_once(name):
    """A `raytpu_*` counter's deltas survive two failed flushes and reach the
    GCS once: 2 + 3 arrive as 5, and a flush with nothing new sends none."""
    imet = importlib.import_module(f"{PACKAGES[name]}.utils.internal_metrics")
    gcs = _FlakyGcs()
    saved = (imet._sink, imet._node_id, imet._reporter)
    imet.configure(node_id="n-probe", reporter="probe",
                   sink=lambda recs: gcs.call("report_internal_metrics", "probe", recs))
    point = f"flush_probe_{name}"
    try:
        lane = imet.CHAOS_INJECTIONS.labels(point=point, action="count")
        lane.inc(2.0)
        imet._flush_once()
        lane.inc(3.0)
        imet._flush_once()
        gcs.up = True
        imet._flush_once()
        imet._flush_once()
    finally:
        imet.configure(sink=saved[0])
        imet._node_id, imet._reporter = saved[1], saved[2]
    mine = [rec for _, (_, recs) in gcs.got for rec in recs
            if rec["tags"].get("point") == point]
    seen = (sum(rec["value"] for rec in mine), sorted(mine[0]["tags"].items()), mine[0]["kind"])
    assert seen == (5.0, [("action", "count"), ("component", "chaos"), ("node_id", "n-probe"),
                          ("point", point)], "counter")
    _agree("catalog_flush", name, (seen[0], seen[2]))


@pytest.mark.parametrize("name", PKGS)
def test_user_metrics_flush_sends_a_failed_flush_once(name):
    """The same for utils/metrics: a Counter's and a Histogram's deltas kept
    across a failed report_metrics reach the GCS once."""
    metrics = importlib.import_module(f"{PACKAGES[name]}.utils.metrics")
    base = importlib.import_module(f"{PACKAGES[name]}.core.runtime_base")
    gcs = _FlakyGcs()
    saved = base.maybe_runtime()
    base.set_runtime(types.SimpleNamespace(_gcs=gcs, _worker_id="probe"))
    try:
        counter = metrics.Counter(f"flush_probe_calls_{name}")
        hist = metrics.Histogram(f"flush_probe_ms_{name}", boundaries=[1.0, 10.0])
        counter.inc(2.0)
        hist.observe(0.5)
        metrics._flush_once()
        counter.inc(3.0)
        hist.observe(5.0)
        gcs.up = True
        metrics._flush_once()
        metrics._flush_once()
    finally:
        base.set_runtime(saved)
    recs = [rec for method, (_, recs) in gcs.got if method == "report_metrics" for rec in recs
            if rec["name"].endswith(name)]
    calls = sum(r["value"] for r in recs if r["kind"] == "counter")
    counts = [sum(c) for c in zip(*(r["counts"] for r in recs if r["kind"] == "histogram"))]
    assert (calls, counts) == (5.0, [1, 1, 0])
    _agree("user_flush", name, (calls, counts))


_FORK_PROBE = """
import json, os
from ray_tpu_torch.utils import internal_metrics as imet
from ray_tpu_torch.utils import metrics

lane = imet.CHAOS_INJECTIONS.labels(point="fork_probe", action="count")
counter = metrics.Counter("fork_probe_calls")

def own():
    return ([rec["value"] for rec in imet.CHAOS_INJECTIONS._collect("n")
             if rec["tags"]["point"] == "fork_probe"],
            [rec["value"] for rec in counter._collect()])

lane.inc(4.0)
counter.inc(4.0)
r, w = os.pipe()
pid = os.fork()
if pid == 0:
    lane.inc(1.0)
    counter.inc(1.0)
    os.write(w, json.dumps(own()).encode())
    os._exit(0)
os.close(w)
with os.fdopen(r) as f:
    child = json.loads(f.read())
os.waitpid(pid, 0)
print(json.dumps({"child": child, "parent": own()}))
"""


def test_forked_child_reports_only_its_own_records():
    """A child forked after its parent recorded (as the zygote's workers
    are) sends none of the parent's unflushed deltas, for the catalog and
    user metrics alike; the parent keeps its own. In a fresh interpreter:
    this one runs JAX's threads, which a fork must not copy."""
    import subprocess

    out = subprocess.run([sys.executable, "-c", _FORK_PROBE], capture_output=True, text=True,
                         timeout=120, cwd=os.path.dirname(os.path.dirname(__file__)))
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.splitlines()[-1]) == {"child": [[1.0], [1.0]],
                                                       "parent": [[4.0], [4.0]]}


def test_actor_pool(c):
    rt = c.rt

    @rt.remote
    class Doubler:
        def work(self, x):
            return 2 * x

    pool = c.utils.ActorPool([Doubler.remote() for _ in range(2)])
    ordered = list(pool.map(lambda a, v: a.work.remote(v), range(6)))
    unordered = sorted(pool.map_unordered(lambda a, v: a.work.remote(v), range(4)))
    pool.submit(lambda a, v: a.work.remote(v), 21)  # submit / get_next interleave
    single = pool.get_next(timeout=60)
    seen = (ordered, unordered, single, pool.has_next())
    assert seen == ([0, 2, 4, 6, 8, 10], [0, 2, 4, 6], 42, False)
    _agree("actor_pool", c.name, seen)


def test_distributed_queue(c):
    rt = c.rt
    q = c.utils.Queue(maxsize=4)

    @rt.remote
    def producer(q, n):
        for i in range(n):
            q.put(i)
        return True

    @rt.remote
    def consumer(q, n):
        return [q.get(timeout=30) for _ in range(n)]

    p = producer.remote(q, 8)
    got = rt.get(consumer.remote(q, 8), timeout=60)
    assert got == list(range(8))
    assert rt.get(p, timeout=30) is True
    assert q.empty()
    with pytest.raises(c.utils.Empty):
        q.get_nowait()
    q.put_nowait(99)
    seen = (got, q.qsize(), q.get_nowait())
    assert seen[1:] == (1, 99)
    q.shutdown()
    _agree("queue", c.name, seen)
