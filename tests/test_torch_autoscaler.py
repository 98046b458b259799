"""The port's autoscalers and node provider (ray_tpu_torch/{autoscaler,
autoscaler_v2}.py, accelerators/node_provider.py) and node labels, against
the JAX package's (tests/test_autoscaler_v2.py, test_ops_layer.py's
autoscaler case).

Exact: the v2 InstanceManager's instance histories, retries, replacements
and scale-down victims over one scripted cloud, with the same failures on
the same fake clock. The same outcome, on one cluster of each package
(module fixtures; the JAX one booted through tests/torch_modes.py): the
FakeCloudProvider's and the LocalNodeProvider's nodes join and leave, a
two-host shape comes up as two labelled hosts of one slice and goes as one
(`gpus` in the port's shape where the JAX package has `tpus`), the v1
autoscaler adds a node under a starved queue and releases it idle, the
reconciler replaces a node removed under it and one preempted by the chaos
`provider.poll` rule (DRAINING first), a trainer on a preempted provider
node recovers with goodput under 0.9 (test_metrics_history.py's case),
labels show in `nodes()`, and `init(address=<session dir>)` attaches a
driver.
Every cluster case runs under `case_time_limit` and restores the cluster to
its head alone.
"""

import importlib
import os
import sys
import threading
import time
import types

import pytest

import ray_tpu as jrt
import ray_tpu_torch as trt
import torch_modes
from ray_tpu_torch.core import serialization
from torch_waits import wait_for

serialization.register_pickle_by_value(sys.modules[__name__])

PKGS = ("jax", "torch")
NAMES = {"jax": "ray_tpu", "torch": "ray_tpu_torch"}
_SEEN = {}


def _agree(case, name, seen):
    _SEEN.setdefault(case, {})[name] = seen
    if name == "torch" and "jax" in _SEEN[case]:
        assert seen == _SEEN[case]["jax"], f"{case}: the port saw {seen}, JAX {_SEEN[case]['jax']}"


def _v2(name):
    return importlib.import_module(f"{NAMES[name]}.autoscaler_v2")


# ------------------------------------------------------ the reconciler, exact
class _Clock:
    def __init__(self):
        self.now = 1000.0

    def monotonic(self):
        return self.now

    def sleep(self, s):
        self.now += s


def _scripted_cloud(v2):
    class ScriptedCloud(v2.CloudProvider):
        """An in-memory cloud whose states the test sets (no cluster)."""

        def __init__(self):
            self.state, self.terminated, self.n = {}, [], 0

        def request(self, instance):
            self.n += 1
            cid = f"c{self.n}"
            self.state[cid] = "pending"
            return cid

        def poll(self):
            return dict(self.state)

        def terminate(self, cloud_id):
            self.terminated.append(cloud_id)
            self.state.pop(cloud_id, None)

        def ray_node_for(self, cloud_id):
            return f"node-{cloud_id}" if self.state.get(cloud_id) == "running" else None

    return ScriptedCloud()


class _FakeGcs:
    def __init__(self):
        self.alive, self.forecasts = [], []

    def call(self, method, *a):
        if method == "report_demand_forecast":
            self.forecasts.append(a)
            return True
        assert method == "list_nodes"
        return [{"NodeID": n, "Alive": True} for n in self.alive]


def _table(im):
    return [(i.history + [i.status], i.retries, i.cloud_id) for i in im.instances.values()]


@pytest.mark.parametrize("name", PKGS)
def test_reconciler_state_sequence_matches(name, monkeypatch):
    v2 = _v2(name)
    clock = _Clock()
    monkeypatch.setattr(v2, "time", clock)
    cloud, gcs = _scripted_cloud(v2), _FakeGcs()
    im = v2.InstanceManager(cloud, gcs=gcs, retry_backoff_s=1.0, max_retries=2,
                            request_timeout_s=30.0)
    steps = []
    im.set_target(3)
    im.set_pending_actors(5)
    im.reconcile()
    steps.append(("requested", _table(im), list(gcs.forecasts)))
    cloud.state["c1"], cloud.state["c2"] = "running", "failed"
    gcs.alive = ["node-c1"]
    im.reconcile()
    steps.append(("one up, one failed", _table(im), list(cloud.terminated)))
    clock.sleep(0.5)
    im.reconcile()  # inside the backoff: no retry yet
    steps.append(("backoff", _table(im)))
    clock.sleep(1.0)
    im.reconcile()  # back to QUEUED and requested in the same round
    steps.append(("retried", _table(im)))
    cloud.state["c3"] = "running"
    gcs.alive = ["node-c1", "node-c3"]
    im.reconcile()
    gcs.alive = ["node-c3"]  # c1's node dies: terminated, a replacement queued
    im.reconcile()
    im.reconcile()
    steps.append(("replaced", _table(im), list(cloud.terminated)))
    clock.sleep(40.0)  # c4 and c5 time out in REQUESTED
    im.reconcile()
    steps.append(("timed out", _table(im), im.counts()))
    im.set_target(1)
    im.reconcile()
    steps.append(("scaled down", _table(im), im.counts()))
    assert im.counts().get("RAY_RUNNING") == 1
    _agree("reconciler", name, steps)


@pytest.mark.parametrize("name", PKGS)
def test_instance_manager_relays_forecast_once(name):
    """test_worker_pool.py's relay case: declared pending-actor demand
    reaches the GCS as one demand forecast on the next round, and only once
    (the GCS consumes it per registration and expires the rest)."""
    v2 = _v2(name)

    class _Gcs:
        def __init__(self):
            self.calls = []

        def call(self, method, *a, **k):
            self.calls.append((method, a))
            return [] if method == "list_nodes" else True

    gcs = _Gcs()
    im = v2.InstanceManager(v2.FakeCloudProvider(None), gcs=gcs)
    sent = []
    for pending in (None, 12, None, 3):
        if pending is not None:
            im.set_pending_actors(pending)
        im.reconcile()
        sent.append([a for m, a in gcs.calls if m == "report_demand_forecast"])
    assert sent == [[], [(12, 60.0, "autoscaler")], [(12, 60.0, "autoscaler")],
                    [(12, 60.0, "autoscaler"), (3, 60.0, "autoscaler")]]
    _agree("forecast", name, sent)


@pytest.mark.parametrize("name", PKGS)
def test_instances_progress_through_states(name):
    v2 = _v2(name)
    cloud = _scripted_cloud(v2)
    im = v2.InstanceManager(cloud, request_timeout_s=5.0)
    im.set_target(3)
    im.reconcile()
    assert im.counts() == {v2.REQUESTED: 3}
    for cid in list(cloud.state)[:2]:
        cloud.state[cid] = "running"
    im.reconcile()
    c = im.counts()
    assert c[v2.RAY_RUNNING] == 2 and c[v2.REQUESTED] == 1, c


@pytest.mark.parametrize("name", PKGS)
def test_allocation_failure_retries_with_backoff(name):
    v2 = _v2(name)
    cloud = _scripted_cloud(v2)
    im = v2.InstanceManager(cloud, retry_backoff_s=0.05, max_retries=2)
    im.set_target(1)
    im.reconcile()
    (cid,) = list(cloud.state)
    cloud.state[cid] = "failed"
    im.reconcile()
    assert im.counts() == {v2.ALLOCATION_FAILED: 1}
    assert cloud.terminated == [cid]
    time.sleep(0.12)
    im.reconcile()
    assert im.counts() == {v2.REQUESTED: 1}
    assert next(iter(im.instances.values())).retries == 1


@pytest.mark.parametrize("name", PKGS)
def test_scale_down_prefers_least_progressed(name):
    v2 = _v2(name)
    cloud = _scripted_cloud(v2)
    im = v2.InstanceManager(cloud)
    im.set_target(3)
    im.reconcile()
    cloud.state[list(cloud.state)[0]] = "running"
    im.reconcile()
    im.reconcile()
    im.set_target(1)
    im.reconcile()
    c = im.counts()
    assert c.get(v2.RAY_RUNNING) == 1
    assert c.get(v2.TERMINATED, 0) + c.get(v2.TERMINATING, 0) == 2


# --------------------------------------------------------- cluster drills
@pytest.fixture(scope="module")
def jax_cluster():
    from ray_tpu.core import runtime_base as jbase

    jrt.shutdown()
    jc = torch_modes.boot_jax_cluster(num_cpus=2, num_workers=0)
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
    tc = torch_modes.boot_cluster(Cluster, num_cpus=2, num_gpus=0, num_workers=0)
    try:
        tbase.set_runtime(tc.runtime())
        yield types.SimpleNamespace(name="torch", rt=trt, cluster=tc, base=tbase)
    finally:
        torch_modes.shutdown_cluster(tc, trt.shutdown)


@pytest.fixture(params=PKGS)
def c(request):
    c = request.getfixturevalue(f"{request.param}_cluster")
    c.v2 = _v2(c.name)
    c.gcs = c.base.current_runtime()._gcs
    with torch_modes.case_time_limit(request, 120):
        try:
            yield c
        finally:
            _back_to_the_head(c)


def _alive(c):
    return [n for n in c.gcs.call("list_nodes") if n["Alive"]]


def _back_to_the_head(c):
    for n in _alive(c):
        if n["NodeID"] != c.cluster.head_node_id:
            c.cluster.remove_node(n["NodeID"])


def _scale_to_zero(c, im):
    im.set_target(0)
    assert wait_for(lambda: (im.reconcile(), len(_alive(c)) == 1)[1], timeout=30.0)


def test_fake_cloud_end_to_end_nodes_join(c):
    provider = c.v2.FakeCloudProvider(c.cluster, delay_s=0.2, fail_first=1)
    im = c.v2.InstanceManager(provider, gcs=c.gcs, retry_backoff_s=0.1, request_timeout_s=10.0)
    im.set_target(2)
    assert im.wait_running(2, timeout=60.0), im.counts()
    seen = [len(_alive(c)), sorted(i.retries for i in im.instances.values())]
    _scale_to_zero(c, im)
    assert seen[0] == 3
    _agree("fake_cloud", c.name, seen)


def test_local_node_provider_scale_up_and_down(c):
    provider = c.v2.LocalNodeProvider(c.cluster, num_cpus_per_node=1.0)
    im = c.v2.InstanceManager(provider, gcs=c.gcs, shape={"cpus": 1.0})
    im.set_target(2)
    assert im.wait_running(2, timeout=60.0), im.counts()
    alive = _alive(c)
    labelled = [n for n in alive if (n.get("Labels") or {}).get("ray_tpu_cloud_id")]
    # The reconciler's node for each instance is the one its label names.
    by_label = {n["Labels"]["ray_tpu_cloud_id"]: n["NodeID"] for n in labelled}
    assert {i.cloud_id: i.node_id for i in im.instances.values()} == by_label
    seen = [len(alive), len(labelled), sorted(n["Resources"]["CPU"] for n in labelled)]
    _scale_to_zero(c, im)
    assert seen[:2] == [3, 2]
    _agree("local_provider", c.name, seen)


def test_local_node_provider_slice_atomicity_with_labels(c):
    provider = c.v2.LocalNodeProvider(c.cluster)
    accel = "tpus" if c.name == "jax" else "gpus"
    im = c.v2.InstanceManager(provider, gcs=c.gcs,
                              shape={"cpus": 1.0, accel: 1.0, "slice_hosts": 2})
    im.set_target(1)
    assert im.wait_running(1, timeout=60.0), im.counts()
    hosts = [n for n in _alive(c) if (n.get("Labels") or {}).get("slice_name")]
    (inst,) = im.instances.values()
    labels = [{k: v for k, v in n["Labels"].items() if k not in ("slice_name", "ray_tpu_cloud_id")}
              for n in sorted(hosts, key=lambda n: int(n["Labels"]["worker_index"]))]
    seen = [len(hosts), len({n["Labels"]["slice_name"] for n in hosts}),
            [{k: int(v) for k, v in lab.items() if k == "worker_index"} for lab in labels],
            sorted({n["Labels"]["ray_tpu_cloud_id"] for n in hosts}) == [inst.cloud_id],
            inst.node_id == min(hosts, key=lambda n: int(n["Labels"]["worker_index"]))["NodeID"],
            [n["Resources"].get("TPU" if c.name == "jax" else "GPU") for n in hosts]]
    _scale_to_zero(c, im)
    assert seen[:2] == [2, 1] and seen[3] and seen[4]
    _agree("slice", c.name, seen)


def test_reconciler_replaces_a_dead_node(c):
    provider = c.v2.LocalNodeProvider(c.cluster)
    im = c.v2.InstanceManager(provider, gcs=c.gcs, shape={"cpus": 1.0})
    im.set_target(1)
    assert im.wait_running(1, timeout=60.0), im.counts()
    (first,) = im.instances.values()
    c.cluster.remove_node(first.node_id)
    assert wait_for(lambda: (im.reconcile(), im.counts().get("RAY_RUNNING", 0) == 1
                             and first.status == "TERMINATED")[1], timeout=60.0), im.counts()
    seen = [first.history + [first.status], sorted(im.counts().items())]
    _scale_to_zero(c, im)
    _agree("replace", c.name, seen)


def test_v1_autoscaler_scales_up_and_releases_idle(c):
    scaler_mod = importlib.import_module(f"{NAMES[c.name]}.autoscaler")

    @c.rt.remote(num_cpus=2)
    def hold(t):
        time.sleep(t)
        return 1

    scaler = scaler_mod.Autoscaler(scaler_mod.LocalNodeProvider(c.cluster, num_cpus_per_node=2),
                                   min_nodes=1, max_nodes=3, upscale_delay_s=0.5,
                                   idle_timeout_s=2.0, interval_s=0.25)
    scaler.start()
    try:
        # Three tasks as wide as the one 2-CPU node: a sustained queue.
        refs = [hold.remote(3.0) for _ in range(3)]
        assert wait_for(lambda: scaler.num_upscales >= 1, timeout=40.0), "no upscale"
        assert c.rt.get(refs, timeout=90) == [1, 1, 1]
        assert wait_for(lambda: scaler.num_downscales >= scaler.num_upscales, timeout=40.0)
    finally:
        scaler.stop()
    assert len(_alive(c)) == 1
    _agree("v1", c.name, [scaler.num_upscales >= 1, scaler.num_downscales == scaler.num_upscales])


def test_labels_in_nodes_and_init_by_session_dir(c):
    nid = c.cluster.add_node(num_cpus=1, labels={"zone": "z1", "rack": "r7"})
    try:
        nodes = {n["NodeID"]: n for n in c.rt.nodes()}
        seen = [nodes[nid]["Labels"], nodes[c.cluster.head_node_id]["Labels"]]
        # A second driver attaches to the same head through its session dir.
        outer = c.base.current_runtime()
        c.base.set_runtime(None)
        try:
            c.rt.init(address=c.cluster.session_dir)
            f = c.rt.remote(lambda x: x + 1)
            seen.append([c.rt.get(f.remote(41), timeout=60),
                         sorted(n["NodeID"] for n in c.rt.nodes() if n["Alive"])
                         == sorted([nid, c.cluster.head_node_id])])
        finally:
            attached = c.base.current_runtime()
            c.base.set_runtime(outer)
            attached.shutdown()
        assert len(_alive(c)) == 2  # the attached driver's shutdown left the cluster up
    finally:
        c.cluster.remove_node(nid)
    assert seen == [{"zone": "z1", "rack": "r7"}, {}, [42, True]]
    _agree("labels", c.name, seen)


def test_port_init_auto_reads_its_own_pointer(tmp_path, monkeypatch):
    """`init(address="auto")` takes the port's pointer file, then
    RAY_TPU_ADDRESS, and refuses with neither; the JAX CLI's pointer
    (~/.ray_tpu/latest_session) is never read."""
    from ray_tpu_torch.core.cluster_runtime import resolve_address, session_pointer_path

    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.delenv("RAY_TPU_ADDRESS", raising=False)
    jax_dir = tmp_path / "jax_session"
    jax_dir.mkdir()
    (jax_dir / "session.json").write_text("{}")
    os.makedirs(tmp_path / ".ray_tpu")
    (tmp_path / ".ray_tpu" / "latest_session").write_text(str(jax_dir))
    with pytest.raises(ConnectionError):
        resolve_address("auto")
    env_dir = tmp_path / "env_session"
    env_dir.mkdir()
    (env_dir / "session.json").write_text("{}")
    monkeypatch.setenv("RAY_TPU_ADDRESS", str(env_dir))
    assert resolve_address("auto") == str(env_dir)
    mine = tmp_path / "port_session"
    mine.mkdir()
    (mine / "session.json").write_text("{}")
    os.makedirs(os.path.dirname(session_pointer_path()))
    with open(session_pointer_path(), "w") as f:
        f.write(str(mine))
    assert session_pointer_path() == str(tmp_path / ".ray_tpu_torch" / "latest_session")
    assert resolve_address("auto") == str(mine)
    assert resolve_address("tcp://127.0.0.1:1") == "tcp://127.0.0.1:1"
    with pytest.raises(ValueError, match="tcp://host:port"):
        resolve_address(str(tmp_path / "nowhere"))


def test_chaos_preempt_rule_drains_then_replaces(c):
    """A `provider.poll` rule with action `preempt` gives a running
    instance a notice (its node DRAINING), removes it at the grace's end,
    and the reconciler replaces it."""
    chaos = importlib.import_module(f"{NAMES[c.name]}.chaos")
    provider = c.v2.LocalNodeProvider(c.cluster)
    im = c.v2.InstanceManager(provider, gcs=c.gcs, shape={"cpus": 1.0})
    im.set_target(1)
    assert im.wait_running(1, timeout=60.0), im.counts()
    (first,) = im.instances.values()
    chaos.configure([{"point": "provider.poll", "action": "preempt", "delay_s": 1.0}], seed=0)
    try:
        provider.poll()  # the rule fires once: the notice now, the machine in 1 s
        node = {n["NodeID"]: n for n in c.gcs.call("list_nodes")}[first.node_id]
        seen = [node["Draining"], node["DrainReason"]]
        assert wait_for(lambda: (im.reconcile(), first.status == "TERMINATED"
                                 and im.counts().get("RAY_RUNNING", 0) == 1)[1], timeout=60.0)
        seen.append(not {n["NodeID"]: n for n in c.gcs.call("list_nodes")}[first.node_id]["Alive"])
    finally:
        chaos.disable()
    _scale_to_zero(c, im)
    assert seen == [True, "spot preemption (injected)", True]
    _agree("preempt", c.name, seen)


def _goodput_loop(n_steps: int, step_sleep: float):
    """test_metrics_history.py's preemption loop: a checkpoint per step, a
    clean return on the drain notice, a resume from the last checkpoint."""

    def loop(config):
        import importlib
        import time

        train = importlib.import_module(config["train"])
        start = 0
        ckpt = train.get_checkpoint()
        if ckpt is not None:
            start = ckpt.to_dict()["step"] + 1
        for step in range(start, n_steps):
            train.report({"step": step}, checkpoint=train.Checkpoint.from_dict({"step": step}))
            if train.drain_requested():
                return
            time.sleep(step_sleep)

    return loop


@pytest.fixture
def _jax_flight_ring_left_as_found():
    """The JAX trainer records its drains and restores in the JAX package's
    process-wide flight ring, which tests/test_chaos.py, when it runs later
    in the same worker, orders by their earliest: put its slots back."""
    from ray_tpu.observability import flight_recorder as frec

    saved = list(frec.RECORDER._buf)
    yield
    frec.RECORDER._buf[:] = saved


def test_goodput_drops_under_injected_preemption(c, tmp_path, monkeypatch,
                                                 _jax_flight_ring_left_as_found):
    """test_metrics_history.py's goodput case on both packages: a trainer
    on a node the reconciler keeps at one instance; the chaos `provider.poll`
    rule preempts that node after two checkpoints; the run recovers on the
    replacement, and drain-wait and restart-rework time pull goodput under
    0.9."""
    chaos = importlib.import_module(f"{NAMES[c.name]}.chaos")
    train = importlib.import_module(f"{NAMES[c.name]}.train")
    goodput = importlib.import_module(f"{NAMES[c.name]}.observability.goodput")
    monkeypatch.setenv("RAY_TPU_FLIGHT_DIR", str(tmp_path / "flight"))
    provider = c.v2.LocalNodeProvider(c.cluster, num_cpus_per_node=2.0)
    im = c.v2.InstanceManager(provider, gcs=c.gcs,
                              shape={"cpus": 2.0, "resources": {"train_slot": 1.0}})
    im.set_target(1)
    stop = threading.Event()

    def reconcile_loop():
        while not stop.is_set():
            im.reconcile()
            time.sleep(0.05)

    threading.Thread(target=reconcile_loop, daemon=True).start()
    trial_dir = tmp_path / "exp" / "goodput_preempt"

    def inject_when_progressed():
        if wait_for(lambda: len([d for d in (os.listdir(trial_dir) if trial_dir.exists() else [])
                                 if d.startswith("checkpoint_")]) >= 2, timeout=60.0):
            chaos.configure([{"point": "provider.poll", "action": "preempt", "times": 1,
                              "delay_s": 1.0}], seed=0)

    try:
        assert wait_for(lambda: im.counts().get("RAY_RUNNING", 0) >= 1, timeout=60.0)
        threading.Thread(target=inject_when_progressed, daemon=True).start()
        Trainer = train.JaxTrainer if c.name == "jax" else train.TorchTrainer
        extra = {} if c.name == "jax" else {"use_gpu": False}
        result = Trainer(
            _goodput_loop(10, 0.05), train_loop_config={"train": train.__name__},
            scaling_config=train.ScalingConfig(num_workers=1,
                                               resources_per_worker={"train_slot": 1.0},
                                               **extra),
            run_config=train.RunConfig(name="goodput_preempt",
                                       storage_path=str(tmp_path / "exp"),
                                       failure_config=train.FailureConfig(max_failures=1)),
        ).fit()
        injected = chaos.controller().stats()[0]["injected"]
    finally:
        stop.set()
        chaos.disable()
    im.set_target(0)
    assert wait_for(lambda: (im.reconcile(), len(_alive(c)) == 1)[1], timeout=30.0)
    assert result.error is None, f"training did not recover: {result.error!r}"
    seconds = result.metrics["goodput_seconds"]
    share = seconds[goodput.PRODUCTIVE] / sum(seconds.values())
    seen = [injected, seconds[goodput.DRAIN_WAIT] > 0, seconds[goodput.RESTART_REWORK] > 0,
            result.metrics["goodput"] < 0.9,
            result.metrics["goodput"] == pytest.approx(share, rel=1e-3)]
    assert seen == [1, True, True, True, True], (result.metrics["goodput"], seconds)
    _agree("goodput", c.name, seen)
