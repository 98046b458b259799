"""Node drain and preemption on the cluster runtime, the port against the
JAX package: each case runs on both packages' `Cluster` with the same
scenario and the same assertions, and the port's run must agree with the
JAX package's (the same step histories bit for bit, the same worlds, the
same event and error fields).

The cases (from tests/test_chaos.py and tests/test_elastic.py):
  1. a drain notice: the node is Draining and still Alive, `pick_node`
     refuses it, and two notices publish one `node_draining` event; a drain
     the raylet started is adopted through its heartbeat;
  2. `node_added` and the trainer's event-driven capacity wait;
  3. the capacity renegotiation: an elastic run downsizes, a rigid one or
     one below its floor fails fast with CapacityTimeoutError's fields;
  4. drain -> final checkpoint -> restore on replacement capacity at the
     same step, against the golden trajectory, with max_failures=1 and 0;
  5. elastic 2 -> 1 -> 2 with a world-dependent recurrence: resize
     counters, degraded goodput, and the flight ring's order drain <=
     downsize <= growback;
  6. Serve replaces a replica on a draining node while a client keeps
     calling.
The JAX cases drive the preemption with autoscaler_v2's provider; both
packages go through `_preempt` here (the provider's own path is
tests/test_torch_autoscaler.py's), which does what
`LocalNodeProvider.inject_preemption` does:
`report_preemption`, then `remove_node` at the deadline; `add_node` brings
the replacement.

One cluster of each package serves the whole file, booted on first use
(every JAX `Cluster()` sweeps /dev/shm/rtpu_*, ROADMAP Queue 3). Every case
runs under a deadline of its own (tests/torch_waits.py `bounded`), so a
deadlock of the JAX package's runtime (ROADMAP Queue 3) fails that case
instead of holding its pytest worker. The metrics read are the driver
process's own counters: the port's GCS flush is not ported (item 3.8).
"""

import importlib
import os
import sys
import threading
import time
import types

import pytest

from ray_tpu_torch.core import serialization
import torch_modes
from torch_waits import bounded, wait_for

serialization.register_pickle_by_value(sys.modules[__name__])

PKGS = ("jax", "torch")
PACKAGES = {"jax": "ray_tpu", "torch": "ray_tpu_torch"}
CASE_TIMEOUT = 240.0
# What each package's run of a case observed, for the port's run to match.
_SEEN = {}


class _Clusters:
    """One cluster of each package, booted when a case first asks for it."""

    def __init__(self):
        self._booted = {}

    def get(self, name):
        if name not in self._booted:
            pkg = importlib.import_module(PACKAGES[name])
            base = importlib.import_module(f"{PACKAGES[name]}.core.runtime_base")
            Cluster = importlib.import_module(f"{PACKAGES[name]}.core.cluster_runtime").Cluster
            pkg.shutdown()
            if name == "jax":
                cluster = bounded(lambda: torch_modes.boot_jax_cluster(num_cpus=2), 120)
            else:
                cluster = torch_modes.boot_cluster(Cluster, num_cpus=2, num_gpus=0)
            runtime = cluster.runtime()
            self._booted[name] = types.SimpleNamespace(
                name=name, pkg=pkg, base=base, cluster=cluster, runtime=runtime,
                gcs=runtime._gcs, train=importlib.import_module(f"{PACKAGES[name]}.train"),
                exc=importlib.import_module(f"{PACKAGES[name]}.exceptions"),
                imet=importlib.import_module(f"{PACKAGES[name]}.utils.internal_metrics"),
                events=importlib.import_module(f"{PACKAGES[name]}.utils.node_events"),
                frec=importlib.import_module(f"{PACKAGES[name]}.observability.flight_recorder"))
        c = self._booted[name]
        c.base.set_runtime(c.runtime)
        return c

    def shutdown(self):
        errors = []
        for c in self._booted.values():
            # A wedged runtime must not hold the worker at teardown either.
            try:
                torch_modes.shutdown_cluster(c.cluster, c.runtime.shutdown)
            except BaseException as e:  # noqa: BLE001 - the other still goes down
                errors.append(e)
        self._booted.clear()
        if errors:
            raise errors[0]


@pytest.fixture(scope="module")
def clusters():
    cs = _Clusters()
    try:
        yield cs
    finally:
        cs.shutdown()


@pytest.fixture(params=PKGS)
def c(request, clusters):
    cl = clusters.get(request.param)
    yield cl
    cl.base.set_runtime(None)


@pytest.fixture(autouse=True)
def _jax_flight_ring_left_as_found():
    """The JAX trainer records its drains and restores in the JAX package's
    process-wide flight ring, which tests/test_chaos.py, when it runs later
    in the same worker, orders by their earliest: put its slots back."""
    from ray_tpu.observability import flight_recorder as frec

    saved = list(frec.RECORDER._buf)
    yield
    frec.RECORDER._buf[:] = saved


def _agree(case, name, seen):
    """Records what this package's run saw; the port's must equal the JAX
    package's when that ran first."""
    _SEEN.setdefault(case, {})[name] = seen
    if name == "torch" and "jax" in _SEEN[case]:
        assert seen == _SEEN[case]["jax"], f"{case}: the port saw {seen}, JAX {_SEEN[case]['jax']}"


def _count(c, metric, **tags):
    """A counter lane's total in this (the driver's) process."""
    lane = metric.labels(**tags)
    if c.name == "torch":
        return lane.read()
    with c.imet._lock:
        return lane._retired + sum(cell[0] for _, cell in lane._cells)


class _Terminator(threading.Thread):
    """Removes a preempted node at its deadline, or at once on `finish()`.
    Every one is finished before its test ends (`_terminators_joined`), so
    none outlives its test and acts on a cluster that was shut down."""

    live = []

    def __init__(self, c, node_id, deadline_s):
        super().__init__(daemon=True, name=f"terminate-{node_id[:8]}")
        self._c, self._node_id, self._deadline_s = c, node_id, deadline_s
        self._now = threading.Event()
        self.error = None
        _Terminator.live.append(self)

    def run(self):
        self._now.wait(self._deadline_s)
        try:
            self._c.cluster.remove_node(self._node_id)
        except BaseException as e:  # noqa: BLE001 - raised by finish()
            self.error = e

    def finish(self, timeout=60.0):
        self._now.set()
        self.join(timeout)
        assert not self.is_alive(), f"remove_node({self._node_id[:8]}) still running"
        if self.error is not None:
            raise self.error


@pytest.fixture(autouse=True)
def _terminators_joined():
    yield
    live, _Terminator.live = _Terminator.live, []
    for t in live:
        t.finish()


def _preempt(c, node_id, deadline_s):
    """What LocalNodeProvider.inject_preemption does: the notice now, the
    node's death at the deadline. Returns the thread that removes it."""
    assert c.gcs.call("report_preemption", node_id, deadline_s, "spot preemption (injected)")
    t = _Terminator(c, node_id, deadline_s)
    t.start()
    return t


def _scaling(c, **kw):
    if c.name == "torch":
        kw.setdefault("use_gpu", False)
    return c.train.ScalingConfig(**kw)


def _ckpt_count(trial_dir):
    try:
        return len([d for d in os.listdir(trial_dir) if d.startswith("checkpoint_")])
    except OSError:
        return 0


# ------------------------------------------------------------------ (1)
def test_drain_notice_excludes_node_and_publishes(c):
    def case():
        spot = c.cluster.add_node(num_cpus=2, resources={"spot_drain": 1.0})
        watcher = c.events.NodeEventWatcher(c.gcs)
        try:
            assert c.gcs.call("report_preemption", spot, 30.0, "test notice")
            node = {n["NodeID"]: n for n in c.gcs.call("list_nodes")}[spot]
            # pick_node refuses the draining node although it has room.
            picked = c.gcs.call("pick_node", {"spot_drain": 1.0})
            assert wait_for(lambda: spot in watcher.draining, timeout=10)
            # Idempotent: a second notice publishes nothing new.
            assert c.gcs.call("report_preemption", spot, 30.0, "again")
            time.sleep(0.3)
            drains = [e for e in watcher.events() if e.get("event") == "node_draining"]
            return {"draining": node["Draining"], "alive": node["Alive"],
                    "state": node["State"], "reason": node["DrainReason"],
                    "deadline_ahead": 0 < node["DrainDeadline"] - time.time() <= 30.0,
                    "picked": picked, "events": len(drains),
                    "event": {k: drains[0][k] for k in ("node_id", "deadline_s", "reason")}
                    == {"node_id": spot, "deadline_s": 30.0, "reason": "test notice"}}
        finally:
            watcher.stop()
            c.cluster.remove_node(spot)

    seen = bounded(case, CASE_TIMEOUT)
    assert seen == {"draining": True, "alive": True, "state": "DRAINING",
                    "reason": "test notice", "deadline_ahead": True, "picked": None,
                    "events": 1, "event": True}
    _agree("drain_notice", c.name, seen)


def test_raylet_initiated_drain_is_adopted(c):
    """A drain the raylet itself started (its `drain` RPC, an operator's)
    reaches the GCS through the heartbeat and is adopted as a notice."""
    rpc = importlib.import_module(f"{PACKAGES[c.name]}.core.rpc")

    def case():
        node = c.cluster.add_node(num_cpus=1, resources={"raylet_drain": 1.0})
        raylet = rpc.RpcClient(c.cluster._sock_for(node))
        try:
            before = raylet.call("is_draining")
            assert raylet.call("drain", 30.0) is True

            def entry():
                return {n["NodeID"]: n for n in c.gcs.call("list_nodes")}[node]

            adopted = wait_for(lambda: entry()["Draining"], timeout=15)
            return {"before": before, "after": raylet.call("is_draining"),
                    "adopted": bool(adopted), "reason": entry()["DrainReason"],
                    "picked": c.gcs.call("pick_node", {"raylet_drain": 1.0})}
        finally:
            raylet.close()
            c.cluster.remove_node(node)

    seen = bounded(case, CASE_TIMEOUT)
    assert seen == {"before": False, "after": True, "adopted": True,
                    "reason": "raylet-initiated drain", "picked": None}
    _agree("raylet_drain", c.name, seen)


# ------------------------------------------------------------------ (2)
def test_node_added_event_and_capacity_wait(c):
    def case():
        trainer = (c.train.JaxTrainer if c.name == "jax" else c.train.TorchTrainer)(
            lambda config: None,
            scaling_config=_scaling(c, num_workers=1, resources_per_worker={"cap_probe": 1.0}))
        before = trainer._feasible_workers()
        t0 = time.monotonic()
        short = trainer._wait_for_capacity(1, timeout_s=0.8)
        short_s = time.monotonic() - t0
        watcher = c.events.NodeEventWatcher(c.gcs)
        added = {}

        def add_soon():
            time.sleep(0.4)
            added["node"] = c.cluster.add_node(num_cpus=1, resources={"cap_probe": 1.0})

        threading.Thread(target=add_soon, daemon=True).start()
        try:
            waited = trainer._wait_for_capacity(1, timeout_s=20.0)
            after = trainer._feasible_workers()
            seen_added = wait_for(lambda: added.get("node") in watcher.added, timeout=10)
        finally:
            watcher.stop()
        wait_for(lambda: "node" in added, timeout=10)
        c.cluster.remove_node(added["node"])
        return {"before": before, "short": short, "short_fast": short_s < 5.0,
                "waited": waited, "after": after, "added_event": bool(seen_added)}

    seen = bounded(case, CASE_TIMEOUT)
    assert seen == {"before": 0, "short": False, "short_fast": True, "waited": True,
                    "after": 1, "added_event": True}
    _agree("capacity_wait", c.name, seen)


# ------------------------------------------------------------------ (3)
def test_renegotiate_downsizes_or_fails_fast(c):
    """Against the head (2 CPUs) alone, a 50-worker gang of 1 CPU each."""

    def case():
        Trainer = c.train.JaxTrainer if c.name == "jax" else c.train.TorchTrainer

        def make(**kw):
            t = Trainer(lambda config: None, scaling_config=_scaling(
                c, num_workers=50, resources_per_worker={"CPU": 1.0}, capacity_wait_s=0.5,
                **kw))
            t._world_size = 50
            return t

        elastic = make(elastic=True, min_workers=1)
        ok = elastic._renegotiate_capacity(0.5)
        rigid = make()
        rigid_ok = rigid._renegotiate_capacity(0.5)
        floor = make(elastic=True, min_workers=40)
        floor_ok = floor._renegotiate_capacity(0.5)
        out = {"elastic": (ok, elastic._world_size), "rigid": rigid_ok, "floor": floor_ok}
        for label, t in (("rigid_error", rigid), ("floor_error", floor)):
            err = t._capacity_error
            assert isinstance(err, c.exc.CapacityTimeoutError)
            assert isinstance(err, TimeoutError)
            out[label] = (err.needed, err.feasible, err.waited_s, err.min_workers, str(err))
        return out

    seen = bounded(case, CASE_TIMEOUT)
    assert seen["elastic"][0] is True and 1 <= seen["elastic"][1] < 50
    assert seen["rigid"] is False and seen["floor"] is False
    assert seen["rigid_error"][0] == 50 and seen["rigid_error"][1] >= 1
    assert seen["rigid_error"][3] == 0 and seen["floor_error"][3] == 40
    _agree("renegotiate", c.name, seen)


# ------------------------------------------------------------------ (4)
def _deterministic_train_loop(n_steps: int, step_sleep: float):
    """test_chaos.py's loop, with the step each attempt started at."""

    def loop(config):
        import importlib
        import time

        train = importlib.import_module(config["train"])
        w, start, history, starts = 1.0, 0, [], []
        ckpt = train.get_checkpoint()
        if ckpt is not None:
            d = ckpt.to_dict()
            start, w = d["step"] + 1, d["w"]
            history, starts = list(d["history"]), list(d["starts"])
        starts.append(start)
        for step in range(start, n_steps):
            w = w * 0.9 + 0.1  # a deterministic "loss" trajectory
            history.append((step, round(w, 12)))
            train.report({"loss": w, "step": step}, checkpoint=train.Checkpoint.from_dict(
                {"step": step, "w": w, "history": history, "starts": starts}))
            if train.drain_requested():
                return  # the final checkpoint is reported: a clean drain
            time.sleep(step_sleep)

    return loop


def _golden_trajectory(n_steps: int):
    w, out = 1.0, []
    for step in range(n_steps):
        w = w * 0.9 + 0.1
        out.append((step, round(w, 12)))
    return out


@pytest.mark.parametrize("max_failures", [1, 0])
def test_preemption_drain_checkpoint_restore(c, max_failures, tmp_path):
    n_steps = 16
    name = f"preempt_{max_failures}"
    trial_dir = tmp_path / "exp" / name

    def case():
        first = c.cluster.add_node(num_cpus=2, resources={"train_slot": 1.0})
        restored_before = _count(c, c.imet.CHECKPOINTS_RESTORED)
        nodes = {}

        def orchestrate():
            if not wait_for(lambda: _ckpt_count(trial_dir) >= 2, timeout=90):
                return
            _preempt(c, first, 1.5).join()
            nodes["replacement"] = c.cluster.add_node(num_cpus=2,
                                                      resources={"train_slot": 1.0})

        threading.Thread(target=orchestrate, daemon=True).start()
        Trainer = c.train.JaxTrainer if c.name == "jax" else c.train.TorchTrainer
        trainer = Trainer(
            _deterministic_train_loop(n_steps, 0.2),
            train_loop_config={"train": c.train.__name__},
            scaling_config=_scaling(c, num_workers=1, resources_per_worker={"train_slot": 1.0}),
            run_config=c.train.RunConfig(
                name=name, storage_path=str(tmp_path / "exp"),
                failure_config=c.train.FailureConfig(max_failures=max_failures)))
        result = trainer.fit()
        assert wait_for(lambda: "replacement" in nodes, timeout=30)
        c.cluster.remove_node(nodes["replacement"])
        assert result.error is None, f"training did not recover: {result.error!r}"
        final = result.checkpoint.to_dict()
        return {"history": [tuple(x) for x in final["history"]],
                "attempts": len(final["starts"]), "final_step": final["step"],
                "resumed_after_drain": final["starts"][1] >= 2,
                "drain_wait": result.metrics["goodput_seconds"]["drain_wait"] > 0,
                "restores": _count(c, c.imet.CHECKPOINTS_RESTORED) - restored_before}

    seen = bounded(case, CASE_TIMEOUT)
    # Same-step resume: every step exactly once, the fault-free trajectory.
    assert seen["history"] == _golden_trajectory(n_steps)
    assert seen == {"history": seen["history"], "attempts": 2, "final_step": n_steps - 1,
                    "resumed_after_drain": True, "drain_wait": True, "restores": 1}
    _agree(f"restore_{max_failures}", c.name, seen)


# ------------------------------------------------------------------ (5)
def _elastic_train_loop(n_steps: int, step_sleep: float):
    """test_elastic.py's loop: a world-size dependent recurrence, so a
    resumed trajectory must match a run at that world size."""

    def loop(config):
        import importlib
        import time

        train = importlib.import_module(config["train"])
        world = train.get_context().get_world_size()
        w, start, history = 1.0, 0, []
        ckpt = train.get_checkpoint()
        if ckpt is not None:
            d = ckpt.to_dict()
            start, w, history = d["step"] + 1, d["w"], list(d["history"])
        for step in range(start, n_steps):
            w = round(w * 0.9 + 0.1 / world, 12)
            history.append((step, w, world))
            train.report({"loss": w, "step": step, "world": world},
                         checkpoint=train.Checkpoint.from_dict(
                             {"step": step, "w": w, "history": history}))
            if train.drain_requested():
                return  # the final checkpoint is reported: a clean drain
            time.sleep(step_sleep)

    return loop


def _replay_reference(history, n_steps):
    """Replays the recurrence with the recorded world sizes."""
    w = 1.0
    for i, (step, value, world) in enumerate(history):
        assert step == i, f"gap/repeat at {i}: {history[i]}"
        w = round(w * 0.9 + 0.1 / world, 12)
        assert value == w, f"step {i} diverged: {value} != {w} at world {world}"
    assert len(history) == n_steps


def _flight_events(c, since_us):
    """(ts_us, kind) of this process's flight ring from `since_us` on."""
    return [(ts, kind) for ts, kind, _ in c.frec.RECORDER.snapshot() if ts >= since_us]


def test_elastic_downsize_growback(c, tmp_path):
    n_steps = 150
    trial_dir = tmp_path / "exp" / "elastic"

    def case():
        gang = [c.cluster.add_node(num_cpus=2, resources={"train_slot": 1.0})
                for _ in range(2)]
        imet = c.imet
        downsize_before = _count(c, imet.TRAIN_ELASTIC_RESIZES, direction="downsize")
        growback_before = _count(c, imet.TRAIN_ELASTIC_RESIZES, direction="growback")
        added = {}

        def orchestrate():
            # Preempt one gang node once training progressed; no
            # replacement until the trainer downsized, then one node.
            if not wait_for(lambda: _ckpt_count(trial_dir) >= 2, timeout=90):
                return
            _preempt(c, gang[0], 1.5)
            if not wait_for(lambda: _count(c, imet.TRAIN_ELASTIC_RESIZES, direction="downsize")
                            > downsize_before, timeout=90):
                return
            at = _ckpt_count(trial_dir)
            wait_for(lambda: _ckpt_count(trial_dir) >= at + 2, timeout=60)
            added["node"] = c.cluster.add_node(num_cpus=2, resources={"train_slot": 1.0})

        threading.Thread(target=orchestrate, daemon=True).start()
        run_start_us = time.time_ns() // 1000
        Trainer = c.train.JaxTrainer if c.name == "jax" else c.train.TorchTrainer
        result = Trainer(
            _elastic_train_loop(n_steps, 0.05),
            train_loop_config={"train": c.train.__name__},
            scaling_config=_scaling(c, num_workers=2, elastic=True, min_workers=1,
                                    capacity_wait_s=3.0,
                                    resources_per_worker={"train_slot": 1.0}),
            run_config=c.train.RunConfig(
                name="elastic", storage_path=str(tmp_path / "exp"),
                failure_config=c.train.FailureConfig(max_failures=1))).fit()
        assert wait_for(lambda: "node" in added, timeout=30)
        for nid in (gang[1], added["node"]):
            c.cluster.remove_node(nid)
        assert result.error is None, f"run did not recover: {result.error!r}"
        final = result.checkpoint.to_dict()
        history = [tuple(h) for h in final["history"]]
        _replay_reference(history, n_steps)
        worlds = [h[2] for h in history]
        first_one = worlds.index(1)
        last_one = len(worlds) - 1 - worlds[::-1].index(1)
        kinds = {}
        for ts, kind in _flight_events(c, run_start_us):
            kinds.setdefault(kind, ts)
        order = [kinds.get(k) for k in ("train.drain", "train.elastic_downsize",
                                        "train.elastic_growback")]
        return {"final_step": final["step"], "first_world": worlds[0],
                "last_world": worlds[-1],
                "one_window": set(worlds[first_one:last_one + 1]) == {1},
                "degraded": result.metrics["goodput_seconds"]["degraded"] > 0,
                "goodput_below_1": result.metrics["goodput"] < 1.0,
                "downsizes": _count(c, imet.TRAIN_ELASTIC_RESIZES, direction="downsize")
                - downsize_before,
                "growbacks": _count(c, imet.TRAIN_ELASTIC_RESIZES, direction="growback")
                - growback_before,
                "ordered": None not in order and order == sorted(order)}

    seen = bounded(case, CASE_TIMEOUT)
    assert seen == {"final_step": n_steps - 1, "first_world": 2, "last_world": 2,
                    "one_window": True, "degraded": True, "goodput_below_1": True,
                    "downsizes": 1, "growbacks": 1, "ordered": True}
    _agree("elastic", c.name, seen)


# ------------------------------------------------------------------ (6)
def test_serve_replaces_replicas_on_draining_node(c):
    def case():
        serve = importlib.import_module(f"{PACKAGES[c.name]}.serve")
        controller_mod = importlib.import_module(f"{PACKAGES[c.name]}.serve.controller")
        rt = c.pkg
        slots = [c.cluster.add_node(num_cpus=2, resources={"serve_slot": 1.0})
                 for _ in range(2)]

        @serve.deployment(num_replicas=1, ray_actor_options={"resources": {"serve_slot": 1.0}})
        class Echo:
            def __call__(self, x):
                return x

        handle = serve.run(Echo.bind(), name="echo_drain", http_port=None)
        try:
            assert handle.remote("hi").result(timeout=60) == "hi"
            controller = controller_mod.get_or_create_controller()

            def replica_ids():
                _, replicas = rt.get(controller.get_replicas.remote("echo_drain"), timeout=30)
                return [r._actor_id.hex() for r in replicas]

            before = replica_ids()
            victim = c.events.actor_locations(c.gcs)[before[0]]
            stop, calls, failures = threading.Event(), [0], []

            def client():
                i = 0
                while not stop.is_set():
                    try:
                        assert handle.remote(i).result(timeout=30) == i
                        calls[0] += 1
                    except Exception as e:  # noqa: BLE001 - counted and reported
                        failures.append(repr(e))
                    i += 1

            caller = threading.Thread(target=client, daemon=True)
            caller.start()
            remover = _preempt(c, victim, 60.0)
            replaced = wait_for(lambda: replica_ids() and replica_ids() != before, timeout=60)
            after = replica_ids()
            where = c.events.actor_locations(c.gcs).get(after[0]) if after else None
            time.sleep(0.5)  # requests keep landing on the new replica
            stop.set()
            caller.join(30)
            still_up = handle.remote("still-up").result(timeout=60)
        finally:
            serve.shutdown()
        for nid in slots:
            if nid != victim:
                c.cluster.remove_node(nid)
        c.gcs.call("report_preemption", victim, 0.0, "test over")
        return {"before": len(before), "replaced": bool(replaced), "after": len(after),
                "new_actor": after != before, "moved": where not in (None, victim),
                "on_slot_node": where in slots, "failed": failures, "called": calls[0] > 0,
                "still_up": still_up, "remover": remover}

    seen = bounded(case, CASE_TIMEOUT)
    seen.pop("remover").finish()  # the victim goes now, not at its deadline after the test
    assert seen == {"before": 1, "replaced": True, "after": 1, "new_actor": True,
                    "moved": True, "on_slot_node": True, "failed": [], "called": True,
                    "still_up": "still-up"}
    _agree("serve_drain", c.name, seen)


# ------------------------------------------- the port's own: GPUs on added nodes
def _visible_devices():
    return os.environ.get("CUDA_VISIBLE_DEVICES")


class _Probe:
    def pid(self):
        return os.getpid()


def test_added_node_leases_gpu_ids_and_dies_with_its_workers(clusters):
    """`Cluster.add_node(num_gpus=1)` leases device id "0" to a GPU task's
    worker (CUDA_VISIBLE_DEVICES, as on the head; faked on the CPU), and
    `remove_node` leaves none of the node's processes running, the workers
    forked from its zygote included."""
    from ray_tpu_torch.core import cluster_runtime as cr

    c = clusters.get("torch")
    rt = c.pkg

    def case():
        node = c.cluster.add_node(num_cpus=1, num_gpus=1, resources={"gpu_probe": 1.0})
        res = {n["NodeID"]: n for n in c.gcs.call("list_nodes")}[node]["Resources"]
        task = rt.remote(num_gpus=1, resources={"gpu_probe": 1.0})(_visible_devices)
        visible = rt.get(task.remote(), timeout=60)
        actor = rt.remote(resources={"gpu_probe": 0.5})(_Probe).remote()
        pid = rt.get(actor.pid.remote(), timeout=60)
        procs = cr._node_processes(c.cluster.session_dir, node)
        c.cluster.remove_node(node)
        return res, visible, pid, procs, [p for p in procs if cr._running(p)]

    try:
        res, visible, pid, procs, running = bounded(case, CASE_TIMEOUT)
    finally:
        c.base.set_runtime(None)
    assert res["GPU"] == 1.0 and visible == "0"
    assert pid in procs and len(procs) >= 3  # the raylet, its zygote, the actor's worker
    assert running == []


def test_use_gpu_trainer_on_the_cluster_raises_without_a_device(clusters, tmp_path):
    """An elastic GPU run on the cluster runtime is refused before any
    attempt on a machine without CUDA, and a worker asked for the card
    raises rather than train on the CPU (a restored gang's workers run the
    same start_training)."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this checks the refusal on a machine without a CUDA device")
    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer
    from ray_tpu_torch.train.worker_group import WorkerGroup

    c = clusters.get("torch")
    try:
        sc = ScalingConfig(num_workers=1, elastic=True, min_workers=1, capacity_wait_s=1.0)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TorchTrainer(lambda config: None, scaling_config=sc,
                         run_config=RunConfig(storage_path=str(tmp_path))).fit()
        assert not os.listdir(tmp_path)

        def case():
            group = WorkerGroup(1)
            try:
                ref = group.workers[0].start_training.remote(
                    lambda: None, {}, "gpu_refused", None, sc.mesh, True)
                with pytest.raises(Exception, match="no CUDA device"):
                    c.pkg.get(ref, timeout=60)
            finally:
                group.shutdown()

        bounded(case, CASE_TIMEOUT)
    finally:
        c.base.set_runtime(None)
