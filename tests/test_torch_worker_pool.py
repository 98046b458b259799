"""The port's warm worker pool and zygote (ray_tpu_torch/core/{zygote,
worker_pool}.py) against the JAX package's, case by case: tests/
test_worker_pool.py's cases, each run on both packages against its own
zygote daemon or pool cluster (the parked pool's fill, pop and reset, a
batch in one round trip, the pool's shrink, the launch-rate window, a warm
hit with its refill, env-key sub-pools, a forecast presizing the pool,
batched actor registration, pool stats on the heartbeat, and the zygote's
death, respawn and rebuild).

`test_instance_manager_relays_forecast` is
tests/test_torch_autoscaler.py's `test_instance_manager_relays_forecast_once`;
`test_on_fence_drains_prefork` waits for epoch fencing (item
3.9), the only caller of the pool's fence hook.

Env keys: both packages key workers by their runtime env, and a worker
with user env_vars Popens (a fork from the zygote would keep the zygote's
imports), in its own sub-pool, while the default pool's warm workers stay
where they are. The port's key also holds the GPU ids a worker sees, and
such a worker still forks from the zygote (CUDA reads CUDA_VISIBLE_DEVICES
at its first cuInit): a case of its own. One more case proves the port's
zygote imports torch without initialising CUDA. Two cases hold the port's
repairs of the reference: a forked child's exit status reaches its
PidHandle, and a batch-forked worker that polls before its registration is
not told to stop.
"""

import functools
import importlib
import json
import os
import subprocess
import sys
import tempfile
import time
import types

import pytest

from ray_tpu_torch.core import serialization
import torch_modes
from torch_waits import wait_for

serialization.register_pickle_by_value(sys.modules[__name__])

PKGS = ("jax", "torch")
_ROOT = {"jax": "ray_tpu", "torch": "ray_tpu_torch"}


def _children_of(pid):
    try:
        with open(f"/proc/{pid}/task/{pid}/children") as f:
            return [int(p) for p in f.read().split()]
    except OSError:
        return []


def _alive(pid):
    """Running and not a zombie waiting for the zygote's reap."""
    try:
        with open(f"/proc/{pid}/stat", "rb") as f:
            return f.read().rsplit(b") ", 1)[1].split()[0] != b"Z"
    except OSError:
        return False


def _children(ppid):
    """Live (not zombie) processes whose parent is `ppid`."""
    kids = []
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat", "rb") as f:
                fields = f.read().rsplit(b") ", 1)[1].split()
        except OSError:
            continue
        if int(fields[1]) == ppid and fields[0] != b"Z":
            kids.append(int(d))
    return kids


def _pids_with_arg(arg):
    """Pids of the processes that have `arg` among their command line's words."""
    pids = []
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/cmdline", "rb") as f:
                words = f.read().split(b"\0")
        except OSError:
            continue
        if arg.encode() in words:
            pids.append(int(d))
    return pids


# ---------------------------------------------------------------- zygote unit
@pytest.fixture(params=PKGS)
def zygote_daemon(request):
    """A zygote daemon of each package on a private socket (no cluster)."""
    name = request.param
    zmod = importlib.import_module(f"{_ROOT[name]}.core.zygote")
    d = tempfile.mkdtemp(prefix="zyg_test_")
    sock = os.path.join(d, "zyg.sock")
    with open(os.path.join(d, "zyg.log"), "ab") as log:
        proc = subprocess.Popen([sys.executable, "-m", f"{_ROOT[name]}.core.zygote", sock],
                                stdout=log, stderr=log)
    try:
        client = zmod.ZygoteClient(sock)

        def probe():
            try:
                return os.path.exists(sock) and client.stats()
            except OSError:
                return None

        assert wait_for(probe, timeout=60, interval=0.1), "zygote never answered"
        yield types.SimpleNamespace(name=name, proc=proc, client=client, dir=d, zmod=zmod)
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.wait(timeout=5)


def _spawn_spec(z, tag):
    # argv that worker_proc cannot use: the assigned child exits at once.
    # These cases check the fork protocol (pids, warm flags, the pool's
    # accounting), not a worker's boot.
    return z.zmod.ZygoteClient.spawn_spec(
        ["nonexistent.sock", "nonexistent_store", "nonexistent_gcs", tag, "node"],
        {"PATH": os.environ.get("PATH", "")},
        os.path.join(z.dir, f"{tag}.out"), os.path.join(z.dir, f"{tag}.err"))


def _unpack(spec):
    return spec["argv"], spec["env"], spec["out"], spec["err"]


def test_prefork_pool_fill_pop_and_reset(zygote_daemon):
    z = zygote_daemon
    reply = z.client.ensure_pool(3)
    assert reply["parked"] == 3 and reply["forked"] == 3
    parked = _children_of(z.proc.pid)
    assert len(parked) >= 3
    pid, warm = z.client.spawn(*_unpack(_spawn_spec(z, "w1")))  # a pop, not a fork
    assert warm is True and pid in parked
    assert z.client.stats()["parked"] == 2
    assert z.client.ensure_pool(3)["parked"] == 3
    assert z.client.reset() == 3  # every parked child drained
    assert z.client.stats()["parked"] == 0
    assert wait_for(lambda: not any(_alive(p) for p in _children_of(z.proc.pid)),
                    timeout=15), f"parked children survived reset: {_children_of(z.proc.pid)}"


def test_batch_spawn_one_round_trip(zygote_daemon):
    z = zygote_daemon
    z.client.ensure_pool(2)
    results = z.client.spawn_batch([_spawn_spec(z, f"b{i}") for i in range(4)])
    assert len(results) == 4
    assert [w for _, w in results].count(True) == 2  # the parked two, then cold forks
    assert len({pid for pid, _ in results}) == 4
    assert z.client.stats()["parked"] == 0


def test_pool_shrink(zygote_daemon):
    z = zygote_daemon
    assert z.client.ensure_pool(4)["parked"] == 4
    assert z.client.ensure_pool(1)["parked"] == 1


def test_zygote_imports_torch_without_initialising_cuda():
    """The port's zygote holds torch (what it saves a worker) and has never
    initialised CUDA, so none of its children is in a bad fork."""
    from ray_tpu_torch.core.zygote import ZygoteClient

    d = tempfile.mkdtemp(prefix="zyg_cuda_")
    sock = os.path.join(d, "zyg.sock")
    with open(os.path.join(d, "zyg.log"), "ab") as log:
        proc = subprocess.Popen([sys.executable, "-m", "ray_tpu_torch.core.zygote", sock],
                                stdout=log, stderr=log)
    try:
        client = ZygoteClient(sock)
        assert wait_for(lambda: os.path.exists(sock), timeout=60, interval=0.1)
        stats = client.stats()
        assert stats["cuda_initialized"] is False
        maps = open(f"/proc/{stats['pid']}/maps").read()
        assert "libtorch" in maps  # torch is imported before any fork
    finally:
        proc.kill()
        proc.wait(timeout=5)


# ------------------------------------------------------------- manager units
@pytest.mark.parametrize("name", PKGS)
def test_launch_rate_window(name):
    LaunchRate = importlib.import_module(f"{_ROOT[name]}.core.worker_pool").LaunchRate
    r = LaunchRate(window_s=0.3)
    assert r.per_s() == 0.0
    for _ in range(6):
        r.note()
    assert r.per_s() == pytest.approx(6 / 0.3)
    time.sleep(0.4)
    assert r.per_s() == 0.0


# ------------------------------------------------------------ cluster-backed
def _boot(name, **kw):
    """A cluster of `name`'s package with a prestarted pool; its runtime is
    the package's current one."""
    rt = importlib.import_module(_ROOT[name])
    base = importlib.import_module(f"{_ROOT[name]}.core.runtime_base")
    Cluster = importlib.import_module(f"{_ROOT[name]}.core.cluster_runtime").Cluster
    if name == "torch":
        kw["num_gpus"] = 2  # device ids to lease; no CUDA device is touched
    boot = (torch_modes.boot_jax_cluster if name == "jax"
            else functools.partial(torch_modes.boot_cluster, Cluster))
    cluster = boot(num_cpus=4, object_store_memory=192 << 20, **kw)
    runtime = cluster.runtime()
    base.set_runtime(runtime)
    return types.SimpleNamespace(name=name, rt=rt, cluster=cluster, runtime=runtime, base=base,
                                 exc=importlib.import_module(f"{_ROOT[name]}.exceptions"))


def _stop(c):
    try:
        torch_modes.shutdown_cluster(c.cluster, c.runtime.shutdown)
    finally:
        if c.base.maybe_runtime() is c.runtime:
            c.base.set_runtime(None)


def _pool(c):
    return c.runtime._raylet.call("debug_state")["pool"]


@pytest.fixture(scope="module")
def pool_clusters():
    booted = {}
    for name in PKGS:
        importlib.import_module(_ROOT[name]).shutdown()
    try:
        for name in PKGS:
            booted[name] = _boot(name, num_workers=2)
        for c in booted.values():
            # Let the zygote and the prestart settle, so the cases measure
            # the pool and not its boot.
            assert wait_for(lambda: (p := _pool(c)).get("ready", 0) >= 2
                            and p.get("zygote_alive"), timeout=120, interval=0.25), (
                f"{c.name}: prestart pool never settled")
        yield booted
    finally:
        for c in booted.values():
            _stop(c)


@pytest.fixture(params=PKGS)
def pc(request, pool_clusters):
    c = pool_clusters[request.param]
    c.base.set_runtime(c.runtime)
    return c


def test_warm_hit_and_async_refill(pc):
    rt = pc.rt
    before = _pool(pc)

    @rt.remote
    class A:
        def ping(self):
            return 1

    a = A.remote()
    try:
        assert rt.get(a.ping.remote(), timeout=60) == 1
        after = _pool(pc)
        assert after["hits"]["idle"] > before["hits"]["idle"]  # adopted a pooled worker
        assert wait_for(lambda: _pool(pc)["ready"] >= 2, timeout=60, interval=0.25), (
            f"pool never refilled: {_pool(pc)}")
    finally:
        rt.kill(a)


def test_env_key_subpool_isolation(pc):
    """A runtime env with user env_vars: its worker Popens into a sub-pool
    of its own, and no warm worker of the default pool is taken."""
    rt = pc.rt
    before = _pool(pc)

    @rt.remote(runtime_env={"env_vars": {"POOL_ISOLATION_PROBE": "1"}})
    class E:
        def probe(self, var):
            return os.environ.get(var)

    e = E.remote()
    try:
        assert rt.get(e.probe.remote("POOL_ISOLATION_PROBE"), timeout=120) == "1"
        after = _pool(pc)
        assert after["misses"]["popen"] > before["misses"]["popen"], (before, after)
        assert after["hits"]["idle"] == before["hits"]["idle"], (before, after)
    finally:
        rt.kill(e)


def test_gpu_ids_subpool_forks(pool_clusters):
    """The port's GPU-id key: a num_gpus=1 worker sees its lease in
    CUDA_VISIBLE_DEVICES and still forks from the zygote, in its own
    sub-pool."""
    c = pool_clusters["torch"]
    c.base.set_runtime(c.runtime)
    rt = c.rt
    before = _pool(c)

    @rt.remote(num_gpus=1)
    class E:
        def probe(self, var):
            return os.environ.get(var)

    e = E.remote()
    try:
        assert rt.get(e.probe.remote("CUDA_VISIBLE_DEVICES"), timeout=120) == "0"
        after = _pool(c)
        forks = lambda p: p["hits"]["prefork"] + p["misses"]["zygote"]  # noqa: E731
        assert forks(after) > forks(before), (before, after)
        assert after["misses"]["popen"] == before["misses"]["popen"], (before, after)
        assert after["hits"]["idle"] == before["hits"]["idle"], (before, after)
    finally:
        rt.kill(e)


def test_forecast_presizes_pool(pc):
    rt = pc.rt
    pc.runtime._gcs.call("report_demand_forecast", 5, 90.0)
    assert wait_for(lambda: _pool(pc)["target"] >= 5, timeout=30, interval=0.25), (
        f"forecast never reached the pool target: {_pool(pc)}")
    assert wait_for(lambda: _pool(pc)["ready"] >= 5, timeout=120, interval=0.25), (
        f"pool never pre-sized: {_pool(pc)}")

    @rt.remote
    class A:
        def ping(self):
            return 1

    before = _pool(pc)
    actors = [A.remote() for _ in range(5)]
    try:
        assert rt.get([a.ping.remote() for a in actors], timeout=120) == [1] * 5
        after = _pool(pc)
        assert after["hits"]["idle"] >= before["hits"]["idle"] + 5  # rode the pool warm
        # Registrations consumed the forecast: the target decays.
        assert wait_for(lambda: _pool(pc)["target"] <= 4, timeout=30, interval=0.25), (
            f"forecast never decayed: {_pool(pc)}")
    finally:
        for a in actors:
            rt.kill(a)


def test_batched_registration_and_name_errors(pc):
    rt = pc.rt

    @rt.remote(name="pool-named-actor")
    class N:
        def ping(self):
            return 1

    n = N.remote()
    try:
        assert rt.get(n.ping.remote(), timeout=60) == 1
        with pytest.raises(pc.exc.ActorNameTakenError):
            N.remote()
    finally:
        rt.kill(n)


def test_pool_stats_ride_heartbeat(pc):
    def has_pool():
        for n in pc.runtime._gcs.call("list_nodes"):
            pool = (n.get("Stats") or {}).get("pool")
            if pool and "ready" in pool and "hits" in pool:
                return pool
        return None

    assert wait_for(has_pool, timeout=30, interval=0.25)


def test_forked_worker_is_not_in_a_bad_fork(pool_clusters):
    """A worker forked from the port's zygote may use CUDA: the zygote never
    initialised it, so torch does not flag the child's fork as bad."""
    c = pool_clusters["torch"]
    c.base.set_runtime(c.runtime)

    @c.rt.remote
    def state():
        import torch

        return os.getppid(), torch.cuda.is_initialized(), torch.cuda._is_in_bad_fork()

    ppid, initialised, bad = c.rt.get(state.remote(), timeout=60)
    assert ppid == _pool(c)["zygote_pid"]  # forked from the zygote
    assert (initialised, bad) == (False, False)


# ----------------------------------------------------- zygote death (chaos)
@pytest.mark.parametrize("name", PKGS)
def test_zygote_death_respawn_rebuild(name):
    """A chaos `zygote.spawn` kill point SIGKILLs the daemon at a spawn
    request: that launch falls back to Popen and succeeds, the pool manager
    finds the corpse, respawns the zygote and rebuilds the parked pool."""
    saved = {k: os.environ.get(k) for k in ("RAY_TPU_CHAOS", "RAY_TPU_CHAOS_SEED")}
    os.environ["RAY_TPU_CHAOS"] = json.dumps(
        [{"point": "zygote.spawn", "action": "kill", "times": 1}])
    os.environ["RAY_TPU_CHAOS_SEED"] = "0"
    c = None
    try:
        c = _boot(name, num_workers=0)
        for k, v in saved.items():  # the raylet has read them
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        rt = c.rt
        assert wait_for(lambda: _pool(c).get("zygote_alive"), timeout=120, interval=0.25), (
            "zygote never came up")

        @rt.remote
        class A:
            def ping(self):
                return 1

        a = A.remote()  # its spawn trips the kill point
        assert rt.get(a.ping.remote(), timeout=180) == 1
        pool = wait_for(lambda: (p := _pool(c)).get("zygote_respawns", 0) >= 1
                        and p.get("zygote_alive") and p, timeout=120, interval=0.25)
        assert pool, "zygote never respawned after the chaos kill"
        b = A.remote()  # the new daemon serves forks again
        assert rt.get(b.ping.remote(), timeout=180) == 1
        assert wait_for(lambda: _pool(c).get("preforked", 0) >= 1, timeout=120,
                        interval=0.25), "parked pool never rebuilt after the respawn"
        rt.kill(a)
        rt.kill(b)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        if c is not None:
            _stop(c)


# ------------------------------------------------- a slow zygote stays up
def test_slow_zygote_keeps_its_workers():
    """A zygote that answers a spawn too late (SIGSTOPped here, a loaded
    machine in the suite) is slow, not dead: that one spawn Popens, and the
    daemon and every worker it forked live on. Killing it took its forked
    actors' workers with it (pdeathsig), which failed Tune trials under load
    (ROADMAP Queue 3)."""
    import signal

    c = _boot("torch", num_workers=0)
    try:
        rt = c.rt
        assert wait_for(lambda: _pool(c).get("zygote_alive") and _pool(c)["preforked"] >= 1,
                        timeout=120, interval=0.25), "zygote never came up"

        @rt.remote
        class A:
            def __init__(self):
                self.n = 0

            def ppid(self):
                return os.getppid()

            def pid(self):
                return os.getpid()

            def incr(self):
                self.n += 1
                return self.n

        a = A.remote()
        zpid = _pool(c)["zygote_pid"]
        assert rt.get(a.ppid.remote(), timeout=60) == zpid  # forked from the zygote
        before = _pool(c)
        os.kill(zpid, signal.SIGSTOP)
        try:
            b = A.remote()  # its spawn request times out: a Popen
            assert rt.get(b.ppid.remote(), timeout=120) != zpid
        finally:
            os.kill(zpid, signal.SIGCONT)
        assert rt.get(a.ppid.remote(), timeout=60) == zpid  # the forked actor lives
        after = _pool(c)
        assert after["misses"]["popen"] == before["misses"]["popen"] + 1, (before, after)
        assert after["zygote_pid"] == zpid and after["zygote_respawns"] == 0, after

        # The timed-out request was still queued on the daemon's socket. It
        # serves requests in order, so once this one is answered that one
        # has been read; it must start no second worker for b.
        c.runtime._raylet.call("zygote_stats")
        b_pid = rt.get(b.pid.remote(), timeout=60)
        b_wid = next(wid for wid, w in c.runtime._raylet.call("debug_state")["workers"].items()
                     if w["pid"] == b_pid)
        assert _pids_with_arg(b_wid) == [b_pid]
        assert rt.get(a.pid.remote(), timeout=60) in _children(zpid)

        def unadopted():
            """The zygote's children the raylet does not know, beyond its
            parked ones (an in-flight refill shows here for a moment)."""
            known = {w["pid"] for w in c.runtime._raylet.call("debug_state")["workers"].values()}
            parked = c.runtime._raylet.call("zygote_stats").get("parked", 0)
            return len([p for p in _children(zpid) if p not in known]) - parked

        assert wait_for(lambda: unadopted() == 0, timeout=30, interval=0.5), (
            _children(zpid), c.runtime._raylet.call("debug_state")["workers"])
        assert [rt.get(b.incr.remote(), timeout=60) for _ in range(10)] == list(range(1, 11))
        rt.kill(a)
        rt.kill(b)
    finally:
        _stop(c)


# ------------------------------------------------- the zygote outlives nothing
def test_zygote_exits_when_its_raylet_dies_during_its_imports(tmp_path):
    """The raylet passes its pid to the zygote, which exits once that is no
    longer its parent: a raylet that dies while the zygote still imports
    (or before its first line ran) leaves no zygote behind."""
    sock = str(tmp_path / "zyg.sock")
    parent = subprocess.run(
        [sys.executable, "-c",
         "import os, subprocess, sys; "
         f"p = subprocess.Popen([sys.executable, '-m', 'ray_tpu_torch.core.zygote', {sock!r}, "
         "str(os.getpid())], stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL); "
         "print(p.pid)"],
        capture_output=True, text=True, timeout=60, check=True)
    zpid = int(parent.stdout.split()[-1])  # the parent has exited: the zygote is an orphan
    try:
        assert wait_for(lambda: not _alive(zpid), timeout=60, interval=0.2), (
            "the zygote outlived the process that started it")
    finally:
        if _alive(zpid):
            os.kill(zpid, 9)


def test_pool_stop_before_the_zygote_boots_starts_none(tmp_path):
    """stop() and the maintenance thread's boot are ordered: once stop()
    has begun, no zygote is started for the raylet that is going away."""
    import threading

    from ray_tpu_torch.core.worker_pool import WorkerPoolManager

    class _Raylet:
        node_id = "stubnode00000"
        sock_path = str(tmp_path / "raylet.sock")
        _log_dir = str(tmp_path)
        _workers_lock = threading.Lock()
        _idle = {}
        _workers = {}

    mgr = WorkerPoolManager(_Raylet())
    mgr.stop()
    assert mgr._boot_zygote() is False
    assert mgr._zygote_proc is None


# ------------------------------------------------ a forked worker's status
def test_zygote_keeps_a_forked_workers_exit_status(zygote_daemon):
    """A forked child's exit status reaches its PidHandle. The port's zygote
    writes it to the file the spawn named before it reaps the child, and
    PidHandle reads it once /proc shows the pid gone: the child here exits
    1 (worker_proc cannot open the store it is given), a cold fork and a
    parked child alike. The JAX zygote drops the status, so its PidHandle
    reads -1 (ROADMAP Queue 3: a fault of the reference the port does not
    copy)."""
    z = zygote_daemon
    got = []
    for tag, parked in (("cold", False), ("warm", True)):
        if parked:
            assert z.client.ensure_pool(1)["parked"] == 1
        spec = _spawn_spec(z, tag)
        status = os.path.join(z.dir, f"{tag}.exit")
        if z.name == "torch":
            pid, warm = z.client.spawn(*_unpack(spec), status=status)
            handle = z.zmod.PidHandle(pid, status)
        else:
            pid, warm = z.client.spawn(*_unpack(spec))
            handle = z.zmod.PidHandle(pid)
        assert warm is parked
        assert wait_for(lambda: handle.poll() is not None, timeout=60, interval=0.05)
        got.append(handle.poll())
    if z.name == "torch":
        assert got == [1, 1]
        assert all(open(os.path.join(z.dir, f"{t}.exit")).read() == "1" for t in ("cold", "warm"))
    else:
        assert got == [-1, -1]


def test_batch_spawned_worker_polling_early_is_not_stopped(tmp_path):
    """A worker forked in a batched prestart can poll its raylet before the
    batch's reply is registered. The raylet used to answer that poll with
    "stop": the worker exited 0 with no output, and an actor the raylet
    then placed on it died with "worker process died" (the intermittent
    test_torch_tune.py failure, ROADMAP Queue 3; a raylet log kept from a
    run of the port's cluster files together showed the poll from an
    unknown worker, its exit 0 and the actor's death). The poll now gets a
    "noop" while the id is being registered, and "stop" only once the id is
    not the raylet's."""
    import threading

    from ray_tpu_torch.core import raylet as rmod

    replies = {}

    class _Pool:
        def zygote_spawn_batch(self, specs):
            # The children poll before this reply lands.
            for spec in specs:
                wid = spec["argv"][3]
                replies[wid] = svc.worker_poll(wid)
            return [(os.getpid(), True) for _ in specs]

    svc = rmod.RayletService.__new__(rmod.RayletService)
    svc.node_id, svc.sock_path, svc.store_path, svc.gcs_sock = "n" * 12, "r.sock", "s", "g.sock"
    svc._log_dir, svc._has_gpus = str(tmp_path), False
    svc._workers, svc._idle, svc._spawned_pids, svc._spawning = {}, {}, {}, set()
    svc._workers_lock, svc._leases = threading.Lock(), {}
    svc._sched_wake, svc._stop, svc._pool = threading.Event(), threading.Event(), _Pool()
    assert svc._prestart_idle(3) == 3
    assert len(replies) == 3 and all(r == {"type": "noop"} for r in replies.values()), replies
    assert sorted(svc._idle[""]) == sorted(replies) and not svc._spawning
    wid = next(iter(replies))
    svc._workers[wid].mailbox.put({"type": "task", "entry": {"task_id": "t"}})
    assert svc.worker_poll(wid)["type"] == "task"  # registered: served as usual
    assert svc.worker_poll("not-this-raylets")["type"] == "stop"  # a stray still stops
