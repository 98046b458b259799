"""The port's shared-memory object pool (ray_tpu_torch/native/shm_pool.cc,
ray_tpu_torch/core/shm_store.py) against the JAX package's: tests/
test_shm_store.py's cases, each run on both packages; then a JAX pool and a
port pool side by side in /dev/shm, where neither package's sweep of
orphaned pools touches the other's.
"""

import fcntl
import glob
import multiprocessing
import os
import tempfile
import types

import numpy as np
import pytest

PKGS = ("jax", "torch")


def _pkg(name):
    if name == "jax":
        from ray_tpu.core import ids, shm_store
        from ray_tpu.exceptions import ObjectStoreFullError
    else:
        from ray_tpu_torch.core import ids, shm_store
        from ray_tpu_torch.exceptions import ObjectStoreFullError
    return types.SimpleNamespace(Store=shm_store.SharedMemoryStore, ids=ids,
                                 Full=ObjectStoreFullError, name=name)


@pytest.fixture(params=PKGS)
def pkg(request):
    return _pkg(request.param)


@pytest.fixture
def store(pkg, tmp_path):
    s = pkg.Store.create(str(tmp_path / "pool"), capacity=64 << 20)
    yield s
    s.close()


def _oid(pkg):
    return pkg.ids.TaskID.for_task().object_id_for_return(0)


def test_put_get_roundtrip(pkg, store):
    oid = _oid(pkg)
    store.put(oid, {"a": 1, "b": [1, 2, 3], "s": "hello"})
    assert store.get(oid) == {"a": 1, "b": [1, 2, 3], "s": "hello"}


def test_numpy_zero_copy(pkg, store):
    oid = _oid(pkg)
    arr = np.arange(1 << 20, dtype=np.float32)
    store.put(oid, arr)
    out = store.get(oid)
    np.testing.assert_array_equal(out, arr)
    # The array aliases pool memory: while it lives the object is pinned.
    assert not store.delete(oid)
    del out
    assert store.delete(oid)


def test_get_returns_readonly_views(pkg, store):
    oid = _oid(pkg)
    store.put(oid, np.arange(1 << 20, dtype=np.float32))
    out = store.get(oid)
    with pytest.raises((ValueError, TypeError)):
        out[0] = 42


def test_idempotent_put(pkg, store):
    oid = _oid(pkg)
    store.put(oid, 1)
    store.put(oid, 2)  # a duplicate create is a no-op: the first value wins
    assert store.get(oid) == 1


def test_missing_object(pkg, store):
    with pytest.raises(KeyError):
        store.get(_oid(pkg))


def test_store_full_and_reuse(pkg, store):
    oid = _oid(pkg)
    store.put(oid, np.zeros(48 << 20, dtype=np.uint8))
    with pytest.raises(pkg.Full):
        store.put(_oid(pkg), np.zeros(48 << 20, dtype=np.uint8))
    assert store.delete(oid)
    oid2 = _oid(pkg)
    store.put(oid2, np.zeros(48 << 20, dtype=np.uint8))  # freed and coalesced
    assert store.get(oid2).nbytes == 48 << 20


def test_many_objects_alloc_free(pkg, store):
    oids = []
    for i in range(200):
        oid = _oid(pkg)
        store.put(oid, np.full(1000, i, dtype=np.int32))
        oids.append(oid)
    for i, oid in enumerate(reversed(oids)):
        val = store.get(oid)
        assert val[0] == len(oids) - 1 - i
        del val
        assert store.delete(oid)
    assert store.num_objects() == 0


def _child_reader(name, path, oid_bytes, q):
    p = _pkg(name)
    s = p.Store(path)
    val = s.get(p.ids.ObjectID(oid_bytes), timeout=5)
    q.put(float(val.sum()))
    del val
    s.close()


def test_cross_process_get(pkg, store, tmp_path):
    oid = _oid(pkg)
    store.put(oid, np.ones(100000, dtype=np.float64))
    ctx = multiprocessing.get_context("fork")
    q = ctx.Queue()
    p = ctx.Process(target=_child_reader,
                    args=(pkg.name, str(tmp_path / "pool"), oid.binary(), q))
    p.start()
    assert q.get(timeout=20) == 100000.0
    p.join(timeout=10)
    assert p.exitcode == 0


def test_a_pool_smaller_than_its_header_is_refused(tmp_path):
    """The port's copy refuses a pool its object table does not fit in (the
    JAX copy writes past the mapping's end: a crash)."""
    from ray_tpu_torch.core.shm_store import SharedMemoryStore

    with pytest.raises(OSError):
        SharedMemoryStore.create(str(tmp_path / "tiny"), capacity=1 << 20)
    assert not (tmp_path / "tiny").exists()


# -------------------------------------------- pools of both packages at once


@pytest.fixture
def shm_pools(monkeypatch):
    """Small pools in /dev/shm: a port pool of a session whose driver is gone
    (its lock file left, unlocked, as a SIGKILLed driver leaves it), a port
    pool of a live session (its driver's lock held here), a port pool with no
    lock file (no session the sweep knows), and a JAX pool of a live JAX
    session (its gcs.sock listening here, so that no JAX sweep in another
    test process removes it). Both sweeps called here see only these files:
    /dev/shm may hold other test processes' live pools."""
    import socket
    import uuid

    from ray_tpu.core.shm_store import SharedMemoryStore as JaxStore
    from ray_tpu_torch.core.shm_store import SharedMemoryStore as TorchStore

    if not os.path.isdir("/dev/shm"):
        pytest.skip("no /dev/shm on this machine")
    dead, live, unknown = (f"rtpt_session_{kind}{uuid.uuid4().hex[:8]}"
                           for kind in ("dead", "live", "unknown"))
    locks = {"port_dead": f"/dev/shm/rtpt_{dead}.lock", "port_live": f"/dev/shm/rtpt_{live}.lock"}
    os.close(os.open(locks["port_dead"], os.O_RDWR | os.O_CREAT, 0o600))
    lock_fd = os.open(locks["port_live"], os.O_RDWR | os.O_CREAT, 0o600)
    fcntl.flock(lock_fd, fcntl.LOCK_EX)
    jax_dir = tempfile.mkdtemp(prefix="ray_tpu_session_")
    gcs = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    gcs.bind(os.path.join(jax_dir, "gcs.sock"))
    gcs.listen(8)
    paths = {"jax_live": f"/dev/shm/rtpu_{os.path.basename(jax_dir)}_jaxnode",
             "port_dead": f"/dev/shm/rtpt_{dead}_portnode",
             "port_live": f"/dev/shm/rtpt_{live}_livenode",
             "port_unknown": f"/dev/shm/rtpt_{unknown}_node"}

    def make(key):
        # The pool header alone (65536 object slots) takes ~2.6 MB.
        store = (JaxStore if key.startswith("jax") else TorchStore).create(paths[key], 8 << 20)
        store.close()

    for key in paths:
        make(key)
    real_glob = glob.glob
    ours = set(paths.values()) | set(locks.values())

    def only_ours(pattern, *a, **kw):
        return [p for p in real_glob(pattern, *a, **kw) if p in ours]

    monkeypatch.setattr(glob, "glob", only_ours)
    try:
        yield paths, locks, lock_fd, make
    finally:
        gcs.close()
        for p in ours:
            try:
                os.unlink(p)
            except OSError:
                pass
        try:
            os.close(lock_fd)
        except OSError:
            pass
        import shutil

        shutil.rmtree(jax_dir, ignore_errors=True)


def test_sweeps_leave_the_other_package_s_pools(shm_pools, tmp_path, monkeypatch):
    from ray_tpu.core.cluster_runtime import _sweep_orphaned_pools as jax_sweep
    from ray_tpu_torch.core.cluster_runtime import sweep_orphaned_pools as port_sweep

    paths, locks, lock_fd, make = shm_pools
    # The port's sweep removes only its own pool (and lock) of a gone session,
    # whatever TMPDIR the sweeping process has: liveness lives in /dev/shm.
    with monkeypatch.context() as m:
        m.setattr(tempfile, "tempdir", str(tmp_path))
        assert sorted(port_sweep()) == sorted([paths["port_dead"], locks["port_dead"]])
    assert all(os.path.exists(paths[k]) for k in ("jax_live", "port_live", "port_unknown"))
    assert os.path.exists(locks["port_live"])
    # The JAX package's sweep never looks at rtpt_* pools, dead or alive.
    make("port_dead")
    jax_sweep()
    assert all(os.path.exists(p) for p in paths.values())
    # A live port session's pool goes once its driver's lock is released; a
    # pool with no lock file is never the sweep's to judge.
    os.close(lock_fd)
    assert sorted(port_sweep()) == sorted([paths["port_live"], locks["port_live"]])
    assert os.path.exists(paths["jax_live"]) and os.path.exists(paths["port_unknown"])
    assert os.path.exists(paths["port_dead"])  # its lock file went with the first sweep


def test_session_lock_survives_a_sweep_between_open_and_flock(monkeypatch):
    """A sweep that takes a new session's lock between the driver's open and
    flock unlinks the file; the driver then holds a fresh lock on the path."""
    import uuid

    from ray_tpu_torch.core import cluster_runtime as cr

    if not os.path.isdir("/dev/shm"):
        pytest.skip("no /dev/shm on this machine")
    path = f"/dev/shm/rtpt_rtpt_session_race{uuid.uuid4().hex[:8]}.lock"
    real_flock, raced = fcntl.flock, []

    def flock(fd, op):
        if not raced:  # the sweep's turn: lock, unlink, release
            raced.append(fd)
            os.unlink(path)
        return real_flock(fd, op)

    monkeypatch.setattr(cr.fcntl, "flock", flock)
    fd = cr._hold_session_lock(path)
    try:
        assert raced and os.fstat(fd).st_ino == os.stat(path).st_ino
        probe = os.open(path, os.O_RDWR)
        try:
            with pytest.raises(OSError):
                real_flock(probe, fcntl.LOCK_EX | fcntl.LOCK_NB)
        finally:
            os.close(probe)
    finally:
        os.close(fd)
        os.unlink(path)


def test_port_pool_and_jax_pool_coexist(tmp_path):
    """Both packages' stores in one process, at once, each with its own
    library, hold their own objects."""
    jx, tc = _pkg("jax"), _pkg("torch")
    js = jx.Store.create(str(tmp_path / "jax_pool"), capacity=8 << 20)
    ts = tc.Store.create(str(tmp_path / "port_pool"), capacity=8 << 20)
    try:
        joid, toid = _oid(jx), _oid(tc)
        js.put(joid, np.arange(5))
        ts.put(toid, np.arange(7))
        assert js.get(joid).tolist() == list(range(5))
        assert ts.get(toid).tolist() == list(range(7))
        assert js.num_objects() == 1 and ts.num_objects() == 1
        assert not ts.contains(tc.ids.ObjectID(joid.binary()))
    finally:
        js.close()
        ts.close()
