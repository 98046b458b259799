"""Spill to disk and the broadcast push tree on the port's cluster runtime
against the JAX package's, case by case: tests/test_spill.py's three cases
(3x the pool through a 64 MiB pool and back, task outputs that spill, a
24 MiB object pulled across nodes in chunks),
tests/test_cluster.py::test_broadcast_tree_replicates_to_all_nodes, a
spilled primary pulled by another node from its file, and spill files
unlinked when the ref is freed; on the port also CPU torch tensors through
a spill, bitwise.

Each package boots one cluster for the file (every JAX `Cluster()` sweeps
/dev/shm, ROADMAP Queue 3): a head and three nodes, each with a 64 MiB pool
(256 MiB across the nodes), one node holding a "far" resource. A case swaps
the package's runtime in and out.
"""

import functools
import importlib
import os
import sys
import types

import numpy as np
import pytest

from ray_tpu_torch.core import serialization
import torch_modes
from torch_waits import wait_for

serialization.register_pickle_by_value(sys.modules[__name__])

PKGS = ("jax", "torch")
_ROOT = {"jax": "ray_tpu", "torch": "ray_tpu_torch"}
POOL = 64 << 20


def _boot(name):
    rt = importlib.import_module(_ROOT[name])
    Cluster = importlib.import_module(f"{_ROOT[name]}.core.cluster_runtime").Cluster
    kw = {"num_gpus": 0} if name == "torch" else {}
    boot = (torch_modes.boot_jax_cluster if name == "jax"
            else functools.partial(torch_modes.boot_cluster, Cluster))
    cluster = boot(num_cpus=2, num_workers=2, object_store_memory=POOL, **kw)
    far = cluster.add_node(num_cpus=2, resources={"far": 1.0}, num_workers=0)
    others = [cluster.add_node(num_cpus=1, num_workers=0) for _ in range(2)]
    return types.SimpleNamespace(name=name, rt=rt, cluster=cluster, runtime=cluster.runtime(),
                                 far=far, nodes=[far] + others,
                                 base=importlib.import_module(f"{_ROOT[name]}.core.runtime_base"))


@pytest.fixture(scope="module")
def clusters():
    booted = {}
    for name in PKGS:
        importlib.import_module(_ROOT[name]).shutdown()
    try:
        yield booted
    finally:
        for c in booted.values():
            try:
                torch_modes.shutdown_cluster(c.cluster, c.runtime.shutdown)
            finally:
                c.base.set_runtime(None)


@pytest.fixture(params=PKGS)
def c(request, clusters):
    name = request.param
    if name not in clusters:
        clusters[name] = _boot(name)
    cl = clusters[name]
    cl.base.set_runtime(cl.runtime)
    yield cl
    cl.base.set_runtime(None)


def _spill_dir(c, node_id=None):
    return os.path.join(c.cluster.session_dir, f"spill_{node_id or c.cluster.head_node_id}")


def _spill_files(c):
    try:
        return [f for f in os.listdir(_spill_dir(c)) if not f.endswith(".tmp")]
    except FileNotFoundError:
        return []


def test_put_3x_capacity_and_read_back(c):
    rt = c.rt
    n, size = 24, 8 << 20  # 192 MiB through a 64 MiB pool
    refs = [rt.put(np.full(size, i % 251, dtype=np.uint8)) for i in range(n)]
    for i, ref in enumerate(refs):
        v = rt.get(ref, timeout=60)
        assert v[0] == i % 251 and v[-1] == i % 251 and v.nbytes == size
        del v


def test_task_outputs_spill(c):
    rt = c.rt

    @rt.remote
    def big(i):
        return np.full(8 << 20, i, dtype=np.uint8)

    refs = [big.remote(i) for i in range(16)]  # 128 MiB of outputs
    for i, ref in enumerate(refs):
        v = rt.get(ref, timeout=120)
        assert v[0] == i and v[-1] == i
        del v


def test_chunked_cross_node_transfer(c):
    """A 24 MiB object (three 8 MiB chunks) made on the far node is pulled
    to the head in chunks."""
    rt = c.rt

    @rt.remote(resources={"far": 1.0})
    def produce():
        return np.arange(24 << 20, dtype=np.uint8)

    v = rt.get(produce.remote(), timeout=120)
    assert v.nbytes == 24 << 20
    np.testing.assert_array_equal(v, np.arange(24 << 20, dtype=np.uint8))


def test_broadcast_tree_replicates_to_all_nodes(c):
    rt = c.rt
    payload = np.arange(2_000_000, dtype=np.float64)  # 16 MB
    ref = rt.put(payload)
    assert rt.broadcast(ref, timeout=60) == 3
    locs = c.runtime._gcs.call("get_object_locations", ref.hex())
    assert len(locs) == 4, locs


def test_spilled_primary_pulled_from_disk(c):
    """Another node pulls a primary the head has spilled: the head serves it
    from its file (the file stays; no restore into the pool)."""
    rt = c.rt
    refs = [rt.put(np.full(8 << 20, i, dtype=np.uint8)) for i in range(12)]
    first = refs[0].hex()
    assert wait_for(lambda: first in _spill_files(c), timeout=30), _spill_files(c)
    assert wait_for(lambda: c.runtime._gcs.call("stats")["store"]["num_spilled"] > 0,
                    timeout=30), c.runtime._gcs.call("stats")

    @rt.remote(resources={"far": 1.0})
    def summary(arr):
        return int(arr[0]), int(arr[-1]), arr.nbytes

    assert rt.get(summary.remote(refs[0]), timeout=120) == (0, 0, 8 << 20)
    assert first in _spill_files(c)  # served from disk, not restored
    locs = {loc["node_id"] for loc in c.runtime._gcs.call("get_object_locations", first)}
    assert c.far in locs and c.cluster.head_node_id in locs, locs


def test_spill_files_unlinked_when_refs_freed(c):
    rt = c.rt
    refs = [rt.put(np.full(8 << 20, i, dtype=np.uint8)) for i in range(16)]
    hexes = {r.hex() for r in refs}
    assert wait_for(lambda: hexes & set(_spill_files(c)), timeout=30)
    del refs
    assert wait_for(lambda: not (hexes & set(_spill_files(c))), timeout=60), (
        sorted(hexes & set(_spill_files(c))))


def test_torch_tensors_bitwise_through_a_spill(clusters):
    """CPU torch tensors (bf16 and fp32) come back bitwise after a spill
    to disk and a restore."""
    import torch

    if "torch" not in clusters:
        clusters["torch"] = _boot("torch")
    c = clusters["torch"]
    c.base.set_runtime(c.runtime)
    try:
        rt = c.rt
        gen = torch.Generator().manual_seed(0)
        kept = [torch.randn(2048, 1024, generator=gen).to(torch.bfloat16 if i % 2 else
                                                          torch.float32)
                for i in range(24)]  # 4 or 8 MiB each, 144 MiB in all
        before = c.runtime._raylet.call("debug_state")["objects"]
        refs = [rt.put(t) for t in kept]
        stats = c.runtime._raylet.call("debug_state")["objects"]
        assert stats["spill_total"] > before["spill_total"], (before, stats)
        for t, ref in zip(kept, refs):
            got = rt.get(ref, timeout=60)
            assert got.dtype == t.dtype and torch.equal(got, t)
            del got
        after = c.runtime._raylet.call("debug_state")["objects"]
        assert after["restore_total"] > stats["restore_total"], (stats, after)
    finally:
        c.base.set_runtime(None)


def test_restore_into_a_fragmented_pool_spills_until_it_fits(tmp_path):
    """The port's raylet restores a spilled object into a pool whose free
    bytes are enough but lie in holes too small for it, and makes room for a
    put in the same pool. The first-fit pool leaves such holes when spills
    take objects of mixed sizes out of the middle; the raylet used to stop
    spilling once the bytes were under the target, so the restore failed on
    every retry and the get waited out its timeout
    (test_torch_tensors_bitwise_through_a_spill under load). It now spills
    on, oldest first, until one free block takes the object."""
    import collections
    import threading

    from ray_tpu_torch.core import raylet as rmod
    from ray_tpu_torch.core.ids import ObjectID
    from ray_tpu_torch.core.shm_store import SharedMemoryStore
    from ray_tpu_torch.exceptions import ObjectStoreFullError

    mib = 1 << 20
    store = SharedMemoryStore.create(str(tmp_path / "pool"), capacity=POOL)
    svc = rmod.RayletService.__new__(rmod.RayletService)
    svc.store, svc._spill_dir = store, str(tmp_path)
    svc._evict_lock, svc._objects_lock = threading.Lock(), threading.Lock()
    svc._local_objects, svc._spilled = collections.OrderedDict(), {}
    svc._seal_cv, svc._buf_lock, svc._loc_buf = threading.Condition(), threading.Lock(), []
    svc._buf_wake, svc._sched_wake = threading.Event(), threading.Event()
    svc.gcs = types.SimpleNamespace(call=lambda *a, **k: None)
    rng = np.random.default_rng(0)
    ids = [rng.bytes(16).hex() for _ in range(13)]

    def fits(nbytes):  # a probe allocation, taken back at once
        probe = ObjectID.from_hex(ids[12])
        try:
            store.begin_put_raw(probe, nbytes)
        except ObjectStoreFullError:
            return False
        assert store.delete(probe)
        return True

    try:
        for i in range(10):  # 4 and 8 MiB in turn: 60 MiB in the 64 MiB pool
            store.put_raw(ObjectID.from_hex(ids[i]), bytes([i]) * ((4, 8)[i % 2] * mib))
            svc._local_objects[ids[i]] = True
        for i in (2, 4, 6):  # spilled as the monitor would: three 4 MiB holes
            assert svc._try_evict_one_locked(ids[i], True)
        spilled = os.path.join(str(tmp_path), ids[10])
        with open(spilled, "wb") as f:
            f.write(b"\x0a" * (8 * mib))
        svc._spilled[ids[10]] = spilled
        target = int(store.capacity() * 0.95) - 8 * mib
        assert store.bytes_in_use() <= target and not fits(8 * mib)
        assert svc._restore(ids[10])
        assert store.get_raw(ObjectID.from_hex(ids[10])) == b"\x0a" * (8 * mib)
        assert not os.path.exists(spilled) and ids[10] not in svc._spilled
        assert ids[0] in svc._spilled  # the oldest went to disk to make the hole
        assert svc._try_evict_one_locked(ids[8], True)  # holes of 8 and 4 MiB
        target = int(store.capacity() * 0.95) - 12 * mib
        assert store.bytes_in_use() <= target and not fits(12 * mib)
        assert svc.ensure_space(12 * mib) and fits(12 * mib)
        store.put_raw(ObjectID.from_hex(ids[11]), b"\x0b" * (12 * mib))
    finally:
        store.close()
