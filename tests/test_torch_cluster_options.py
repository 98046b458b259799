"""Scheduling options on the port's cluster runtime against the JAX
package's, case by case: tests/test_options.py's threaded and async
`max_concurrency`, cancel of a running, a queued and a force-killed task and
concurrency groups in cluster mode; tests/test_core_api.py's
TestStreamingReturns on a cluster; a `get` timeout. Each case runs on both
packages with the same functions.

One more case holds `cancel` to JAX's contract where the port once diverged:
when the raylet call that cancels a fast-path task fails, `cancel()` logs it
and returns instead of raising.

One cluster of each package (4 CPUs, as test_options.py's) serves the file.
"""

import os
import sys
import time
import types

import numpy as np
import pytest

import ray_tpu as jrt
import ray_tpu_torch as trt
from ray_tpu import exceptions as jexc
from ray_tpu_torch import exceptions as texc
import torch_modes
from ray_tpu_torch.core import serialization

from torch_waits import wait_for

serialization.register_pickle_by_value(sys.modules[__name__])

PKGS = ("jax", "torch")


@pytest.fixture(scope="module")
def jax_cluster():
    from ray_tpu.core import runtime_base as jbase

    jrt.shutdown()
    jc = torch_modes.boot_jax_cluster(num_cpus=4, num_workers=2)
    try:
        jbase.set_runtime(jc.runtime())
        yield types.SimpleNamespace(rt=jrt, exc=jexc, base=jbase)
    finally:
        torch_modes.shutdown_cluster(jc, jrt.shutdown)


@pytest.fixture(scope="module")
def torch_cluster():
    from ray_tpu_torch.core import runtime_base as tbase
    from ray_tpu_torch.core.cluster_runtime import Cluster as TorchCluster

    trt.shutdown()
    tc = torch_modes.boot_cluster(TorchCluster, num_cpus=4, num_gpus=0)
    try:
        tbase.set_runtime(tc.runtime())
        yield types.SimpleNamespace(rt=trt, exc=texc, base=tbase)
    finally:
        torch_modes.shutdown_cluster(tc, trt.shutdown)


@pytest.fixture(params=PKGS)
def c(request):
    """The cluster of the case's package only (one module fixture each)."""
    return request.getfixturevalue(f"{request.param}_cluster")


# ------------------------------------------------------------ concurrency
def test_threaded_actor_max_concurrency(c):
    rt = c.rt

    @rt.remote(max_concurrency=4)
    class Sleeper:
        def nap(self, t):
            time.sleep(t)
            return os.getpid()

    a = Sleeper.remote()
    try:
        rt.get(a.nap.remote(0.01), timeout=60)  # wait out the worker's start
        t0 = time.monotonic()
        pids = rt.get([a.nap.remote(0.5) for _ in range(4)], timeout=30)
        elapsed = time.monotonic() - t0
        assert elapsed < 1.5, f"naps did not overlap: {elapsed:.2f}s"
        assert len(set(pids)) == 1  # all in the one actor process
    finally:
        rt.kill(a)


def test_async_actor_concurrency(c):
    rt = c.rt

    @rt.remote(max_concurrency=8)
    class AsyncActor:
        async def nap(self, t):
            import asyncio

            await asyncio.sleep(t)
            return "done"

    a = AsyncActor.remote()
    try:
        rt.get(a.nap.remote(0.01), timeout=60)
        t0 = time.monotonic()
        out = rt.get([a.nap.remote(0.5) for _ in range(8)], timeout=30)
        elapsed = time.monotonic() - t0
        assert out == ["done"] * 8
        assert elapsed < 2.0, f"async naps did not overlap: {elapsed:.2f}s"
    finally:
        rt.kill(a)


def test_concurrency_groups_cluster_mode(c):
    rt = c.rt

    @rt.remote(max_concurrency=1, concurrency_groups={"io": 3, "compute": 1})
    class Mixed:
        def __init__(self):
            self.log = []

        @rt.method(concurrency_group="io")
        def fetch(self, i):
            self.log.append(("start", i, time.monotonic()))
            time.sleep(0.5)
            self.log.append(("end", i, time.monotonic()))
            return i

        @rt.method(concurrency_group="compute")
        def crunch(self, i):
            time.sleep(0.3)
            return i

        def events(self):
            return list(self.log)

    a = Mixed.remote()
    try:
        rt.get(a.events.remote(), timeout=60)
        t0 = time.monotonic()
        out = rt.get([a.fetch.remote(i) for i in range(3)], timeout=60)
        io_wall = time.monotonic() - t0
        assert sorted(out) == [0, 1, 2]
        assert io_wall < 1.2, f"io group did not run concurrently: {io_wall:.2f}s"
        t0 = time.monotonic()
        rt.get([a.crunch.remote(i) for i in range(2)], timeout=60)
        compute_wall = time.monotonic() - t0
        assert compute_wall >= 0.55, f"compute group overlapped: {compute_wall:.2f}s"
    finally:
        rt.kill(a)


# ----------------------------------------------------------------- cancel
def test_cancel_running_task(c):
    rt = c.rt

    @rt.remote
    def warm():
        return 1

    rt.get(warm.remote(), timeout=60)

    @rt.remote
    def sleeper():
        time.sleep(60)
        return "never"

    ref = sleeper.remote()
    time.sleep(1.0)  # let it dispatch
    rt.cancel(ref)
    with pytest.raises(c.exc.TaskCancelledError):
        rt.get(ref, timeout=15)


def test_cancel_queued_task(c, tmp_path):
    rt = c.rt
    marker = str(tmp_path / "hog_started")

    @rt.remote(num_cpus=4)
    def hog(path):
        with open(path, "w") as f:
            f.write("1")
        time.sleep(3)
        return "hogged"

    @rt.remote(num_cpus=4)
    def queued():
        return "ran"

    h = hog.remote(marker)
    assert wait_for(lambda: os.path.exists(marker), timeout=20), "hog never started"
    q = queued.remote()  # cannot start while the hog holds every CPU
    time.sleep(0.3)
    rt.cancel(q)
    with pytest.raises(c.exc.TaskCancelledError):
        rt.get(q, timeout=15)
    assert rt.get(h, timeout=30) == "hogged"


def test_cancel_force_kills_worker(c):
    rt = c.rt

    @rt.remote
    def warm():
        return 1

    rt.get(warm.remote(), timeout=60)

    @rt.remote
    def stubborn():
        while True:  # ignores the SIGINT of a plain cancel
            try:
                time.sleep(60)
            except KeyboardInterrupt:
                continue

    ref = stubborn.remote()
    time.sleep(1.0)
    rt.cancel(ref, force=True)
    with pytest.raises((c.exc.TaskCancelledError, c.exc.WorkerCrashedError)):
        rt.get(ref, timeout=20)


class _LostCancel:
    """The driver's raylet client, except that a `cancel_lease_task` call
    fails as a dropped connection would."""

    def __init__(self, inner):
        self._inner = inner

    def call(self, method, *args, **kwargs):
        if method == "cancel_lease_task":
            raise ConnectionResetError("raylet connection lost")
        return self._inner.call(method, *args, **kwargs)

    def __getattr__(self, name):
        return getattr(self._inner, name)


def test_cancel_returns_when_the_lease_call_fails(c):
    rt = c.rt
    runtime = c.base.current_runtime()

    @rt.remote
    def warm():
        return 1

    @rt.remote
    def sleeper():
        time.sleep(60)
        return "never"

    def on_fast_path():  # the owner holds a worker lease once a task took it
        ref = warm.remote()
        fast = runtime._records[ref.hex()].entry.get("_fast")
        rt.get(ref, timeout=60)
        return fast

    assert wait_for(on_fast_path, timeout=20, interval=0.1), "no worker lease"
    ref = sleeper.remote()
    rec = runtime._records[ref.hex()]
    assert wait_for(lambda: rec.entry.get("_fast"), timeout=10), "not on the fast path"
    real = runtime._raylet
    runtime._raylet = _LostCancel(real)
    try:
        rt.cancel(ref)  # logged at debug level, not raised
    finally:
        runtime._raylet = real
    rt.cancel(ref, force=True)
    with pytest.raises((c.exc.TaskCancelledError, c.exc.WorkerCrashedError)):
        rt.get(ref, timeout=20)


# -------------------------------------------------------- streaming returns
def test_task_stream(c):
    rt = c.rt

    @rt.remote(num_returns="streaming")
    def gen(n):
        for i in range(n):
            yield i * 10

    assert [rt.get(r, timeout=60) for r in gen.remote(5)] == [0, 10, 20, 30, 40]


def test_empty_stream(c):
    @c.rt.remote(num_returns="streaming")
    def empty():
        return
        yield  # pragma: no cover

    assert list(empty.remote()) == []


def test_mid_stream_error_surfaces_at_index(c):
    rt = c.rt

    @rt.remote(num_returns="streaming")
    def bad():
        yield 1
        raise ValueError("boom")

    it = iter(bad.remote())
    assert rt.get(next(it), timeout=60) == 1
    with pytest.raises(Exception, match="boom"):
        rt.get(next(it), timeout=60)


def test_actor_stream(c):
    rt = c.rt

    @rt.remote
    class A:
        def stream(self, n):
            for i in range(n):
                yield i + 100

    a = A.remote()
    try:
        g = a.stream.options(num_returns="streaming").remote(3)
        assert [rt.get(r, timeout=60) for r in g] == [100, 101, 102]
    finally:
        rt.kill(a)


def test_stream_is_incremental(c):
    rt = c.rt

    @rt.remote(num_returns="streaming")
    def slow():
        for i in range(3):
            time.sleep(0.4)
            yield i

    t0 = time.monotonic()
    it = iter(slow.remote())
    rt.get(next(it), timeout=60)
    t_first = time.monotonic() - t0
    list(it)
    t_all = time.monotonic() - t0
    assert t_first < t_all - 0.3, (t_first, t_all)


def test_large_items_via_store(c):
    rt = c.rt

    @rt.remote(num_returns="streaming")
    def big(n):
        for i in range(n):
            yield np.full(300_000, i, dtype=np.float64)  # over the inline cap

    vals = [rt.get(r, timeout=60) for r in big.remote(3)]
    assert [float(v[0]) for v in vals] == [0.0, 1.0, 2.0]


# ------------------------------------------------------------- get timeout
def test_get_timeout(c):
    rt = c.rt

    @rt.remote
    def slow():
        time.sleep(5)
        return 1

    with pytest.raises(c.exc.GetTimeoutError):
        rt.get(slow.remote(), timeout=0.1)
