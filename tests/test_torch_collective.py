"""Out-of-band collective groups (ray_tpu_torch/collective.py) against the
JAX package's ray_tpu/collective.py, case by case: tests/test_collective.py's
five cases (two and three members, re-init of a name without a destroy,
destroy then re-init, a stale registration), and
tests/test_chaos.py::test_collective_re_rendezvous_after_member_death and
::test_collective_timeout_names_missing_ranks; then the same numpy values
through every op as torch CPU tensors on the port and as jnp arrays on the
JAX package, with equal outputs (exact, the float allreduce to
assert_allclose's default), and the port's bf16 rule.

Each package boots one cluster for the file (every JAX `Cluster()` sweeps
/dev/shm, ROADMAP Queue 3), with a chaos rule that SIGKILLs a worker
running `collective_die` in the environment its workers inherit.
"""

import functools
import importlib
import json
import os
import sys
import time
import types

import numpy as np
import pytest

from ray_tpu_torch.core import serialization
import torch_modes

serialization.register_pickle_by_value(sys.modules[__name__])

PKGS = ("jax", "torch")
_ROOT = {"jax": "ray_tpu", "torch": "ray_tpu_torch"}
_CHAOS = [{"point": "task.exec", "action": "kill", "match": "collective_die", "times": -1}]


def _member_class():
    """The group member class, made in a function so that the JAX package's
    cloudpickle sends it by value (a module-level class goes by reference,
    and the test module is not importable in a worker)."""

    class _Member:
        """One group member; `root` names the package whose collective it uses."""

        def __init__(self, root):
            self.root = root
            self.rank = None

        def _coll(self):
            return importlib.import_module(f"{self.root}.collective")

        def ping(self):
            return True

        def join(self, ws, rank, name):
            self._coll().init_collective_group(ws, rank, group_name=name)
            self.rank = rank
            return True

        def do_allreduce(self, name):
            return self._coll().allreduce(np.full(1000, float(self.rank + 1), dtype=np.float64),
                                          group_name=name)

        def do_broadcast(self, name):
            arr = np.arange(16, dtype=np.int64) if self.rank == 0 else None
            return self._coll().broadcast(arr, src_rank=0, group_name=name)

        def do_allgather(self, name):
            return self._coll().allgather(np.array([self.rank * 10], dtype=np.int64),
                                          group_name=name)

        def do_barrier_then_rank(self, name):
            self._coll().barrier(group_name=name)
            return self.rank

        def leave(self, name):
            self._coll().destroy_collective_group(name)
            return True

        def collective_die(self):
            return "never"

        def reduce(self, v):
            return float(self._coll().allreduce(np.array([v], dtype=np.float64), "gang")[0])

        def ops_on(self, name, values, kind):
            """Every op on this rank's numpy values, passed as a torch CPU tensor
            (kind "torch") or a jnp array (kind "jnp")."""
            if kind == "torch":
                import torch

                wrap = torch.from_numpy
            else:
                import jax.numpy as jnp

                wrap = jnp.asarray
            coll = self._coll()
            x = wrap(values)
            out = {"allreduce": coll.allreduce(x, group_name=name),
                   "allreduce_max": coll.allreduce(x, group_name=name, op="max"),
                   "reduce_scatter": coll.reduce_scatter(x, group_name=name),
                   "allgather": coll.allgather(x, group_name=name),
                   "broadcast": coll.broadcast(x if self.rank == 1 else None, src_rank=1,
                                               group_name=name)}
            if self.rank == 0:  # to the ring's next rank: no member forwards
                coll.send(x * 2, 1, group_name=name)
            if self.rank == 1:
                out["recv"] = coll.recv(0, group_name=name)
            return {k: (np.asarray(v) if not isinstance(v, list) else [np.asarray(a) for a in v])
                    for k, v in out.items()}

        def bf16_ops(self, name, bits):
            """The port's bf16 rule: a bf16 tensor made from these int16 bits."""
            import torch

            x = torch.from_numpy(bits).view(torch.bfloat16)
            coll = self._coll()
            return {"allgather": coll.allgather(x, group_name=name),
                    "broadcast": coll.broadcast(x if self.rank == 0 else None, src_rank=0,
                                                group_name=name),
                    "allreduce": coll.allreduce(x, group_name=name)}

    return _Member


@pytest.fixture(scope="module")
def clusters():
    saved = {k: os.environ.get(k) for k in ("RAY_TPU_CHAOS", "RAY_TPU_CHAOS_SEED")}
    booted = {}
    for name in PKGS:
        importlib.import_module(_ROOT[name]).shutdown()
    os.environ["RAY_TPU_CHAOS"] = json.dumps(_CHAOS)
    os.environ["RAY_TPU_CHAOS_SEED"] = "0"
    try:
        for name in PKGS:
            Cluster = importlib.import_module(f"{_ROOT[name]}.core.cluster_runtime").Cluster
            kw = {"num_gpus": 0} if name == "torch" else {}
            boot = (torch_modes.boot_jax_cluster if name == "jax"
                    else functools.partial(torch_modes.boot_cluster, Cluster))
            cluster = boot(num_cpus=4, num_workers=3, **kw)
            booted[name] = types.SimpleNamespace(
                name=name, cluster=cluster, runtime=cluster.runtime(),
                rt=importlib.import_module(_ROOT[name]),
                coll=importlib.import_module(f"{_ROOT[name]}.collective"),
                exc=importlib.import_module(f"{_ROOT[name]}.exceptions"),
                chaos=importlib.import_module(f"{_ROOT[name]}.chaos.controller"),
                base=importlib.import_module(f"{_ROOT[name]}.core.runtime_base"))
    finally:
        for k, v in saved.items():  # the raylets have read them
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
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
    cl = clusters[request.param]
    cl.base.set_runtime(cl.runtime)
    # A hang (one JAX-side case once hung after a chaos-raised rendezvous
    # under load; ROADMAP Queue 3) fails its case instead of the whole run.
    with torch_modes.case_time_limit(request, 180):
        yield cl
    cl.base.set_runtime(None)


def _members(c, n, **opts):
    cls = c.rt.remote(**opts)(_member_class()) if opts else c.rt.remote(_member_class())
    return [cls.remote(_ROOT[c.name]) for _ in range(n)]


def _join(c, members, name):
    ws = len(members)
    c.rt.get([m.join.remote(ws, i, name) for i, m in enumerate(members)], timeout=120)


def test_two_process_collective_group(c):
    rt = c.rt
    members = _members(c, 2)
    _join(c, members, "g2")
    for o in rt.get([m.do_allreduce.remote("g2") for m in members], timeout=120):
        np.testing.assert_allclose(o, np.full(1000, 3.0))
    for o in rt.get([m.do_broadcast.remote("g2") for m in members], timeout=120):
        np.testing.assert_array_equal(o, np.arange(16, dtype=np.int64))
    assert sorted(rt.get([m.do_barrier_then_rank.remote("g2") for m in members],
                         timeout=120)) == [0, 1]
    rt.get([m.leave.remote("g2") for m in members], timeout=60)


def test_group_reinit_same_name_after_restart(c):
    rt = c.rt
    members = _members(c, 2)
    _join(c, members, "gre")
    for o in rt.get([m.do_allreduce.remote("gre") for m in members], timeout=120):
        np.testing.assert_allclose(o, np.full(1000, 3.0))
    _join(c, members, "gre")  # a restart's re-init: the same name, no leave
    for o in rt.get([m.do_allreduce.remote("gre") for m in members], timeout=120):
        np.testing.assert_allclose(o, np.full(1000, 3.0))
    rt.get([m.leave.remote("gre") for m in members], timeout=60)


def test_destroy_then_reinit_same_name(c):
    rt = c.rt
    members = _members(c, 2)
    _join(c, members, "gdr")
    rt.get([m.leave.remote("gdr") for m in members], timeout=60)
    assert c.runtime._gcs.call("kv_keys", f"{c.coll._KV_PREFIX}gdr/") == []
    _join(c, members, "gdr")
    for o in rt.get([m.do_allreduce.remote("gdr") for m in members], timeout=120):
        np.testing.assert_allclose(o, np.full(1000, 3.0))
    rt.get([m.leave.remote("gdr") for m in members], timeout=60)


def test_stale_registration_does_not_wedge_rendezvous(c):
    rt = c.rt
    for rank in (0, 1):  # dead addresses for both ranks
        c.runtime._gcs.call("kv_put", f"{c.coll._KV_PREFIX}gst/{rank}", b"127.0.0.1:9")
    members = _members(c, 2)
    t0 = time.monotonic()
    _join(c, members, "gst")
    assert time.monotonic() - t0 < 45.0  # well under the 60 s ring deadline
    for o in rt.get([m.do_allreduce.remote("gst") for m in members], timeout=120):
        np.testing.assert_allclose(o, np.full(1000, 3.0))
    rt.get([m.leave.remote("gst") for m in members], timeout=60)


def test_three_process_ring_allreduce_and_allgather(c):
    rt = c.rt
    members = _members(c, 3)
    _join(c, members, "g3")
    for o in rt.get([m.do_allreduce.remote("g3") for m in members], timeout=120):
        np.testing.assert_allclose(o, np.full(1000, 6.0))
    for g in rt.get([m.do_allgather.remote("g3") for m in members], timeout=120):
        assert [int(x[0]) for x in g] == [0, 10, 20]
    rt.get([m.leave.remote("g3") for m in members], timeout=60)


def test_collective_re_rendezvous_after_member_death(c):
    """A member's worker dies (the chaos SIGKILL); the actor restarts with
    no membership, and create_collective_group re-forms the ring over the
    stale GCS key."""
    rt = c.rt
    members = _members(c, 3, max_restarts=1)
    rt.get([m.ping.remote() for m in members], timeout=60)
    c.coll.create_collective_group(members, "gang")
    assert rt.get([m.reduce.remote(float(i + 1)) for i, m in enumerate(members)],
                  timeout=60) == [6.0, 6.0, 6.0]
    with pytest.raises(Exception):
        rt.get(members[1].collective_die.remote(), timeout=30)
    deadline = time.monotonic() + 30
    while True:
        try:
            rt.get(members[1].ping.remote(), timeout=10)
            break
        except Exception:
            if time.monotonic() > deadline:
                raise
            time.sleep(0.2)
    c.coll.create_collective_group(members, "gang")
    assert rt.get([m.reduce.remote(float(i + 1)) for i, m in enumerate(members)],
                  timeout=60) == [6.0, 6.0, 6.0]
    c.coll.destroy_collective_group_on(members, "gang")
    assert c.runtime._gcs.call("kv_keys", f"{c.coll._KV_PREFIX}gang/") == []


def test_collective_timeout_names_missing_ranks(c, monkeypatch):
    monkeypatch.setenv("RAY_TPU_COLLECTIVE_TIMEOUT_S", "1.0")
    try:
        t0 = time.monotonic()
        with pytest.raises(c.exc.CollectiveTimeoutError) as ei:
            # A world of 2 whose rank 1 never joins.
            c.coll.init_collective_group(2, 0, group_name="lonely")
        assert time.monotonic() - t0 < 30.0
        err = ei.value
        assert isinstance(err, TimeoutError)
        assert err.group == "lonely" and err.rank == 0 and 1 in err.missing
        c.coll.destroy_collective_group("lonely")
        c.chaos.configure([{"point": "coll.rendezvous", "action": "raise", "times": 1}],
                          seed=0)
        with pytest.raises(c.exc.CollectiveTimeoutError):
            c.coll.init_collective_group(2, 0, group_name="chaosgrp")
    finally:
        c.chaos.disable()
        c.coll.destroy_collective_group("chaosgrp")


@pytest.fixture(scope="module")
def both_ops(clusters):
    """Every op on the same numpy values: torch CPU tensors on the port,
    jnp arrays on the JAX package."""
    rng = np.random.default_rng(0)
    values = [rng.standard_normal(1001).astype(np.float32) for _ in range(3)]
    out = {}
    for name, kind in (("jax", "jnp"), ("torch", "torch")):
        c = clusters[name]
        c.base.set_runtime(c.runtime)
        try:
            members = _members(c, 3)
            _join(c, members, "gops")
            out[name] = c.rt.get([m.ops_on.remote("gops", v, kind)
                                  for m, v in zip(members, values)], timeout=120)
            c.rt.get([m.leave.remote("gops") for m in members], timeout=60)
        finally:
            c.base.set_runtime(None)
    return values, out


@pytest.mark.parametrize("op", ["allreduce", "allreduce_max", "reduce_scatter", "allgather",
                                "broadcast", "recv"])
def test_torch_tensors_match_jnp_arrays(both_ops, op):
    values, out = both_ops
    for rank in range(3):
        j, t = out["jax"][rank].get(op), out["torch"][rank].get(op)
        assert (j is None) == (t is None)
        if j is None:
            continue
        if op == "allreduce":
            np.testing.assert_allclose(t, j)
            exact = values[0].astype(np.float64) + values[1] + values[2]
            np.testing.assert_allclose(t, exact, rtol=0, atol=1e-6)  # fp32 rounding
        elif op == "allgather":
            assert len(t) == len(j) == 3
            for a, b, v in zip(t, j, values):
                np.testing.assert_array_equal(a, b)
                np.testing.assert_array_equal(a, v)
        else:
            assert t.dtype == j.dtype
            np.testing.assert_array_equal(t, j)
    np.testing.assert_array_equal(out["torch"][1]["recv"], values[0] * 2)
    np.testing.assert_array_equal(out["torch"][0]["broadcast"], values[1])


def test_bf16_travels_as_bits_and_returns_float32(clusters):
    """The port's rule: a bf16 tensor's bits travel unchanged and come back
    as float32 (broadcast, allgather); a reduction widens to float32
    first."""
    import torch

    c = clusters["torch"]
    c.base.set_runtime(c.runtime)
    try:
        gen = torch.Generator().manual_seed(0)
        tensors = [torch.randn(257, generator=gen).to(torch.bfloat16) for _ in range(3)]
        bits = [t.view(torch.int16).numpy() for t in tensors]
        members = _members(c, 3)
        _join(c, members, "gbf")
        outs = c.rt.get([m.bf16_ops.remote("gbf", b) for m, b in zip(members, bits)],
                        timeout=120)
        c.rt.get([m.leave.remote("gbf") for m in members], timeout=60)
    finally:
        c.base.set_runtime(None)
    want32 = [t.float().numpy() for t in tensors]
    total = want32[0] + want32[1] + want32[2]
    for o in outs:
        assert o["broadcast"].dtype == np.float32
        np.testing.assert_array_equal(o["broadcast"], want32[0])
        for got, want in zip(o["allgather"], want32):
            assert got.dtype == np.float32
            np.testing.assert_array_equal(got, want)
        assert o["allreduce"].dtype == np.float32
        np.testing.assert_allclose(o["allreduce"], total, rtol=1e-6)
