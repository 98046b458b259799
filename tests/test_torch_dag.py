"""Lazy DAG authoring (ray_tpu_torch/dag.py: `fn.bind`, `actor.method.bind`,
InputNode, MultiOutputNode, `compile()`) against the JAX package's
ray_tpu/dag.py: tests/test_dag.py's four object-plane cases, each on both
packages' local and cluster runtimes (tests/torch_modes.py: ids jax,
jax-cluster, torch, torch-cluster) with the same inputs and equal results.

test_dag.py's two channel-compiled cases need a worker process to host the
exec loop: compiled graphs run on the cluster runtime and are held against
the JAX package's in tests/test_torch_cgraph.py. Here, on the in-process
runtime, `experimental_compile` fails alike in both packages and the
object-plane path still runs.
"""

import importlib
import sys

import numpy as np
import pytest

import torch_modes
from ray_tpu_torch.core import serialization
from torch_waits import bounded

serialization.register_pickle_by_value(sys.modules[__name__])

CASE_TIMEOUT = 120.0


@pytest.fixture(scope="module")
def clusters():
    booted = torch_modes.Clusters(num_cpus=4)
    try:
        yield booted
    finally:
        booted.shutdown()


@pytest.fixture(params=torch_modes.PARAMS, ids=torch_modes.IDS)
def rt(request):
    name, mode = request.param
    clusters = request.getfixturevalue("clusters") if mode == "cluster" else None
    with torch_modes.runtime_for(clusters, name, mode, num_cpus=4) as pkg:
        yield pkg


def _dag(rt):
    import importlib

    return importlib.import_module(f"{rt.__name__}.dag")


def test_function_dag_chain(rt):
    dag_mod = _dag(rt)

    @rt.remote
    def double(x):
        return x * 2

    @rt.remote
    def add(a, b):
        return a + b

    with dag_mod.InputNode() as inp:
        dag = add.bind(double.bind(inp), double.bind(inp))
    assert bounded(lambda: rt.get(dag.execute(5), timeout=60), CASE_TIMEOUT) == 20


def test_actor_dag_and_compile_reuse(rt):
    dag_mod = _dag(rt)

    @rt.remote
    class Counter:
        def __init__(self):
            self.total = 0

        def add(self, x):
            self.total += x
            return self.total

    a = Counter.remote()
    with dag_mod.InputNode() as inp:
        dag = a.add.bind(inp)
    compiled = dag.compile()
    assert bounded(lambda: rt.get(compiled.execute(3), timeout=60), CASE_TIMEOUT) == 3
    assert bounded(lambda: rt.get(compiled.execute(4), timeout=60), CASE_TIMEOUT) == 7


def test_multi_output(rt):
    dag_mod = _dag(rt)

    @rt.remote
    def inc(x):
        return x + 1

    @rt.remote
    def dec(x):
        return x - 1

    with dag_mod.InputNode() as inp:
        dag = dag_mod.MultiOutputNode([inc.bind(inp), dec.bind(inp)])
    assert bounded(lambda: rt.get(dag.execute(10), timeout=60), CASE_TIMEOUT) == [11, 9]


def test_intermediate_values_stay_in_object_plane(rt):
    @rt.remote
    def big():
        return np.ones(1 << 20, dtype=np.float32)

    @rt.remote
    def total(arr):
        return float(arr.sum())

    dag = total.bind(big.bind())
    assert bounded(lambda: rt.get(dag.execute(), timeout=60), CASE_TIMEOUT) == float(1 << 20)


def test_experimental_compile_names_roadmap_item_4():
    """Compiled graphs (ROADMAP Queue 1 item 4) are ported: the dag module
    resolves CompiledGraph and CompiledRef to cgraph's classes. The
    in-process runtime has no worker to host an exec loop, so
    `experimental_compile` there fails as the JAX package's does (a TaskError
    naming the worker builtin `__ray_dag_setup__`), and the object-plane path
    still runs."""
    import ray_tpu_torch.cgraph as cgraph
    from ray_tpu_torch import dag as dag_mod

    assert dag_mod.CompiledGraph is cgraph.CompiledGraph
    assert dag_mod.CompiledRef is cgraph.CompiledRef
    seen = {}
    for name in ("jax", "torch"):
        pkg = importlib.import_module(torch_modes.PACKAGES[name])
        dags = importlib.import_module(f"{torch_modes.PACKAGES[name]}.dag")
        pkg.shutdown()
        pkg.init(local_mode=True, num_cpus=2)
        try:
            s = pkg.remote(_stage_class()).remote()
            with dags.InputNode() as inp:
                dag = s.apply.bind(inp)
            with pytest.raises(Exception, match="__ray_dag_setup__") as ei:
                dag.experimental_compile()
            seen[name] = (type(ei.value).__name__, pkg.get(dag.execute(1), timeout=30))
        finally:
            pkg.shutdown()
    assert seen["torch"] == seen["jax"] == ("TaskError", 2)


def _stage_class():
    """Made in a function: the JAX package's local runtime cloudpickles a
    module-level class of this file by reference."""
    class Stage:
        def apply(self, x):
            return x + 1

    return Stage
