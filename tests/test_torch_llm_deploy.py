"""The port's LLM deployment, feed and engine drills side by side with the
JAX package's (tests/test_serve_llm.py:278-520), and the whole slice.

Every drill runs twice, on the JAX package and on the port, each over its
own `init(local_mode=True)`, with the same StubModel deployments, and
asserts the same outcome: a chaos decode fault fails the batch typed and
the loop recovers, deployment streaming, a handle close() frees the
request's pages, the feed's round trip and cancel, a client's death, a
replica's death, concurrent clients, and per-item batch errors. The whole
slice: `tiny_paged_lm` deployed in both packages with the same weights
(the JAX package's init, carried across by models/convert.py) gives
exactly the same greedy tokens through the streaming handle and through
the LLMClient feed. Every wait has a deadline; every fixture shuts Serve
and the runtime down in a `finally`; nothing binds a fixed port.
"""

import functools
import importlib
import threading
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch
from torch_waits import bounded, wait_for

PACKAGES = {"jax": ray_tpu, "torch": ray_tpu_torch}


def _modules(name):
    pkg = PACKAGES[name]
    mod = importlib.import_module
    return SimpleNamespace(
        rt=pkg, exc=pkg.exceptions, serve=mod(f"{pkg.__name__}.serve"),
        llm=mod(f"{pkg.__name__}.serve.llm"), chaos=mod(f"{pkg.__name__}.chaos"),
        controller=mod(f"{pkg.__name__}.serve.controller"),
        model=mod(f"{pkg.__name__}.serve.llm.model"))


@pytest.fixture(params=sorted(PACKAGES))
def pk(request):
    m = _modules(request.param)
    m.rt.shutdown()
    m.rt.init(local_mode=True, num_cpus=8)
    try:
        yield m
    finally:
        try:
            m.serve.shutdown()
        finally:
            m.rt.shutdown()


def _stub_tokens(prompt, n, vocab=256):
    first = (sum(prompt) + 1) % vocab
    return [(first + i) % vocab for i in range(n)]


def _deploy_stub(pk, name, **model_kw):
    app = pk.llm.llm_deployment(
        pk.model.stub_model, name=name, model_kwargs=model_kw,
        engine_config=pk.llm.EngineConfig(page_tokens=4, pool_pages=32))
    return pk.serve.run(app, name=name, http_port=None)


def _replica_for(pk, name):
    controller = pk.controller.get_or_create_controller()
    _, replicas = pk.rt.get(controller.get_replicas.remote(name), timeout=10)
    assert replicas
    return replicas[0]


def _engine_stats(pk, replica):
    return pk.rt.get(replica.handle_request.remote("engine_stats", (), {}), timeout=10)


def test_engine_chaos_decode_fault_fails_fast_then_recovers(pk):
    eng = pk.llm.InferenceEngine(pk.llm.StubModel(step_delay_s=0.01),
                                 pk.llm.EngineConfig(page_tokens=4, pool_pages=16),
                                 name="t-chaos")
    try:
        pk.chaos.configure([{"point": "serve.decode", "action": "raise", "times": 1}])
        with pytest.raises(pk.exc.RayTpuError):
            bounded(lambda: list(eng.generate([1, 2, 3], 10)))
        assert wait_for(lambda: eng.alloc.used_pages() == 0, timeout=5.0)
        assert pk.chaos.controller().stats()[0]["injected"] == 1
        assert bounded(lambda: list(eng.generate([1, 2, 3], 4))) == _stub_tokens([1, 2, 3], 4)
    finally:
        pk.chaos.disable()
        eng.close()


def test_deployment_streaming(pk):
    handle = _deploy_stub(pk, "llm-stream")
    got = bounded(lambda: list(handle.options(stream=True).remote([1, 2, 3], 5)))
    assert got == _stub_tokens([1, 2, 3], 5)
    replica = _replica_for(pk, "llm-stream")
    stats = wait_for(lambda: (s := _engine_stats(pk, replica))["kv"]["used_pages"] == 0 and s)
    assert stats and stats["tokens_emitted"] >= 5


def test_handle_stream_close_cancels_and_frees_pages(pk):
    handle = _deploy_stub(pk, "llm-hclose", step_delay_s=0.02)
    replica = _replica_for(pk, "llm-hclose")
    gen = handle.options(stream=True).remote([1, 2, 3], 25)
    assert bounded(lambda: [next(gen), next(gen)]) == _stub_tokens([1, 2, 3], 25)[:2]
    gen.close()
    assert wait_for(lambda: (s := _engine_stats(pk, replica))["running"] == 0
                     and s["kv"]["used_pages"] == 0, timeout=10.0)
    assert _engine_stats(pk, replica)["tokens_emitted"] < 25  # interrupted, not finished
    gen.close()  # idempotent; the deployment keeps serving
    assert bounded(lambda: list(handle.options(stream=True).remote([9], 3))) == _stub_tokens([9], 3)


def test_feed_round_trip_and_cancel(pk):
    _deploy_stub(pk, "llm-feed", step_delay_s=0.01)
    replica = _replica_for(pk, "llm-feed")
    client = pk.llm.LLMClient("llm-feed")
    try:
        assert bounded(lambda: list(client.generate([4, 5], 4))) == _stub_tokens([4, 5], 4)
        it = client.generate([6, 7, 8], 25)
        bounded(lambda: next(it))
        it.close()
        assert wait_for(lambda: _engine_stats(pk, replica)["kv"]["used_pages"] == 0,
                         timeout=10.0)
        assert _engine_stats(pk, replica)["running"] == 0
        assert bounded(lambda: list(client.generate([9], 3))) == _stub_tokens([9], 3)
    finally:
        client.close()


def test_feed_client_death_frees_pages(pk):
    _deploy_stub(pk, "llm-cdie", step_delay_s=0.02)
    replica = _replica_for(pk, "llm-cdie")
    client = pk.llm.LLMClient("llm-cdie")
    try:
        it = client.generate([1, 2, 3], 25)
        bounded(lambda: next(it))
        assert _engine_stats(pk, replica)["kv"]["used_pages"] > 0
        client.resp_reader.close()  # the client vanishes: no polite detach
        client.req_writer.close()
        assert wait_for(lambda: _engine_stats(pk, replica)["kv"]["used_pages"] == 0,
                        timeout=15.0)
        assert _engine_stats(pk, replica)["running"] == 0
    finally:
        client.close()


def test_feed_replica_death_fails_fast(pk):
    _deploy_stub(pk, "llm-rdie", step_delay_s=0.02)
    replica = _replica_for(pk, "llm-rdie")
    client = pk.llm.LLMClient("llm-rdie")
    try:
        it = client.generate([1, 2], 25)
        bounded(lambda: next(it))
        pk.rt.get(replica.handle_request.remote("shutdown_engine", (), {}), timeout=10)
        with pytest.raises((pk.exc.ActorDiedError, pk.exc.RayTpuError)):
            bounded(lambda: list(it), timeout=15.0)  # fails fast, not wedged
        with pytest.raises(pk.exc.ActorDiedError):
            bounded(lambda: list(client.generate([3], 2)))
    finally:
        client.close()


def test_concurrent_clients(pk):
    handle = _deploy_stub(pk, "llm-many")
    results = {}

    def call(i):
        results[i] = list(handle.options(stream=True).remote([i], 4))

    threads = [threading.Thread(target=call, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert results == {i: _stub_tokens([i], 4) for i in range(6)}


def test_batch_per_item_error_isolation_and_whole_batch_failure(pk):
    serve = pk.serve

    @serve.deployment(max_ongoing_requests=16)
    class Half:
        @serve.batch(max_batch_size=4, batch_wait_timeout_s=0.5)
        def __call__(self, items):
            return [ValueError(f"odd input {i}") if i % 2 else i * 10 for i in items]

    @serve.deployment(max_ongoing_requests=16)
    class Boom:
        @serve.batch(max_batch_size=4, batch_wait_timeout_s=0.3)
        def __call__(self, items):
            raise RuntimeError("whole batch down")

    handle = serve.run(Half.bind(), name="peritem", http_port=None)
    resps = [handle.remote(i) for i in range(4)]
    assert resps[0].result(timeout=30) == 0
    assert resps[2].result(timeout=30) == 20
    for odd in (1, 3):
        with pytest.raises(pk.exc.BatchItemError, match="odd input"):
            resps[odd].result(timeout=30)
    boom = serve.run(Boom.bind(), name="boom", http_port=None)
    for r in [boom.remote(i) for i in range(3)]:
        with pytest.raises(Exception, match="whole batch down"):
            r.result(timeout=30)


def test_port_engine_records_its_metrics():
    """The port's engine carries the JAX engine's raytpu_* handles:
    decode steps land in raytpu_serve_tpot_ms, the pool's size and
    occupancy in the KV gauges, prompt pages in the prefix-cache
    counters, sheds in raytpu_serve_requests_shed_total."""
    from ray_tpu_torch.serve.llm import EngineConfig, InferenceEngine, StubModel
    from ray_tpu_torch.utils import internal_metrics as imet

    key = (("deployment", "t-metrics"),)
    eng = InferenceEngine(StubModel(max_pages_per_seq=32),
                          EngineConfig(page_tokens=4, pool_pages=8), name="t-metrics")
    try:
        got = bounded(lambda: list(eng.generate([1, 2, 3, 4, 5], 3)))
        assert got == _stub_tokens([1, 2, 3, 4, 5], 3)
        snap = imet.snapshot()
        assert snap["raytpu_kv_pages_total"][key] == eng.alloc.total_pages
        assert snap["raytpu_prefix_cache_misses_total"][key] == 2
        assert snap["raytpu_serve_tpot_ms"][key]["count"] == eng.stats()["decode_steps"]
        assert wait_for(lambda: imet.snapshot()["raytpu_kv_pages_used"][key] == 0)
        with pytest.raises(ray_tpu_torch.KVPoolExhaustedError):
            bounded(lambda: list(eng.generate(list(range(40)), 2)))  # 10 pages of 4 > the pool
        assert imet.snapshot()["raytpu_serve_requests_shed_total"][key] == 1
    finally:
        eng.close()


# ------------------------------------------------------------- whole slice

GEO = dict(num_pages=32, page_tokens=8, max_slots=2, max_pages_per_seq=8)
PROMPTS = [[3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5], [2, 7, 1, 8], [200, 100, 50, 25, 12, 6, 3, 1, 9]]


def _twin_builders():
    from ray_tpu.models import transformer as jtfm
    from ray_tpu.serve.llm.model import PagedLM as JaxPagedLM
    from ray_tpu_torch.models import transformer as ttfm
    from ray_tpu_torch.models.convert import params_from_numpy
    from ray_tpu_torch.serve.llm.model import tiny_paged_lm

    jcfg = jtfm.tiny(attn_impl="full", dtype=jnp.float32)
    tcfg = ttfm.tiny(attn_impl="full", dtype=torch.float32)
    jparams = jtfm.init_params(jax.random.PRNGKey(0), jcfg)
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    return {
        "jax": functools.partial(JaxPagedLM, jcfg, jparams, **GEO),
        "torch": functools.partial(tiny_paged_lm, cfg=tcfg,
                                   params=params_from_numpy(np_params, tcfg, device="cpu"),
                                   device="cpu", **GEO),
    }


def _serve_both_ways(name, builder, n_new=6):
    """Greedy tokens of PROMPTS through the streaming handle and through the
    LLMClient feed of one tiny_paged_lm deployment, all in flight at once."""
    m = _modules(name)
    m.rt.shutdown()
    m.rt.init(local_mode=True, num_cpus=8)
    try:
        app = m.llm.llm_deployment(builder, name="tiny",
                                   engine_config=m.llm.EngineConfig(page_tokens=8, pool_pages=32))
        handle = m.serve.run(app, name="tiny", http_port=None)
        client = m.llm.LLMClient("tiny")
        try:
            out = {}

            def run(key, fn, prompt):
                out[key] = list(fn(prompt, n_new))

            threads = [threading.Thread(target=run, args=((via, i), fn, p))
                       for via, fn in (("handle", handle.options(stream=True).remote),
                                       ("feed", client.generate))
                       for i, p in enumerate(PROMPTS)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            assert not any(t.is_alive() for t in threads)
        finally:
            client.close()
        return out
    finally:
        try:
            m.serve.shutdown()
        finally:
            m.rt.shutdown()


def test_tiny_paged_lm_deployed_in_both_packages_gives_the_same_tokens():
    builders = _twin_builders()
    got = {name: _serve_both_ways(name, b) for name, b in builders.items()}
    assert got["torch"] == got["jax"]
    for i in range(len(PROMPTS)):
        assert got["torch"][("handle", i)] == got["torch"][("feed", i)]
        assert len(got["torch"][("handle", i)]) == 6
