"""The port's Serve side by side with the JAX package's.

Every test runs twice, on `ray_tpu.serve` over `ray_tpu.init(local_mode=
True)` and on `ray_tpu_torch.serve` over `ray_tpu_torch.init(local_mode=
True)`, with the same deployments and inputs, and asserts the same
outcome: the cases of tests/test_serve.py that need no HTTP or gRPC proxy
(the port has neither yet). Every wait has a deadline; every fixture shuts
Serve and the runtime down in a `finally`; nothing binds a fixed port.
"""

import importlib
import threading
import time
from types import SimpleNamespace

import pytest

import ray_tpu
import ray_tpu_torch
from torch_waits import bounded

PACKAGES = {"jax": ray_tpu, "torch": ray_tpu_torch}


@pytest.fixture(params=sorted(PACKAGES))
def pk(request):
    pkg = PACKAGES[request.param]
    serve = importlib.import_module(f"{pkg.__name__}.serve")
    controller = importlib.import_module(f"{pkg.__name__}.serve.controller")
    pkg.shutdown()
    pkg.init(local_mode=True, num_cpus=8)
    try:
        yield SimpleNamespace(rt=pkg, serve=serve, controller=controller)
    finally:
        try:
            serve.shutdown()
        finally:
            pkg.shutdown()


def _num_replicas(pk, app):
    c = pk.controller.get_or_create_controller()
    return pk.rt.get(c.num_replicas.remote(app), timeout=10)


def test_deploy_and_call(pk):
    serve = pk.serve

    @serve.deployment
    class Greeter:
        def __init__(self, greeting: str):
            self.greeting = greeting

        def __call__(self, name: str) -> str:
            return f"{self.greeting}, {name}!"

        def shout(self, name: str) -> str:
            return f"{self.greeting.upper()}, {name.upper()}!"

    handle = serve.run(Greeter.bind("Hello"), name="greet", http_port=None)
    assert handle.remote("gpu").result(timeout=30) == "Hello, gpu!"
    assert handle.options(method_name="shout").remote("gpu").result(timeout=30) == "HELLO, GPU!"
    assert serve.get_app_handle("greet").remote("x").result(timeout=30) == "Hello, x!"


def test_function_deployment_replicas_and_p2c_spread(pk):
    serve = pk.serve

    @serve.deployment(num_replicas=3)
    def square(x):
        return x * x

    @serve.deployment(num_replicas=2)
    class Which:
        def __call__(self, _x=None):
            return id(self)

    handle = serve.run(square.bind(), name="sq", http_port=None)
    assert [handle.remote(i).result(timeout=30) for i in range(10)] == [i * i for i in range(10)]
    assert _num_replicas(pk, "sq") == 3
    which = serve.run(Which.bind(), name="which", http_port=None)
    assert len({which.remote(None).result(timeout=30) for _ in range(20)}) == 2


def test_redeploy_replaces_the_code_and_delete_removes_the_app(pk):
    serve = pk.serve

    @serve.deployment
    def v1(_):
        return "v1"

    @serve.deployment
    def v2(_):
        return "v2"

    handle = serve.run(v1.bind(), name="app", http_port=None)
    assert handle.remote(None).result(timeout=30) == "v1"
    handle = serve.run(v2.bind(), name="app", http_port=None)
    deadline = time.monotonic() + 10
    while handle.remote(None).result(timeout=30) != "v2" and time.monotonic() < deadline:
        time.sleep(0.1)
    assert handle.remote(None).result(timeout=30) == "v2"
    serve.delete("app")
    assert _num_replicas(pk, "app") == 0


def test_autoscaling_scales_up_under_load(pk):
    serve = pk.serve

    @serve.deployment(
        num_replicas=1,
        autoscaling_config={"min_replicas": 1, "max_replicas": 3,
                            "target_ongoing_requests": 1.0, "upscale_delay_s": 0.1},
    )
    def slow(_x):
        time.sleep(0.4)
        return "done"

    handle = serve.run(slow.bind(), name="slow", http_port=None)
    results = []

    def fire():
        results.append(handle.remote(1).result(timeout=30))

    threads = [threading.Thread(target=fire) for _ in range(12)]
    for t in threads:
        t.start()
    scaled = False
    deadline = time.monotonic() + 15
    while time.monotonic() < deadline and not scaled:
        scaled = _num_replicas(pk, "slow") > 1
        time.sleep(0.1)
    for t in threads:
        t.join(timeout=60)
    assert scaled, "autoscaler never scaled up under load"
    assert not any(t.is_alive() for t in threads)
    assert results == ["done"] * 12


def test_streaming_handle_sync_and_async_generators(pk):
    serve = pk.serve

    @serve.deployment
    def counter(n):
        for i in range(n):
            yield i

    @serve.deployment
    class AsyncStreamer:
        async def __call__(self, n):
            import asyncio

            for i in range(n):
                await asyncio.sleep(0.01)
                yield f"a{i}"

    handle = serve.run(counter.bind(), name="counter", http_port=None)
    assert bounded(lambda: list(handle.options(stream=True).remote(4))) == [0, 1, 2, 3]
    assert handle.remote(3).result(timeout=30) == [0, 1, 2]  # drained to a list
    astream = serve.run(AsyncStreamer.bind(), name="astream", http_port=None)
    assert bounded(lambda: list(astream.options(stream=True).remote(3))) == ["a0", "a1", "a2"]


def test_deployment_composition(pk):
    serve = pk.serve

    @serve.deployment
    class Tokenizer:
        def __call__(self, text):
            return text.split()

    @serve.deployment(num_replicas=2)
    class Pipeline:
        def __init__(self, tokenizer):
            self.tokenizer = tokenizer

        def __call__(self, text):
            tokens = self.tokenizer.remote(text).result(timeout=30)
            return {"n_tokens": len(tokens), "tokens": tokens}

    handle = serve.run(Pipeline.bind(Tokenizer.bind()), name="composed", http_port=None)
    assert handle.remote("the quick brown fox").result(timeout=60) == {
        "n_tokens": 4, "tokens": ["the", "quick", "brown", "fox"]}


def test_serve_batch_coalesces_and_flushes_partial_batches(pk):
    serve = pk.serve

    @serve.deployment(max_ongoing_requests=16)
    class Doubler:
        def __init__(self):
            self.batch_sizes = []

        @serve.batch(max_batch_size=4, batch_wait_timeout_s=0.5)
        def __call__(self, items):
            self.batch_sizes.append(len(items))
            return [i * 2 for i in items]

        def sizes(self):
            return self.batch_sizes

    @serve.deployment(max_ongoing_requests=8)
    class One:
        @serve.batch(max_batch_size=64, batch_wait_timeout_s=0.2)
        def __call__(self, items):
            return [len(items)] * len(items)

    handle = serve.run(Doubler.bind(), name="batcher", http_port=None)
    resps = [handle.remote(i) for i in range(4)]
    assert sorted(r.result(timeout=30) for r in resps) == [0, 2, 4, 6]
    sizes = handle.options(method_name="sizes").remote().result(timeout=30)
    assert sum(sizes) == 4 and max(sizes) >= 2, sizes
    one = serve.run(One.bind(), name="partial", http_port=None)
    t0 = time.monotonic()
    assert one.remote("x").result(timeout=30) == 1  # a batch of one
    assert time.monotonic() - t0 < 10.0


def test_serve_batch_result_count_mismatch_errors(pk):
    serve = pk.serve

    @serve.deployment
    class TooMany:
        @serve.batch(max_batch_size=4, batch_wait_timeout_s=0.05)
        def __call__(self, items):
            return items + [None]

    handle = serve.run(TooMany.bind(), name="toomany", http_port=None)
    with pytest.raises(Exception, match="returned 2 results for 1 requests"):
        handle.remote("x").result(timeout=30)


def test_serve_multiplexed_lru(pk):
    serve = pk.serve

    @serve.deployment
    class Mux:
        def __init__(self):
            self.load_log = []

        @serve.multiplexed(max_num_models_per_replica=2)
        def get_model(self, model_id):
            self.load_log.append(model_id)
            return {"id": model_id}

        def __call__(self, x):
            return [self.get_model()["id"], x]

        def loads(self):
            return self.load_log

    handle = serve.run(Mux.bind(), name="mux", http_port=None)
    for mid, x in (("a", 1), ("a", 2), ("b", 3), ("c", 4), ("a", 5)):
        assert handle.options(multiplexed_model_id=mid).remote(x).result(timeout=30) == [mid, x]
    assert handle.options(method_name="loads").remote().result(timeout=30) == ["a", "b", "c", "a"]


def test_port_serve_refuses_an_http_port():
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(local_mode=True, num_cpus=2)
    try:
        from ray_tpu_torch import serve

        @serve.deployment
        def f(x):
            return x

        with pytest.raises(NotImplementedError, match="HTTP proxy"):
            serve.run(f.bind(), name="f", http_port=0)
    finally:
        ray_tpu_torch.shutdown()


def test_serve_spans_match(pk):
    """With tracing on, one call through the handle opens the router's
    `serve.request <app>` span and the replica's `serve.replica <app>` span
    in both packages."""
    tracing = importlib.import_module(f"{pk.rt.__name__}.tracing")

    @pk.serve.deployment
    def echo(x):
        return x

    handle = pk.serve.run(echo.bind(), name="traced", http_port=None)
    exporter = tracing.InMemoryExporter()
    tracing.enable(exporter)
    try:
        assert handle.remote(7).result(timeout=30) == 7
    finally:
        tracing.disable()
    spans = {s["name"]: s for s in exporter.spans}
    assert {"serve.request traced", "serve.replica traced"} <= spans.keys(), sorted(spans)
    assert spans["serve.request traced"]["attrs"]["app"] == "traced"
    assert spans["serve.replica traced"]["attrs"] == {"app": "traced", "serve_method": "__call__"}
    assert all(s["end_us"] >= s["start_us"] for s in exporter.spans)
