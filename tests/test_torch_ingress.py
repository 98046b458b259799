"""The port's Serve ingress side by side with the JAX package's: the HTTP
proxy (`serve.run(..., http_port=0)`), the gRPC proxy and the channel-fed
FeatureTable.

Every case runs four times (tests/torch_modes.py): on `ray_tpu.serve` and
on `ray_tpu_torch.serve`, each over its package's `init(local_mode=True)`
and over a cluster whose controller and replicas are worker processes, with
the same deployments and inputs, and asserts the same outcome. The proxy
itself runs in the test's process on both runtimes. HTTP cases: unary JSON,
text and bytes bodies; a generator's chunked stream, read chunk by chunk
from the raw framing over a socket; 404 for an unknown app; 503 past
`ProxyASGIApp.MAX_INFLIGHT`; the proxy's `serve.http` span parenting the
handle's `serve.request`. The gRPC case (unary and server streaming) skips,
deciding inside the test, where grpcio is absent. FeatureTable: a dataset's
rows ingested through a ChannelFeed, looked up and evicted LRU alike. Every
wait has a deadline; nothing binds a fixed port.
"""

import importlib
import json
import os
import socket
import sys
import threading
import time
import urllib.error
import urllib.request
from types import SimpleNamespace

import pytest

import torch_modes
from ray_tpu_torch.core import serialization
from torch_waits import bounded, wait_for

serialization.register_pickle_by_value(sys.modules[__name__])

CASE_S = 120


@pytest.fixture(scope="module")
def clusters():
    booted = torch_modes.Clusters(num_cpus=8)
    try:
        yield booted
    finally:
        booted.shutdown()


@pytest.fixture(params=torch_modes.PARAMS, ids=torch_modes.IDS)
def pk(request):
    name, mode = request.param
    clusters = request.getfixturevalue("clusters") if mode == "cluster" else None
    with torch_modes.case_time_limit(request, CASE_S):
        with torch_modes.runtime_for(clusters, name, mode, num_cpus=8) as pkg:
            serve = importlib.import_module(f"{pkg.__name__}.serve")
            handle = importlib.import_module(f"{pkg.__name__}.serve.handle")
            try:
                yield SimpleNamespace(rt=pkg, serve=serve, handle=handle, mode=mode, name=name,
                                      data=importlib.import_module(f"{pkg.__name__}.data"))
            finally:
                serve.shutdown()


def _post(port, path, body: bytes, ctype: str):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/{path}", data=body,
                                 headers={"Content-Type": ctype})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.status, resp.headers["Content-Type"], resp.read()


def http_chunks(port, path, body: bytes = b"", ctype="application/json", timeout=60.0):
    """POSTs `body` and reads the response's chunked framing off the socket
    itself: (status, headers, [chunk bytes, ...]), one entry per chunk."""
    with socket.create_connection(("127.0.0.1", port), timeout=timeout) as s:
        s.sendall(f"POST /{path} HTTP/1.1\r\nHost: x\r\nContent-Type: {ctype}\r\n"
                  f"Content-Length: {len(body)}\r\nConnection: close\r\n\r\n".encode() + body)
        f = s.makefile("rb")
        status = int(f.readline().split()[1])
        headers = {}
        while True:
            line = f.readline().strip()
            if not line:
                break
            k, v = line.decode().split(":", 1)
            headers[k.strip().lower()] = v.strip()
        chunks = []
        while True:
            size = int(f.readline().strip(), 16)
            if size == 0:
                f.readline()
                return status, headers, chunks
            chunks.append(f.read(size))
            f.readline()


def test_http_unary_json_text_and_bytes(pk):
    serve = pk.serve

    @serve.deployment
    def echo(payload):
        return {"echo": payload, "ok": True}

    @serve.deployment
    def shout(text):
        return text.upper()

    @serve.deployment
    def invert(payload):
        assert isinstance(payload, bytes)
        return bytes(255 - b for b in payload)

    serve.run(echo.bind(), name="echo", http_port=0)
    serve.run(shout.bind(), name="shout", http_port=0)
    serve.run(invert.bind(), name="invert", http_port=0)
    port = pk.handle._proxy.port
    assert _post(port, "echo", json.dumps({"msg": "hi"}).encode(), "application/json") == (
        200, "application/json", json.dumps({"echo": {"msg": "hi"}, "ok": True}).encode())
    assert _post(port, "shout", b"gpu", "text/plain") == (
        200, "text/plain; charset=utf-8", b"GPU")
    raw = bytes(range(16))
    assert _post(port, "invert", raw, "application/octet-stream") == (
        200, "application/octet-stream", bytes(255 - b for b in raw))


def test_http_stream_is_chunked_one_chunk_per_item(pk):
    serve = pk.serve

    @serve.deployment
    def stream(n):
        for i in range(n):
            yield {"i": i, "sq": i * i}

    serve.run(stream.bind(), name="stream", http_port=0)
    status, headers, chunks = bounded(
        lambda: http_chunks(pk.handle._proxy.port, "stream", b"5"), CASE_S)
    assert status == 200 and headers["transfer-encoding"] == "chunked"
    assert headers["content-type"] == "application/json"
    assert [json.loads(c) for c in chunks] == [{"i": i, "sq": i * i} for i in range(5)]


def test_http_unknown_app_is_404(pk):
    serve = pk.serve

    @serve.deployment
    def known(x):
        return x

    serve.run(known.bind(), name="known", http_port=0)
    with pytest.raises(urllib.error.HTTPError) as err:
        _post(pk.handle._proxy.port, "nowhere", b"1", "application/json")
    assert err.value.code == 404
    assert "nowhere" in json.loads(err.value.read())["error"]


def test_http_sheds_past_max_inflight(pk, tmp_path, monkeypatch):
    """One request in flight at MAX_INFLIGHT 1: the next is shed with 503,
    and the first completes once released."""
    serve = pk.serve
    monkeypatch.setattr(pk.handle.ProxyASGIApp, "MAX_INFLIGHT", 1)
    started, release = str(tmp_path / "started"), str(tmp_path / "release")

    @serve.deployment
    def slow(x):
        open(started, "w").close()
        deadline = time.monotonic() + 60
        while not os.path.exists(release) and time.monotonic() < deadline:
            time.sleep(0.01)
        return x

    serve.run(slow.bind(), name="slow", http_port=0)
    port = pk.handle._proxy.port
    box = {}
    first = threading.Thread(target=lambda: box.update(r=_post(port, "slow", b"7",
                                                               "application/json")))
    first.start()
    try:
        assert wait_for(lambda: os.path.exists(started), timeout=60)
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(port, "slow", b"8", "application/json")
        assert err.value.code == 503
        assert "saturated" in json.loads(err.value.read())["error"]
    finally:
        open(release, "w").close()
        first.join(60)
    assert box["r"] == (200, "application/json", b"7")


def test_http_span_parents_the_handle_request(pk):
    tracing = importlib.import_module(f"{pk.rt.__name__}.tracing")
    serve = pk.serve

    @serve.deployment
    def traced(x):
        return x

    serve.run(traced.bind(), name="traced", http_port=0)
    exporter = tracing.InMemoryExporter()
    tracing.enable(exporter)
    try:
        assert _post(pk.handle._proxy.port, "traced", b"3", "application/json")[2] == b"3"
        # The terminal chunk goes out inside the span: its handler thread may
        # export it just after the client has the whole answer.
        wait_for(lambda: any(s["name"] == "serve.http /traced" for s in exporter.spans),
                 timeout=30)
    finally:
        tracing.disable()
    spans = {s["name"]: s for s in exporter.spans}
    http, req = spans["serve.http /traced"], spans["serve.request traced"]
    assert http["parent_id"] is None and req["parent_id"] == http["span_id"]
    assert req["trace_id"] == http["trace_id"]
    assert http["attrs"] == {"method": "POST", "path": "/traced"}


def test_grpc_unary_and_streaming(pk):
    grpc = pytest.importorskip("grpc")
    serve = pk.serve
    gproxy = importlib.import_module(f"{pk.rt.__name__}.serve.grpc_proxy")

    @serve.deployment
    class Svc:
        def __call__(self, payload):
            return {"got": payload}

        def stream_tokens(self, n):
            for i in range(n):
                yield f"tok{i}"

    serve.run(Svc.bind(), name="svc", http_port=None)
    port = gproxy.start_grpc_proxy(port=0)
    try:
        channel = grpc.insecure_channel(f"127.0.0.1:{port}")
        unary = channel.unary_unary("/svc/__call__", request_serializer=bytes,
                                    response_deserializer=bytes)
        assert json.loads(unary(json.dumps({"k": 1}).encode(), timeout=60)) == {"got": {"k": 1}}
        stream = channel.unary_stream("/svc/stream_tokens", request_serializer=bytes,
                                      response_deserializer=bytes)
        assert [c.decode() for c in stream(b"3", timeout=60)] == ["tok0", "tok1", "tok2"]
        missing = channel.unary_unary("/nowhere/__call__", request_serializer=bytes,
                                      response_deserializer=bytes)
        with pytest.raises(grpc.RpcError) as err:
            missing(b"1", timeout=60)
        assert err.value.code() == grpc.StatusCode.NOT_FOUND
        channel.close()
    finally:
        gproxy.stop_grpc_proxy()


def test_feature_table_ingest_and_lru(pk):
    """The same featurized dataset through a ChannelFeed into each package's
    FeatureTable: the same rows looked up, the same LRU survivors."""
    data, serve = pk.data, pk.serve

    def featurize(b):  # made here, so the JAX package cloudpickles it by value
        return {"id": b["id"], "feat": b["id"] * 0.5, "name": b["id"].astype(str)}

    feed = data.range(100, parallelism=4).map_batches(featurize).streaming_split(
        1).to_channel()[0]
    table = serve.FeatureTable(feed, key="id", batch_size=32, continuous=False)
    try:
        assert bounded(lambda: table.wait_for_epoch(timeout=60.0), CASE_S), table.stats()
        got = {k: table.lookup(k) for k in (0, 42, 99, 12345)}
        assert table.stats() == {"rows": 100, "rows_ingested": 100, "epochs_ingested": 1,
                                 "error": None}
    finally:
        table.close()
    assert got[12345] is None
    assert {k: (float(v["feat"]), str(v["name"])) for k, v in got.items() if v} == {
        0: (0.0, "0"), 42: (21.0, "42"), 99: (49.5, "99")}

    lru = serve.FeatureTable(data.range(50, parallelism=2).streaming_split(1).to_channel()[0],
                             key="id", max_rows=10, continuous=False)
    try:
        assert bounded(lambda: lru.wait_for_epoch(timeout=60.0), CASE_S), lru.stats()
        kept = [k for k in range(50) if lru.lookup(k) is not None]
        assert lru.stats()["rows"] == 10 and lru.stats()["rows_ingested"] == 50
    finally:
        lru.close()
    assert kept == list(range(40, 50))
