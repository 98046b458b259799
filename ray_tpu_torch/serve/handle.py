"""DeploymentHandle + power-of-two-choices routing (copy of
ray_tpu/serve/handle.py for the PyTorch port).

Re-design of the reference's request path (reference:
python/ray/serve/handle.py:625 DeploymentHandle.remote;
router.py:559 AsyncioRouter.assign_request;
replica_scheduler/pow_2_scheduler.py:52 PowerOfTwoChoicesReplicaScheduler,
choose_replica_for_request :813; proxy.py:779 HTTPProxy). The handle
keeps client-side outstanding counters per replica and picks the less
loaded of two random candidates — the same O(1) balancing argument as the
reference's queue-length-probe scheduler without the probe RPC.

The HTTP proxy (ProxyASGIApp on a threaded stdlib server, `start_proxy`)
routes `/<app>` to the app's handle, streams generator responses as chunked
bodies and sheds requests past RAY_TPU_PROXY_MAX_INFLIGHT with 503; its
`serve.http` span is the root the handle's `serve.request` span parents to.
It runs in the driver's process on either runtime. The gRPC ingress is
serve/grpc_proxy.py.
"""

from __future__ import annotations

import json
import os
import random
import threading
from typing import Any, Dict, List, Optional

from .. import api
from .. import tracing as _tracing
from .controller import CONTROLLER_NAME, Replica

_STREAM_MARKER = Replica.STREAM_MARKER  # single definition of the sentinel

_stream_exec = None
_stream_exec_lock = threading.Lock()


def _stream_executor():
    """Shared pool for blocking chunk pulls: per-request default executors
    would churn threads on every streaming response."""
    global _stream_exec
    if _stream_exec is None:
        import concurrent.futures

        with _stream_exec_lock:
            if _stream_exec is None:
                _stream_exec = concurrent.futures.ThreadPoolExecutor(
                    max_workers=32, thread_name_prefix="serve-stream"
                )
    return _stream_exec


class DeploymentResponse:
    """Future-like response (reference: serve/handle.py DeploymentResponse)."""

    def __init__(self, ref, on_done, replica=None, trace=None):
        self._ref = ref
        self._on_done = on_done
        self._replica = replica
        self._done = False
        # (app, trace_ctx) from the handle: result() re-roots the request
        # span's context (same trace_id) and ends the request->response
        # flow arrow via the flow id riding the ctx.
        self._trace = trace

    def _finish(self):
        if not self._done:
            self._done = True
            self._on_done()

    def result(self, timeout: Optional[float] = None) -> Any:
        import contextlib
        import time as _time

        deadline = None if timeout is None else _time.monotonic() + timeout
        span_cm = contextlib.nullcontext()
        if self._trace and _tracing.is_enabled():
            app, ctx = self._trace
            span_cm = _tracing.continue_context(
                ctx, f"serve.response {app}", {"app": app}
            )
        try:
            with span_cm:
                out = api.get(self._ref, timeout=timeout)
        except BaseException:
            self._finish()
            raise
        if isinstance(out, dict) and _STREAM_MARKER in out:
            # A generator response consumed non-streaming: drain it within
            # the caller's deadline. The replica stays "loaded" in the
            # router's counters until the drain completes.
            try:
                return list(self._iter_stream(out[_STREAM_MARKER], deadline))
            finally:
                self._finish()
        self._finish()
        return out

    def _iter_stream(self, stream_id: str, deadline: Optional[float] = None):
        import time as _time

        from .. import exceptions as exc

        while True:
            remaining = 60.0
            if deadline is not None:
                remaining = deadline - _time.monotonic()
                if remaining <= 0:
                    raise exc.GetTimeoutError("stream drain timed out")
            chunks, done = api.get(
                self._replica.next_chunks.remote(stream_id),
                timeout=min(60.0, remaining + 10.0),
            )
            yield from chunks
            if done:
                return


class DeploymentResponseGenerator:
    """Iterates a streaming deployment response chunk-by-chunk.

    Rides the CORE streaming-generator primitive: the replica method runs
    as a `num_returns="streaming"` actor task, each yielded chunk becomes
    a return object delivered as produced, and this wrapper resolves them
    to values (reference: serve/handle.py DeploymentResponseGenerator over
    the streaming generator protocol of _raylet.pyx:281 — here the same
    layering, serve on top of core streaming)."""

    def __init__(self, ref_gen, on_done, on_cancel=None):
        self._gen = ref_gen
        self._on_done = on_done
        self._on_cancel = on_cancel
        self._finished = False

    def _finish(self):
        if not self._finished:
            self._finished = True
            self._on_done()

    def __iter__(self):
        return self

    def __next__(self):
        if self._gen is None:
            raise StopIteration
        # The outstanding counter holds until the stream is drained, so
        # pow-2 routing sees long-lived streams as load.
        try:
            ref = next(self._gen)
        except BaseException:
            self._finish()
            raise
        try:
            return api.get(ref)
        except BaseException:
            self._finish()
            raise

    def close(self):
        """Cancels the stream server-side (client disconnect). The
        replica's cancel_stream stops the handler at the next chunk
        boundary — and immediately for handlers with their own
        cancel_stream hook (the LLM engine frees the request's KV pages
        and batch slot within one decode step); unconsumed chunk objects
        free when the underlying ref generator is dropped."""
        if self._finished:
            self._gen = None  # already drained/errored: nothing to cancel
            return
        if self._on_cancel is not None:
            try:
                self._on_cancel()
            except Exception:  # lint: swallow-ok(cancel is best-effort; replica may be dead already)
                pass
        self._gen = None  # drops the ref generator -> stream_done frees
        self._finish()

    def __del__(self):
        # An abandoned stream (for-loop break, dropped handle) must not
        # keep producing server-side.
        try:
            self.close()
        except Exception:  # lint: swallow-ok(__del__ during interpreter teardown)
            pass


class DeploymentHandle:
    """(reference: serve/handle.py:625)"""

    def __init__(self, app_name: str, method_name: str = "__call__"):
        self._app = app_name
        self._method = method_name
        self._stream = False
        self._mux_id: Optional[str] = None
        self._controller = api.get_actor(CONTROLLER_NAME)
        self._version = -1
        self._replicas: List[Any] = []
        self._outstanding: Dict[Any, int] = {}
        self._lock = threading.Lock()
        self._refresh()

    def __reduce__(self):
        # Handles travel into replica constructors (deployment
        # composition): rebuild from names at the destination — the
        # resolved controller actor, lock, and replica cache are
        # process-local (reference: serve handles are serializable and
        # re-resolve server-side).
        return (_rebuild_handle, (self._app, self._method, self._stream, self._mux_id))

    def options(
        self,
        method_name: Optional[str] = None,
        stream: Optional[bool] = None,
        multiplexed_model_id: Optional[str] = None,
    ) -> "DeploymentHandle":
        h = DeploymentHandle.__new__(DeploymentHandle)
        h.__dict__.update(self.__dict__)
        if method_name is not None:
            h._method = method_name
        if stream is not None:
            h._stream = stream
        if multiplexed_model_id is not None:
            h._mux_id = multiplexed_model_id
        return h

    def _refresh(self, force: bool = False) -> None:
        version = api.get(self._controller.version.remote())
        if version == self._version and not force and self._replicas:
            return
        self._version, self._replicas = api.get(
            self._controller.get_replicas.remote(self._app)
        )
        with self._lock:
            self._outstanding = {r._id: self._outstanding.get(r._id, 0) for r in self._replicas}

    def _choose_replica(self):
        """Power of two choices over client-side outstanding counts
        (reference: pow_2_scheduler.py:813). Multiplexed requests route by
        model-id hash instead: the same model consistently lands on the
        same replica, so its weights stay resident in that replica's HBM
        (reference: the model-locality ranking in
        replica_scheduler/pow_2_scheduler — collapsed to consistent
        hashing, which needs no cross-client model registry)."""
        self._refresh()
        if not self._replicas:
            raise RuntimeError(f"no replicas for app {self._app!r}")
        if len(self._replicas) == 1:
            return self._replicas[0]
        if self._mux_id is not None:
            import zlib

            idx = zlib.crc32(self._mux_id.encode()) % len(self._replicas)
            return self._replicas[idx]
        a, b = random.sample(self._replicas, 2)
        with self._lock:
            return a if self._outstanding.get(a._id, 0) <= self._outstanding.get(b._id, 0) else b

    def remote(self, *args, **kwargs) -> DeploymentResponse:
        replica = self._choose_replica()
        rid = replica._id
        with self._lock:
            self._outstanding[rid] = self._outstanding.get(rid, 0) + 1

        def done():
            with self._lock:
                if rid in self._outstanding:
                    self._outstanding[rid] -= 1

        context = (
            {"multiplexed_model_id": self._mux_id} if self._mux_id is not None else None
        )
        # Router span: the replica-side handling span parents to it (and
        # shares its trace_id) via the actor-task trace_ctx the core
        # submission path injects; `flow_out` additionally arrows
        # request->response in the Perfetto view. TTFT falls out of the
        # replica span's start minus this span's start.
        traced = _tracing.is_enabled()
        resp_flow = _tracing.new_flow_id() if traced else None
        span_cm = (
            _tracing.span(
                f"serve.request {self._app}",
                {
                    "app": self._app,
                    "method": self._method,
                    "replica": str(rid),
                    "flow_out": resp_flow,
                },
            )
            if traced
            else None
        )
        if self._stream:
            import uuid as _uuid

            # Client-generated: travels in the request context so a later
            # close() can name this stream to the replica.
            cancel_token = _uuid.uuid4().hex
            context = {**(context or {}), "cancel_token": cancel_token}
            with span_cm or _tracing.null_span():
                ref_gen = replica.handle_request_stream.options(
                    num_returns="streaming"
                ).remote(self._method, args, kwargs, context)

            def cancel():
                replica.cancel_stream.remote(cancel_token)

            return DeploymentResponseGenerator(ref_gen, done, on_cancel=cancel)
        resp_ctx = None
        with span_cm or _tracing.null_span() as sp:
            ref = replica.handle_request.remote(self._method, args, kwargs, context)
            if sp is not None:
                resp_ctx = {
                    "trace_id": sp["trace_id"],
                    "span_id": sp["span_id"],
                    "flow": resp_flow,
                }
        return DeploymentResponse(
            ref,
            done,
            replica=replica,
            trace=(self._app, resp_ctx) if resp_ctx else None,
        )


# ------------------------------------------------------------------ proxy


class ProxyASGIApp:
    """The proxy as an ASGI application (reference: proxy.py:874 HTTPProxy
    — the ASGI callable served by uvicorn there). Any ASGI server can host
    this app; the built-in _ProxyServer below runs it on a threaded stdlib
    HTTP server via a minimal adapter. Routing: first path segment ->
    deployment handle; generator handlers stream as chunked responses;
    bytes bodies pass through untouched (non-JSON friendly)."""

    # Backpressure: the proxy admits a bounded number of in-flight
    # requests and sheds the rest with 503 instead of queueing without
    # limit (reference: proxy.py's max_ongoing-based admission; env
    # override RAY_TPU_PROXY_MAX_INFLIGHT).
    MAX_INFLIGHT = int(os.environ.get("RAY_TPU_PROXY_MAX_INFLIGHT", "256"))

    def __init__(self, proxy: "_ProxyServer"):
        self._proxy = proxy
        self._inflight = [0]
        self._inflight_lock = threading.Lock()

    async def __call__(self, scope, receive, send):
        assert scope["type"] == "http"
        with self._inflight_lock:
            if self._inflight[0] >= self.MAX_INFLIGHT:
                shed = True
            else:
                shed = False
                self._inflight[0] += 1
        if shed:
            await self._respond_json(
                send, 503, {"error": "proxy saturated; retry later"}
            )
            return
        try:
            await self._serve_one(scope, receive, send)
        finally:
            with self._inflight_lock:
                self._inflight[0] -= 1

    async def _serve_one(self, scope, receive, send):
        # Root span of an HTTP request's trace: the handle's serve.request
        # span (opened inside, same thread/context) parents here, the
        # replica execution follows via the propagated trace_ctx — one
        # trace_id across proxy -> router -> replica.
        with _tracing.span(
            f"serve.http {scope.get('path', '/')}",
            {"method": scope.get("method", "?"), "path": scope.get("path", "")},
        ):
            await self._serve_one_traced(scope, receive, send)

    async def _serve_one_traced(self, scope, receive, send):
        path = scope["path"].strip("/")
        app = path.split("/")[0] if path else ""

        body = b""
        while True:
            message = await receive()
            if message["type"] == "http.request":
                body += message.get("body", b"")
                if not message.get("more_body", False):
                    break
            elif message["type"] == "http.disconnect":
                return

        try:
            handle = self._proxy._handle_for(app)
        except Exception as e:  # noqa: BLE001
            await self._respond_json(send, 404, {"error": f"no app {app!r}: {e}"})
            return

        headers = {k.decode().lower(): v.decode() for k, v in scope.get("headers", [])}
        payload = self._decode_body(body, headers.get("content-type", ""))
        sent_start = [False]

        async def tracking_send(message):
            if message["type"] == "http.response.start":
                sent_start[0] = True
            await send(message)

        try:
            stream = handle.options(stream=True).remote(*(() if payload is None else (payload,)))
            await self._respond_stream(tracking_send, stream)
        except Exception as e:  # noqa: BLE001
            if sent_start[0]:
                # Headers already on the wire: propagate so the server
                # closes the connection WITHOUT the terminal chunk — a
                # cleanly terminated chunked body would make the partial
                # result indistinguishable from success.
                raise
            await self._respond_json(send, 500, {"error": repr(e)})

    @staticmethod
    def _decode_body(body: bytes, content_type: str) -> Any:
        if not body:
            return None
        try:
            if "application/json" in content_type:
                return json.loads(body)
            if content_type.startswith("text/"):
                return body.decode()
            if not content_type:
                return json.loads(body)
        except (json.JSONDecodeError, UnicodeDecodeError):
            return body  # malformed declared type: raw passthrough
        return body  # binary passthrough

    @staticmethod
    def _encode_chunk(chunk: Any) -> tuple:
        if isinstance(chunk, bytes):
            return chunk, "application/octet-stream"
        if isinstance(chunk, str):
            return chunk.encode(), "text/plain; charset=utf-8"
        return json.dumps(chunk, default=str).encode(), "application/json"

    async def _respond_stream(self, send, stream) -> None:
        """Sends the handler's chunks as they arrive (chunked transfer).
        The first chunk decides the content type. Blocking pulls run in the
        executor so this app stays event-loop safe under any ASGI server.
        """
        import asyncio

        loop = asyncio.get_running_loop()
        it = iter(stream)
        sentinel = object()

        def pull():
            return next(it, sentinel)

        first = await loop.run_in_executor(_stream_executor(), pull)
        if first is sentinel:
            await self._respond_json(send, 200, None)
            return
        data, ctype = self._encode_chunk(first)
        await send(
            {
                "type": "http.response.start",
                "status": 200,
                "headers": [(b"content-type", ctype.encode())],
            }
        )
        await send({"type": "http.response.body", "body": data, "more_body": True})
        while True:
            chunk = await loop.run_in_executor(_stream_executor(), pull)
            if chunk is sentinel:
                break
            data, _ = self._encode_chunk(chunk)
            await send({"type": "http.response.body", "body": data, "more_body": True})
        await send({"type": "http.response.body", "body": b"", "more_body": False})

    async def _respond_json(self, send, status: int, payload: Any) -> None:
        data = json.dumps(payload, default=str).encode()
        await send(
            {
                "type": "http.response.start",
                "status": status,
                "headers": [(b"content-type", b"application/json")],
            }
        )
        await send({"type": "http.response.body", "body": data, "more_body": False})


class HandleCache:
    """Thread-safe app -> DeploymentHandle cache shared by the HTTP and
    gRPC proxies (one handle per app keeps pow-2 outstanding counters
    accurate)."""

    def __init__(self):
        self._handles: Dict[str, DeploymentHandle] = {}
        self._lock = threading.Lock()

    def get(self, app: str) -> DeploymentHandle:
        with self._lock:
            cached = self._handles.get(app)
        if cached is not None:
            return cached
        controller = api.get_actor(CONTROLLER_NAME)
        apps = api.get(controller.list_apps.remote())
        name = app
        if app not in apps:
            if app == "" and len(apps) == 1:
                name = apps[0]
            else:
                raise KeyError(f"no app {app!r}; deployed: {apps}")
        handle = DeploymentHandle(name)
        with self._lock:
            return self._handles.setdefault(app, handle)


class _ProxyServer:
    """Hosts ProxyASGIApp on a threaded stdlib HTTP server through a
    minimal ASGI adapter (chunked transfer for multi-part bodies). In a
    production deployment the same app runs under any ASGI server."""

    def __init__(self, host: str = "127.0.0.1", port: int = 8000):
        import http.server
        import socketserver

        asgi_app = ProxyASGIApp(self)

        class Handler(http.server.BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def _run_asgi(self, body: bytes):
                import asyncio
                from urllib.parse import urlsplit

                parts = urlsplit(self.path)
                scope = {
                    "type": "http",
                    "asgi": {"version": "3.0"},
                    "http_version": "1.1",
                    "method": self.command,
                    "path": parts.path,
                    "raw_path": self.path.encode(),
                    "query_string": parts.query.encode(),
                    "headers": [
                        (k.lower().encode(), v.encode()) for k, v in self.headers.items()
                    ],
                }
                received = [False]

                async def receive():
                    if received[0]:
                        return {"type": "http.disconnect"}
                    received[0] = True
                    return {"type": "http.request", "body": body, "more_body": False}

                async def send(message):
                    if message["type"] == "http.response.start":
                        self.send_response(message["status"])
                        for k, v in message.get("headers", []):
                            self.send_header(k.decode(), v.decode())
                        # Length unknown until the stream ends: chunked.
                        self.send_header("Transfer-Encoding", "chunked")
                        self.end_headers()
                    elif message["type"] == "http.response.body":
                        chunk = message.get("body", b"")
                        if chunk:
                            self.wfile.write(
                                f"{len(chunk):x}\r\n".encode() + chunk + b"\r\n"
                            )
                            self.wfile.flush()
                        if not message.get("more_body", False):
                            self.wfile.write(b"0\r\n\r\n")
                            self.wfile.flush()

                try:
                    asyncio.run(asgi_app(scope, receive, send))
                except Exception:  # noqa: BLE001
                    # Mid-stream failure after headers: drop the connection
                    # without the terminal chunk so the client observes a
                    # truncated (failed) transfer, not a short success.
                    self.close_connection = True

            def _handle(self):
                # Always drain the declared body (any method): leftover
                # bytes would corrupt the next request on this keep-alive
                # connection.
                n = int(self.headers.get("Content-Length", 0))
                self._run_asgi(self.rfile.read(n) if n else b"")

            do_GET = do_POST = do_PUT = do_DELETE = _handle

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._handle_cache = HandleCache()
        self._server = Server((host, port), Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(target=self._server.serve_forever, daemon=True)
        self._thread.start()

    def _handle_for(self, app: str) -> DeploymentHandle:
        return self._handle_cache.get(app)

    def shutdown(self):
        self._server.shutdown()
        self._server.server_close()


_proxy: Optional[_ProxyServer] = None


def start_proxy(port: int = 0) -> int:
    """Starts (or returns) the node's HTTP proxy; returns the bound port."""
    global _proxy
    if _proxy is None:
        _proxy = _ProxyServer(port=port)
    return _proxy.port


def stop_proxy() -> None:
    global _proxy
    if _proxy is not None:
        _proxy.shutdown()
        _proxy = None


def _rebuild_handle(
    app_name: str, method_name: str, stream: bool, mux_id: Optional[str] = None
) -> "DeploymentHandle":
    h = DeploymentHandle(app_name, method_name)
    h._stream = stream
    h._mux_id = mux_id
    return h
