"""gRPC ingress for serve deployments (the port of
ray_tpu/serve/grpc_proxy.py). `grpc` is imported inside `_GrpcProxy`: the
module loads without grpcio, and only starting the proxy needs it.

Re-design of the reference's gRPC proxy (reference:
python/ray/serve/_private/proxy.py gRPCProxy + grpc_util.py — there, user
proto services are registered and methods route to deployments). Here a
*generic* service (no codegen): the gRPC method path selects the app and
handler method (`/<app>/<method>`), request/response payloads are bytes —
JSON by convention, raw bytes passthrough otherwise — so any grpc client
can call deployments without sharing generated stubs. Server-streaming
methods map to generator handlers, mirroring the HTTP chunked path.
"""

from __future__ import annotations

import json
import threading
from typing import Any, Optional

from .handle import DeploymentHandle, HandleCache


def _decode(data: bytes) -> Any:
    if not data:
        return None
    try:
        return json.loads(data)
    except (json.JSONDecodeError, UnicodeDecodeError):
        return data


def _encode(value: Any) -> bytes:
    if isinstance(value, bytes):
        return value
    if isinstance(value, str):
        return value.encode()
    return json.dumps(value, default=str).encode()


class _GrpcProxy:
    def __init__(self, host: str = "127.0.0.1", port: int = 9000):
        import concurrent.futures

        import grpc

        from .. import exceptions as exc

        proxy = self
        self._handle_cache = HandleCache()

        def _abort(context, e: BaseException):
            # Distinguishable status codes (reference: the gRPC proxy maps
            # routing vs timeout vs handler failures distinctly).
            if isinstance(e, KeyError):
                context.abort(grpc.StatusCode.NOT_FOUND, str(e))
            if isinstance(e, exc.GetTimeoutError):
                context.abort(grpc.StatusCode.DEADLINE_EXCEEDED, str(e))
            context.abort(grpc.StatusCode.INTERNAL, repr(e))

        def _deadline(context) -> float:
            # Explicit client deadlines are honored as-is; deadline-less
            # calls get a server-side bound so a hung replica cannot pin
            # proxy worker threads forever (pool is finite).
            remaining = context.time_remaining()
            return remaining if remaining is not None else 300.0

        class Handler(grpc.GenericRpcHandler):
            def service(self, call_details):
                # Method path: /<app>/<method>
                parts = call_details.method.strip("/").split("/")
                if len(parts) != 2:
                    return None
                app, method = parts

                def unary(request: bytes, context):
                    try:
                        handle = proxy._handle_for(app).options(method_name=method)
                        out = handle.remote(
                            *(() if not request else (_decode(request),))
                        ).result(timeout=_deadline(context))
                        return _encode(out)
                    except Exception as e:  # noqa: BLE001
                        _abort(context, e)

                def streaming(request: bytes, context):
                    try:
                        handle = proxy._handle_for(app).options(
                            method_name=method, stream=True
                        )
                        for chunk in handle.remote(
                            *(() if not request else (_decode(request),))
                        ):
                            yield _encode(chunk)
                    except Exception as e:  # noqa: BLE001
                        _abort(context, e)

                # Cardinality: the client declares a server-streaming call
                # with metadata rtpu-streaming=1; the stream*-name
                # convention remains as a stubless fallback.
                md = dict(call_details.invocation_metadata or ())
                wants_stream = md.get("rtpu-streaming") == "1" or (
                    method.startswith("stream") or method.endswith("_stream")
                )
                if wants_stream:
                    return grpc.unary_stream_rpc_method_handler(
                        streaming,
                        request_deserializer=bytes,
                        response_serializer=bytes,
                    )
                return grpc.unary_unary_rpc_method_handler(
                    unary, request_deserializer=bytes, response_serializer=bytes
                )

        self._server = grpc.server(
            concurrent.futures.ThreadPoolExecutor(max_workers=16)
        )
        self._server.add_generic_rpc_handlers((Handler(),))
        self.port = self._server.add_insecure_port(f"{host}:{port}")
        if self.port == 0:
            raise RuntimeError(f"gRPC proxy failed to bind {host}:{port} (in use?)")
        self._server.start()

    def _handle_for(self, app: str) -> DeploymentHandle:
        return self._handle_cache.get(app)

    def shutdown(self):
        self._server.stop(grace=1.0)


_grpc_proxy: Optional[_GrpcProxy] = None
_lock = threading.Lock()


def start_grpc_proxy(port: int = 0, host: str = "127.0.0.1") -> int:
    """Starts (or returns) the node's gRPC ingress; returns the bound port."""
    global _grpc_proxy
    with _lock:
        if _grpc_proxy is None:
            _grpc_proxy = _GrpcProxy(host=host, port=port)
        return _grpc_proxy.port


def stop_grpc_proxy() -> None:
    global _grpc_proxy
    with _lock:
        if _grpc_proxy is not None:
            _grpc_proxy.shutdown()
            _grpc_proxy = None
