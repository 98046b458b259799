"""Minimal dual-transport RPC: length-prefixed pickle messages, threaded
server (the port of ray_tpu/core/rpc.py).

Stands in for the reference's gRPC layer (reference: src/ray/rpc/ — gRPC
client/server wrappers). Same shape: named handler methods on a service
object, request/reply with correlation ids, a retrying client. Two transports
behind one address string: a plain path is a Unix domain socket (a node's
own traffic: workers to their raylet, daemons of one host), and
`tcp://host:port` is TCP with TCP_NODELAY (the control plane between hosts:
the GCS and raylets of other hosts, raylet-to-raylet transfers, a remote
client).

The control plane speaks pickle, so anyone who can reach an open TCP port
can run code as this user. A TCP server therefore refuses to start without
a shared secret in RAY_TPU_AUTH_TOKEN, and drops every connection whose
first frame is not `RTPUAUTH:<token>`; a TCP client sends that frame first.
(The JAX copy only warns when the token is missing.)

Fault injection: the client's connect and call paths are the `net.connect`
and `net.call` chaos points, and the sites where a partition installed by
chaos/net.py black-holes traffic. Disarmed, each costs two global loads.

Payloads are plain pickle: task functions and arguments are already bytes
made by core/serialization.py when they reach this layer.
"""

from __future__ import annotations

import hmac
import os
import pickle
import random
import socket
import socketserver
import struct
import threading
import time
import uuid
from typing import Any, Optional, Tuple

from ..chaos import net as _netpart
from ..chaos.controller import controller as _chaos_controller
from ..chaos.controller import maybe_inject as _chaos_inject
from ..exceptions import RpcUnavailableError

_HDR = struct.Struct("<I")
AUTH_TOKEN_ENV = "RAY_TPU_AUTH_TOKEN"
# The first frame of an authenticated TCP connection: RTPUAUTH:<token>.
_AUTH_PREFIX = b"RTPUAUTH:"


def _net_chaos_armed() -> bool:
    """The net.* points' disarmed fast path: details and partition lookups
    are built only when a rule or a partition is armed."""
    return _chaos_controller() is not None or _netpart.active()


def require_auth_token(what: str) -> None:
    """Raises unless RAY_TPU_AUTH_TOKEN is set: `what` would serve TCP."""
    if not os.environ.get(AUTH_TOKEN_ENV):
        raise ValueError(
            f"refusing to serve the control plane on {what} without {AUTH_TOKEN_ENV}: "
            "anyone who reaches the port could run code as this user")


def parse_address(addr: str) -> Tuple[str, Any]:
    """("tcp", (host, port)) for tcp://host:port, else ("uds", path)."""
    if addr.startswith("tcp://"):
        host, sep, port = addr[6:].rpartition(":")
        if not sep or not host or not port.isdigit():
            raise ValueError(f"tcp address must be tcp://host:port, got {addr!r}")
        return "tcp", (host, int(port))
    return "uds", addr


def _send_msg(sock: socket.socket, payload: bytes) -> None:
    sock.sendall(_HDR.pack(len(payload)) + payload)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("socket closed")
        buf += chunk
    return bytes(buf)


def _recv_msg(sock: socket.socket) -> bytes:
    (n,) = _HDR.unpack(_recv_exact(sock, _HDR.size))
    return _recv_exact(sock, n)


class RpcServer:
    """Serves `service.<method>(*args, **kwargs)` calls on a UDS path or a
    tcp://host:port address (port 0: an ephemeral one; `address` is then
    the bound one, a wildcard host advertised as loopback).

    The service object's public methods are the RPC surface (mirrors the
    reference's per-service gRPC handlers). A request with id None is a
    one-way notification: executed, never answered. A server may be bound
    before its service exists (a raylet learns the port it advertises
    first): connections wait until `service` is set."""

    def __init__(self, path: str, service: Any):
        self.path = path
        self.service = service
        self._kind, target = parse_address(path)
        if self._kind == "tcp":
            require_auth_token(path)
        self._auth = os.environ.get(AUTH_TOKEN_ENV)
        if self._kind == "uds" and os.path.exists(path):
            os.unlink(path)
        server_self = self

        class Handler(socketserver.BaseRequestHandler):
            def setup(self):
                if server_self._kind == "tcp":  # a request/reply protocol must not Nagle
                    self.request.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)

            def handle(self):
                sock = self.request
                while server_self.service is None:
                    time.sleep(0.005)
                if server_self._kind == "tcp":
                    try:
                        first = _recv_msg(sock)
                    except (ConnectionError, OSError):
                        return
                    if not (first.startswith(_AUTH_PREFIX) and hmac.compare_digest(
                            first[len(_AUTH_PREFIX):], server_self._auth.encode())):
                        return  # not the shared secret: dropped unanswered
                # The per-method count and latency hook: only a service that
                # defines _observe_rpc pays for the timing (the GCS does; the
                # raylet's task path stays without it).
                observe = getattr(server_self.service, "_observe_rpc", None)
                while True:
                    try:
                        raw = _recv_msg(sock)
                    except (ConnectionError, OSError):
                        return
                    req_id, method, args, kwargs = pickle.loads(raw)
                    t0 = time.perf_counter() if observe else 0.0
                    if req_id is None:
                        try:
                            getattr(server_self.service, method)(*args, **kwargs)
                        # lint: swallow-ok(one-way submit; errors surface as stored error objects)
                        except BaseException:
                            pass
                        if observe:
                            observe(method, (time.perf_counter() - t0) * 1e3)
                        continue
                    try:
                        result = getattr(server_self.service, method)(*args, **kwargs)
                        reply = pickle.dumps((req_id, True, result))
                    except BaseException as e:  # noqa: BLE001 - the caller re-raises it
                        try:
                            reply = pickle.dumps((req_id, False, e))
                        except Exception:
                            reply = pickle.dumps((req_id, False, RuntimeError(repr(e))))
                    if observe:
                        observe(method, (time.perf_counter() - t0) * 1e3)
                    try:
                        _send_msg(sock, reply)
                    except (ConnectionError, OSError):
                        return

        if self._kind == "tcp":
            class Server(socketserver.ThreadingTCPServer):
                daemon_threads = True
                allow_reuse_address = True

            self._server = Server(target, Handler)
            port = self._server.server_address[1]
            host = target[0] if target[0] not in ("", "0.0.0.0", "::") else "127.0.0.1"
            self.address = f"tcp://{host}:{port}"
        else:
            class Server(socketserver.ThreadingUnixStreamServer):  # type: ignore[no-redef]
                daemon_threads = True
                allow_reuse_address = True

            self._server = Server(target, Handler)
            self.address = path
        self._thread = threading.Thread(
            target=self._server.serve_forever, name=f"rpc-{os.path.basename(path)}", daemon=True
        )
        self._thread.start()

    def shutdown(self):
        self._server.shutdown()
        self._server.server_close()
        if self._kind == "uds":
            try:
                os.unlink(self.path)
            except OSError:
                pass


class RpcClient:
    """Client with per-thread connections, so a thread blocked in a
    long-running call (e.g. a driver's `get`) never starves other threads'
    requests. Retries connect (the daemon may still be booting): the
    analogue of the reference's retryable gRPC client
    (src/ray/rpc/retryable_grpc_client.h)."""

    # Reconnect backoff: a flat fast phase (a booting daemon usually listens
    # within a second), then doubling with full jitter to a bounded cap.
    _BACKOFF_BASE_S = 0.02
    _BACKOFF_CAP_S = 1.0
    _FAST_ATTEMPTS = 50

    def __init__(self, path: str, connect_timeout: float = 20.0):
        self.path = path
        self._connect_timeout = connect_timeout
        self._tls = threading.local()
        self._all: list = []
        self._all_lock = threading.Lock()
        self._rng = random.Random()
        self._get_sock()  # fail fast if the server is absent at construction

    def _new_sock(self, timeout: float) -> socket.socket:
        """Connects with backoff until `timeout`, then raises
        RpcUnavailableError (a ConnectionError)."""
        kind, target = parse_address(self.path)
        start = time.monotonic()
        deadline = start + timeout
        last_err: Optional[Exception] = None
        attempt = 0
        while True:
            if _net_chaos_armed():
                # net.connect: a partition (or a `drop` rule) makes this
                # attempt vanish on the wire, so the loop uses up the
                # caller's own deadline; `raise` fails the connect at once.
                blocked = _netpart.blocked_addr(self.path)
                rule = None if blocked else _chaos_inject("net.connect", self.path)
                if rule is not None and rule.action == "raise":
                    raise RpcUnavailableError(self.path, time.monotonic() - start, attempt,
                                              ConnectionError("chaos: injected connect failure"))
                if blocked is not None or rule is not None:
                    if blocked is not None:
                        _netpart.note_drop(self.path, "connect")
                    last_err = ConnectionError("chaos: connect black-holed by "
                                               + ("partition" if blocked else "net.connect rule"))
                    attempt += 1
                    now = time.monotonic()
                    if now >= deadline:
                        raise RpcUnavailableError(self.path, now - start, attempt, last_err)
                    time.sleep(min(self._BACKOFF_BASE_S, deadline - now))
                    continue
            s = None
            try:
                if kind == "tcp":
                    s = socket.create_connection(target, timeout=10.0)
                    s.settimeout(None)
                    s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                    _send_msg(s, _AUTH_PREFIX + os.environ.get(AUTH_TOKEN_ENV, "").encode())
                else:
                    s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
                    s.connect(target)
                with self._all_lock:
                    self._all.append(s)
                return s
            except OSError as e:
                if s is not None:
                    s.close()
                last_err = e
                attempt += 1
            now = time.monotonic()
            if now >= deadline:
                raise RpcUnavailableError(self.path, now - start, attempt, last_err)
            if attempt <= self._FAST_ATTEMPTS:
                sleep = self._BACKOFF_BASE_S
            else:
                cap = min(self._BACKOFF_CAP_S,
                          self._BACKOFF_BASE_S * (2 ** min(attempt - self._FAST_ATTEMPTS, 16)))
                sleep = max(0.001, self._rng.uniform(0, cap))
            time.sleep(min(sleep, deadline - now))

    def _get_sock(self) -> socket.socket:
        sock = getattr(self._tls, "sock", None)
        if sock is None:
            sock = self._new_sock(self._connect_timeout)
            self._tls.sock = sock
        return sock

    def _chaos_gate(self, method: str, oneway: bool) -> bool:
        """net.call (reached only when armed): True when a one-way message
        must vanish; a two-way call raises, since a black hole gives a
        request/reply protocol no reply, and every control-plane caller
        already handles the typed connection error as "peer gone"."""
        blocked = _netpart.blocked_addr(self.path)
        if blocked is not None:
            _netpart.note_drop(self.path, method)
            if oneway:
                return True
            raise RpcUnavailableError(self.path, 0.0, 0, ConnectionError(
                f"chaos partition black-holed {method!r}"))
        rule = _chaos_inject("net.call", f"{self.path}|{method}")
        if rule is not None:
            if rule.action == "delay":
                time.sleep(rule.delay_s)
            elif rule.action == "drop":
                if oneway:
                    return True
                raise RpcUnavailableError(self.path, 0.0, 0, ConnectionError(
                    f"chaos net.call dropped {method!r}"))
            else:  # raise
                raise RpcUnavailableError(self.path, 0.0, 0, ConnectionError(
                    f"chaos net.call failed {method!r}"))
        return False

    def call(self, method: str, *args, timeout: Optional[float] = None, **kwargs) -> Any:
        if _net_chaos_armed():
            self._chaos_gate(method, oneway=False)
        req_id = uuid.uuid4().hex
        payload = pickle.dumps((req_id, method, args, kwargs))
        sock = self._get_sock()
        sock.settimeout(timeout)
        try:
            _send_msg(sock, payload)
            raw = _recv_msg(sock)
        except (ConnectionError, OSError):
            # One reconnect attempt (daemon restarted), with the caller's
            # timeout re-applied to the fresh socket.
            sock.close()
            sock = self._new_sock(5.0)
            self._tls.sock = sock
            sock.settimeout(timeout)
            _send_msg(sock, payload)
            raw = _recv_msg(sock)
        rid, ok, result = pickle.loads(raw)
        if rid != req_id:
            raise RuntimeError("rpc correlation mismatch")
        if not ok:
            raise result
        return result

    def notify(self, method: str, *args, **kwargs) -> None:
        """One-way call: no reply, no round-trip wait."""
        if _net_chaos_armed() and self._chaos_gate(method, oneway=True):
            return  # black-holed: a one-way send just vanishes
        payload = pickle.dumps((None, method, args, kwargs))
        sock = self._get_sock()
        sock.settimeout(None)
        try:
            _send_msg(sock, payload)
        except (ConnectionError, OSError):
            sock.close()
            sock = self._new_sock(5.0)
            self._tls.sock = sock
            _send_msg(sock, payload)

    def close(self):
        with self._all_lock:
            for s in self._all:
                try:
                    s.close()
                except OSError:
                    pass
            self._all = []
        self._tls = threading.local()
