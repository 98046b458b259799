"""Out-of-band collective groups between actor processes (the port of
ray_tpu/collective.py).

Re-design of `ray.util.collective` (reference:
python/ray/util/collective/collective.py:40 GroupManager, :120
init_collective_group, :258 allreduce, :373 broadcast; NCCL backend
collective_group/nccl_collective_group.py:128, Gloo backend
gloo_collective_group.py:184). In-program collectives run over
torch.distributed (parallel/collectives.py, the fast path inside one
program); THIS module is the out-of-band path between distinct gangs, e.g.
an RL learner gang pushing weights to serve replicas.

Mechanism: host-level ring over TCP sockets. Each member binds a
listener, registers `rank -> addr` in the GCS KV (the rendezvous the
reference does through a named store actor), connects to its ring
neighbor, and runs textbook ring collectives on numpy buffers (ring
allreduce = reduce-scatter + allgather).

Inputs and outputs. An op takes a numpy array or a torch tensor, on the
CPU or on a CUDA device, and returns numpy, as the JAX package's returns
numpy for a jax array: a CUDA tensor is staged to host memory, and moving
the result back onto a device is the caller's choice. numpy has no
bfloat16, so a bf16 tensor is handled by one rule: broadcast, allgather and
send/recv carry its int16 view (the bits, unchanged) and the result comes
back as the float32 array of those bits' values; allreduce and
reduce_scatter widen it to float32 (exact) and reduce in float32. Either
way a bf16 input gives a float32 result. There is no NCCL backend, as the
JAX package has none.

All members must call each collective in the same order, the standard
process-group contract. A terminal timeout (of the rendezvous, or of a ring
op whose peer stalled) is flight-recorded and published as a `coll.timeout`
trigger naming the group, this rank and the missing ranks: the GCS opens an
incident and harvests every process's ring (observability/postmortem.py).
"""

from __future__ import annotations

import os
import pickle
import socket
import struct
import sys
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np

from . import tracing as _tracing
from .chaos.controller import maybe_inject as _chaos_inject
from .exceptions import CollectiveTimeoutError
from .observability.flight_recorder import record as _flight_record
from .observability.postmortem import publish_trigger

_LEN = struct.Struct("<Q")
_KV_PREFIX = "__collective__/"


def _rendezvous_timeout() -> float:
    """Group-establishment deadline (env-tunable: chaos tests shrink it
    so a missing member surfaces in seconds, not the 60 s default)."""
    try:
        return float(os.environ.get("RAY_TPU_COLLECTIVE_TIMEOUT_S", "") or 60.0)
    except ValueError:
        return 60.0


def _op_timeout() -> float:
    """Mid-op deadline for ring sends/recvs. Deliberately MUCH larger
    than the rendezvous deadline: a rank blocked in recv is usually
    waiting for a healthy straggler to ENTER the op (long compile,
    checkpoint write), and killing the gang at rendezvous speed would
    turn every slow step into a spurious CollectiveTimeoutError."""
    try:
        explicit = float(
            os.environ.get("RAY_TPU_COLLECTIVE_OP_TIMEOUT_S", "") or 0.0
        )
    except ValueError:
        explicit = 0.0
    return explicit if explicit > 0 else max(5.0 * _rendezvous_timeout(), 300.0)


def _send_msg(sock: socket.socket, payload: bytes) -> None:
    sock.sendall(_LEN.pack(len(payload)) + payload)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    chunks = []
    got = 0
    while got < n:
        c = sock.recv(min(n - got, 1 << 20))
        if not c:
            raise ConnectionError("collective peer closed")
        chunks.append(c)
        got += len(c)
    return b"".join(chunks)


def _recv_msg(sock: socket.socket) -> bytes:
    (n,) = _LEN.unpack(_recv_exact(sock, _LEN.size))
    return _recv_exact(sock, n)


def _gcs():
    from .core.runtime_base import current_runtime

    rt = current_runtime()
    gcs = getattr(rt, "_gcs", None)
    if gcs is None:
        raise RuntimeError(
            "collective groups need the cluster runtime (GCS rendezvous); "
            "local_mode has no separate processes to group"
        )
    return gcs


_OPS = {
    "sum": np.add,
    "prod": np.multiply,
    "max": np.maximum,
    "min": np.minimum,
}


class _Group:
    """One process's membership in one collective group."""

    def __init__(self, world_size: int, rank: int, name: str):
        if not (0 <= rank < world_size):
            raise ValueError(f"rank {rank} outside world of {world_size}")
        self.world_size = world_size
        self.rank = rank
        self.name = name
        self._gcs = _gcs()
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind(("0.0.0.0", 0))
        self._srv.listen(world_size)
        port = self._srv.getsockname()[1]
        host = os.environ.get("RAY_TPU_NODE_IP") or "127.0.0.1"
        # Remember exactly what we registered: destroy() only deletes the
        # key while it still holds OUR address, so tearing down a stale
        # group can never erase a successor's fresh registration (the
        # re-init-same-name deadlock).
        self._addr_str = f"{host}:{port}"
        self._gcs.call(
            "kv_put", f"{_KV_PREFIX}{name}/{rank}", self._addr_str.encode()
        )
        self._next: Optional[socket.socket] = None  # to (rank+1) % ws
        self._prev: Optional[socket.socket] = None  # from (rank-1) % ws
        self._lock = threading.Lock()
        if world_size > 1:
            rule = _chaos_inject("coll.rendezvous", f"{name}:{rank}")
            if rule is not None and rule.action == "raise":
                self._fail_rendezvous("chaos: injected rendezvous failure")
            _flight_record("coll.rendezvous", (name, rank, world_size))
            self._establish_ring()
            _flight_record("coll.ring_up", (name, rank))

    def _missing_ranks(self) -> List[int]:
        """Ranks with no live KV registration — the members a stuck
        rendezvous is actually waiting on."""
        out: List[int] = []
        for r in range(self.world_size):
            try:
                if not self._gcs.call("kv_get", f"{_KV_PREFIX}{self.name}/{r}"):
                    out.append(r)
            except Exception:  # noqa: BLE001 - GCS unreachable: report what we know
                return out
        return out

    def _fail_rendezvous(
        self,
        detail: str,
        missing: Optional[List[int]] = None,
        record: bool = True,
    ):
        # `record=False` for intra-retry probes: a 5 s lookup miss that
        # the establish loop immediately retries is not a timeout, and
        # stamping it would fill post-mortem dumps with coll.timeout
        # records for rings that came up fine. Only terminal deadline
        # paths record.
        if missing is None:
            missing = self._missing_ranks()
        if record:
            _flight_record("coll.timeout", (self.name, self.rank, tuple(missing)))
            publish_trigger("coll.timeout",
                            {"group": self.name, "rank": self.rank, "missing": list(missing)},
                            source="collective")
        raise CollectiveTimeoutError(
            self.name, self.rank, self.world_size, missing=missing, detail=detail
        )

    def _lookup(
        self, rank: int, timeout: Optional[float] = None, record: bool = True
    ) -> tuple:
        if timeout is None:
            timeout = _rendezvous_timeout()
        deadline = time.monotonic() + timeout
        key = f"{_KV_PREFIX}{self.name}/{rank}"
        while time.monotonic() < deadline:
            raw = self._gcs.call("kv_get", key)
            if raw:
                host, _, port = raw.decode().rpartition(":")
                return host, int(port)
            time.sleep(0.05)
        self._fail_rendezvous(
            f"rank {rank} never registered within {timeout}s",
            missing=[rank],
            record=record,
        )

    def _establish_ring(self) -> None:
        """Connects to next, accepts from prev (order-free via a thread)."""
        accepted: Dict[str, Any] = {}
        rdv_timeout = _rendezvous_timeout()

        def do_accept():
            # Loop until the true prev rank completes a handshake: a
            # connector that timed out waiting for our ack (we were slow to
            # start accepting) abandons its connection, and that dead
            # socket sits in OUR backlog ahead of its retry — a single
            # accept() would return it, hit EOF, and fail the whole
            # rendezvous while the peer is still retrying.
            prev_rank = (self.rank - 1) % self.world_size
            accept_deadline = time.monotonic() + rdv_timeout
            self._srv.settimeout(1.0)  # poll so the loop honors the deadline
            while time.monotonic() < accept_deadline:
                try:
                    conn, _ = self._srv.accept()
                except socket.timeout:
                    continue
                except Exception as e:  # noqa: BLE001 - reported after the join
                    accepted["err"] = e
                    return
                try:
                    conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                    # A stalled/half-open connection must not wedge the
                    # drain loop past the deadline: accepted sockets do NOT
                    # inherit the listener timeout.
                    conn.settimeout(
                        max(0.1, min(5.0, accept_deadline - time.monotonic()))
                    )
                    # Peer announces its rank; the ring only expects prev.
                    hello = pickle.loads(_recv_msg(conn))
                    accepted["rank"] = hello
                    if hello != prev_rank:
                        conn.close()  # wrong peer: refuse (no ack), keep accepting
                        continue
                    # 3-way handshake. Ack the hello: a connector is only
                    # DONE once its acceptor answered — a connect that
                    # landed in a stale listener's TCP backlog (same-name
                    # re-init) "succeeds" at the TCP level, so without the
                    # ack the connector stops retrying and this side's
                    # accept starves (the reinit flake). Then REQUIRE the
                    # connector's ring-go: an ABANDONED backlog conn can
                    # still serve a readable hello (data queued before FIN)
                    # and swallow the ack without error — only a peer that
                    # actually read the ack sends ring-go, so a dead conn
                    # times out/EOFs here and the drain continues to the
                    # live retry.
                    _send_msg(conn, pickle.dumps(("ring-ack", self.rank)))
                    go = pickle.loads(_recv_msg(conn))
                    if go != ("ring-go", prev_rank):
                        conn.close()
                        continue
                    conn.settimeout(None)
                    accepted["conn"] = conn
                    return
                except Exception:  # noqa: BLE001 - a dead backlog connection
                    # Dead/abandoned backlog connection: drop it, keep
                    # accepting — the live peer is still retrying.
                    try:
                        conn.close()
                    except OSError:
                        pass
            accepted["err"] = socket.timeout("ring accept deadline")

        t = threading.Thread(target=do_accept, daemon=True)
        t.start()
        next_rank = (self.rank + 1) % self.world_size
        deadline = time.monotonic() + rdv_timeout
        last = None
        addr = None
        s = None
        while time.monotonic() < deadline:
            # Re-resolve the neighbor EVERY retry: after an actor restart
            # the KV may briefly hold the dead incarnation's address, and
            # retrying a frozen stale addr for the whole deadline is the
            # classic stale-rank deadlock. The fresh registration
            # overwrites the key; the next lookup picks it up.
            try:
                addr = self._lookup(
                    next_rank, timeout=min(5.0, rdv_timeout), record=False
                )
            except TimeoutError as e:
                last = e
                continue
            try:
                s = socket.create_connection(addr, timeout=2.0)
                s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                s.settimeout(5.0)
                _send_msg(s, pickle.dumps(self.rank))
                # Wait for the acceptor's ack (see do_accept): dead-backlog
                # connects die here with EOF/RST/timeout and we re-resolve
                # instead of silently wedging the ring.
                tag, peer = pickle.loads(_recv_msg(s))
                if tag == "ring-ack" and peer == next_rank:
                    # Final confirm: tells the acceptor this connection is
                    # live (it discards acked-but-unconfirmed dead conns).
                    _send_msg(s, pickle.dumps(("ring-go", self.rank)))
                    s.settimeout(None)
                    break
                raise OSError(f"bad ring ack from {addr}: {(tag, peer)!r}")
            except (OSError, EOFError, ConnectionError, socket.timeout) as e:
                last = e
                if s is not None:
                    try:
                        s.close()
                    except OSError:
                        pass
                    s = None
                time.sleep(0.1)
        else:
            self._fail_rendezvous(f"cannot reach next rank at {addr}: {last}")
        self._next = s
        t.join(timeout=rdv_timeout)
        err = accepted.get("err")
        if isinstance(err, (socket.timeout, TimeoutError)) and "rank" in accepted:
            # Somebody dialed but no handshake with the expected prev ever
            # completed: still a rendezvous timeout (typed, flight-recorded)
            # with the who-dialed detail appended.
            self._fail_rendezvous(
                f"prev rank {(self.rank - 1) % self.world_size} never completed "
                f"the ring handshake within {rdv_timeout}s "
                f"(last hello from rank {accepted.get('rank')})"
            )
        if isinstance(err, (socket.timeout, TimeoutError)) or (
            err is None and "rank" not in accepted
        ):
            # Nobody dialed our listener before the deadline: the prev
            # rank is missing/dead — name it instead of a bare timeout.
            self._fail_rendezvous(
                f"prev rank {(self.rank - 1) % self.world_size} never connected "
                f"within {rdv_timeout}s"
            )
        if err is not None:
            raise RuntimeError(f"ring accept failed: {err}")
        if accepted.get("conn") is None:
            raise RuntimeError(
                f"expected prev rank {(self.rank - 1) % self.world_size}, "
                f"got {accepted.get('rank')}"
            )
        self._prev = accepted["conn"]

    # ------------------------------------------------------------ primitives
    def _fail_op(self, what: str, peer: int) -> None:
        """A ring send/recv exceeded the op deadline: the peer is
        stalled, dead, or partitioned away mid-op. Surface the same
        typed, rank-naming error a failed rendezvous produces — a bare
        hang (the old behavior: blocking recv with no timeout) leaves a
        gang wedged with nothing to post-mortem."""
        _flight_record("coll.timeout", (self.name, self.rank, (peer,)))
        publish_trigger("coll.timeout", {"group": self.name, "rank": self.rank, "missing": [peer]},
                        source="collective")
        raise CollectiveTimeoutError(
            self.name,
            self.rank,
            self.world_size,
            missing=[peer],
            detail=(
                f"ring {what} involving rank {peer} timed out mid-op after "
                f"{_op_timeout():.0f}s (peer stalled, dead, or "
                "partitioned)"
            ),
        )

    def _send_next(self, obj: Any) -> None:
        # Deadline on the send half too: a one-way partition (we can
        # receive, the peer can't drain) eventually fills the socket
        # buffer and blocks sendall forever.
        self._next.settimeout(_op_timeout())
        try:
            _send_msg(self._next, pickle.dumps(obj, protocol=5))
        except socket.timeout:
            self._fail_op("send", (self.rank + 1) % self.world_size)

    def _recv_prev(self) -> Any:
        self._prev.settimeout(_op_timeout())
        try:
            return pickle.loads(_recv_msg(self._prev))
        except socket.timeout:
            self._fail_op("recv", (self.rank - 1) % self.world_size)

    def _exchange(self, obj: Any) -> Any:
        """Send to next + recv from prev concurrently (large payloads would
        deadlock two blocking sendalls around the ring)."""
        err: List[BaseException] = []

        def sender():
            try:
                self._send_next(obj)
            except BaseException as e:  # noqa: BLE001 - re-raised in the caller
                err.append(e)

        t = threading.Thread(target=sender, daemon=True)
        t.start()
        got = self._recv_prev()
        t.join()
        if err:
            raise err[0]
        return got

    # ------------------------------------------------------------ collectives
    def barrier(self) -> None:
        """Two token laps: lap 1 proves everyone arrived, lap 2 releases."""
        if self.world_size == 1:
            return
        with self._lock:
            for _ in range(2):
                self._exchange(("b", self.name))

    def broadcast(self, arr: Any, src_rank: int = 0) -> Any:
        """`arr` (a payload: a numpy array or _BF16Bits) from src_rank to
        every member, around the ring."""
        if self.world_size == 1:
            return arr
        with self._lock:
            if self.rank == src_rank:
                self._send_next(arr)
                # Absorb the lap-completion token from prev.
                self._recv_prev()
                return arr
            val = self._recv_prev()
            self._send_next(val)  # forward (src absorbs its own lap)
            return val

    def allreduce(self, arr: np.ndarray, op: str = "sum") -> np.ndarray:
        """Ring allreduce: reduce-scatter then allgather, ws-1 steps each,
        2*(ws-1)/ws of the buffer over the wire per member."""
        arr = np.ascontiguousarray(arr)
        ws = self.world_size
        if ws == 1:
            return arr
        reduce_fn = _OPS[op]
        with self._lock:
            flat = arr.reshape(-1).copy()
            chunks = np.array_split(flat, ws)
            # reduce-scatter
            for step in range(ws - 1):
                send_idx = (self.rank - step) % ws
                recv_idx = (self.rank - step - 1) % ws
                got = self._exchange(chunks[send_idx])
                chunks[recv_idx] = reduce_fn(chunks[recv_idx], got)
            # allgather
            for step in range(ws - 1):
                send_idx = (self.rank + 1 - step) % ws
                recv_idx = (self.rank - step) % ws
                chunks[recv_idx] = self._exchange(chunks[send_idx])
            return np.concatenate(chunks).reshape(arr.shape).astype(arr.dtype, copy=False)

    def allgather(self, arr: Any) -> List[Any]:
        ws = self.world_size
        if ws == 1:
            return [arr]
        with self._lock:
            out: List[Optional[np.ndarray]] = [None] * ws
            out[self.rank] = arr
            cur = arr
            for step in range(ws - 1):
                cur = self._exchange(cur)
                out[(self.rank - step - 1) % ws] = cur
            return out  # type: ignore[return-value]

    def reduce_scatter(self, arr: np.ndarray, op: str = "sum") -> np.ndarray:
        """Each member gets one fully-reduced 1/ws slice (flat split)."""
        arr = np.ascontiguousarray(arr)
        ws = self.world_size
        if ws == 1:
            return arr
        reduce_fn = _OPS[op]
        with self._lock:
            chunks = np.array_split(arr.reshape(-1).copy(), ws)
            for step in range(ws - 1):
                send_idx = (self.rank - step) % ws
                recv_idx = (self.rank - step - 1) % ws
                got = self._exchange(chunks[send_idx])
                chunks[recv_idx] = reduce_fn(chunks[recv_idx], got)
            return chunks[(self.rank + 1) % ws]

    def send(self, arr: Any, dst_rank: int) -> None:
        """P2P via ring forwarding (small gangs; a direct mesh is overkill
        for the control-ish traffic this plane carries)."""
        with self._lock:
            self._send_next(("p2p", dst_rank, arr))

    def recv(self, src_rank: int) -> Any:
        with self._lock:
            while True:
                kind, dst, payload = self._recv_prev()
                if dst == self.rank:
                    return payload
                self._send_next((kind, dst, payload))  # forward along the ring

    def destroy(self) -> None:
        """Closes member sockets and deregisters this rank from the GCS
        rendezvous. Guarded delete: a successor group under the same
        (name, rank) may already have registered — deleting ITS key would
        strand its peers' lookups (the re-init deadlock this fixes)."""
        _flight_record("coll.destroy", (self.name, self.rank))
        key = f"{_KV_PREFIX}{self.name}/{self.rank}"
        try:
            cur = self._gcs.call("kv_get", key)
            if cur is not None and cur.decode() == getattr(self, "_addr_str", None):
                self._gcs.call("kv_del", key)
        except Exception:  # lint: swallow-ok(guarded key delete; GCS down means keys die with it)
            pass
        for s in (self._next, self._prev, self._srv):
            if s is not None:
                # shutdown() first: close() alone does not reliably wake a
                # thread blocked in recv() on the same socket.
                try:
                    s.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                try:
                    s.close()
                except OSError:
                    pass


# ------------------------------------------------------------------- module API

_GROUPS: Dict[str, _Group] = {}
_GROUPS_LOCK = threading.Lock()


def init_collective_group(
    world_size: int, rank: int, group_name: str = "default", backend: str = "dcn"
) -> None:
    """Joins this process to a named group; call from inside each member
    actor/task (reference: util/collective/collective.py:120)."""
    if backend != "dcn":
        raise ValueError(f"unknown backend {backend!r}; the one backend is 'dcn' (a TCP ring)")
    # Tear down any previous membership BEFORE registering the new one:
    # destroying the old group after the new _Group has kv_put its address
    # used to delete the fresh key (same name/rank), leaving peers polling
    # a registration that no longer exists — deadlock on re-init.
    with _GROUPS_LOCK:
        old = _GROUPS.pop(group_name, None)
    if old is not None:
        old.destroy()
    g = _Group(world_size, rank, group_name)
    with _GROUPS_LOCK:
        _GROUPS[group_name] = g


def _group(name: str) -> _Group:
    with _GROUPS_LOCK:
        g = _GROUPS.get(name)
    if g is None:
        raise RuntimeError(
            f"collective group {name!r} not initialized in this process; "
            "call init_collective_group first"
        )
    return g


def _op_span(kind: str, group: "_Group", **attrs):
    """Span + flight-record bracket around one collective op. The flight
    record is unconditional (a hang dump's last `coll.op` names the op
    and group a gang member was stuck in); the span is tracing-gated and
    carries rank/world for the timeline."""
    rule = _chaos_inject("coll.op", f"{kind}:{group.name}:{group.rank}")
    if rule is not None:
        if rule.action == "delay":
            time.sleep(rule.delay_s)
        elif rule.action == "raise":
            # Surface as the same failure class a dead ring member
            # produces, so callers exercise their real recovery path.
            raise ConnectionError(
                f"chaos: injected collective fault in {kind} on group "
                f"{group.name!r} rank {group.rank}"
            )
    _flight_record("coll.op", (kind, group.name, group.rank))
    return _tracing.maybe_span(
        f"collective.{kind}",
        {
            "group": group.name,
            "rank": group.rank,
            "world_size": group.world_size,
            **attrs,
        },
    )


class _BF16Bits:
    """A bf16 tensor on the wire: its int16 view (numpy has no bfloat16)."""

    __slots__ = ("bits",)

    def __init__(self, bits: np.ndarray):
        self.bits = bits

    def __reduce__(self):
        return (_BF16Bits, (self.bits,))

    def to_float32(self) -> np.ndarray:
        wide = self.bits.view(np.uint16).astype(np.uint32) << 16
        return wide.view(np.float32)


def _to_host(arr, reducing: bool = False):
    """A numpy payload for the wire: numpy as is; a torch tensor staged to
    host memory, a bf16 one as _BF16Bits (or float32 when `reducing`)."""
    torch = sys.modules.get("torch")
    if torch is not None and isinstance(arr, torch.Tensor):
        t = arr.detach()
        if t.device.type != "cpu":
            t = t.cpu()
        if t.dtype == torch.bfloat16:
            if reducing:
                return t.float().contiguous().numpy()
            return _BF16Bits(t.contiguous().view(torch.int16).numpy())
        return t.contiguous().numpy()
    return np.ascontiguousarray(arr)


def _from_wire(payload):
    return payload.to_float32() if isinstance(payload, _BF16Bits) else payload


def allreduce(arr, group_name: str = "default", op: str = "sum"):
    g = _group(group_name)
    with _op_span("allreduce", g, op=op):
        return g.allreduce(_to_host(arr, reducing=True), op)


def broadcast(arr, src_rank: int = 0, group_name: str = "default"):
    g = _group(group_name)
    with _op_span("broadcast", g, src_rank=src_rank):
        payload = _to_host(arr) if g.rank == src_rank else None
        return _from_wire(g.broadcast(payload, src_rank))


def allgather(arr, group_name: str = "default"):
    g = _group(group_name)
    with _op_span("allgather", g):
        return [_from_wire(p) for p in g.allgather(_to_host(arr))]


def reduce_scatter(arr, group_name: str = "default", op: str = "sum"):
    g = _group(group_name)
    with _op_span("reduce_scatter", g, op=op):
        return g.reduce_scatter(_to_host(arr, reducing=True), op)


def barrier(group_name: str = "default") -> None:
    g = _group(group_name)
    with _op_span("barrier", g):
        g.barrier()


def send(arr, dst_rank: int, group_name: str = "default") -> None:
    g = _group(group_name)
    with _op_span("send", g, dst_rank=dst_rank):
        g.send(_to_host(arr), dst_rank)


def recv(src_rank: int, group_name: str = "default"):
    g = _group(group_name)
    with _op_span("recv", g, src_rank=src_rank):
        return _from_wire(g.recv(src_rank))


def destroy_collective_group(group_name: str = "default") -> None:
    with _GROUPS_LOCK:
        g = _GROUPS.pop(group_name, None)
    if g is not None:
        g.destroy()


def _clear_stale_registrations(group_name: str) -> None:
    """Deletes leftover rank->addr keys for a group (members that died
    without destroy); fresh members re-register, and the per-retry
    re-lookup in _establish_ring tolerates the brief gap."""
    from .core.runtime_base import maybe_runtime

    gcs = getattr(maybe_runtime(), "_gcs", None)
    if gcs is None:
        return
    try:
        for key in gcs.call("kv_keys", f"{_KV_PREFIX}{group_name}/"):
            gcs.call("kv_del", key)
    except Exception:  # lint: swallow-ok(best-effort sweep; rendezvous guards against stale keys)
        pass


def create_collective_group(actors, group_name: str = "default") -> None:
    """Driver-side convenience: initializes the group on a list of actor
    handles, rank = list position (reference: collective.py:40
    create_collective_group declarative path). Clears stale GCS
    registrations first so a group re-created after member crashes
    cannot rendezvous against dead addresses."""
    from . import api

    _clear_stale_registrations(group_name)
    ws = len(actors)
    refs = [
        a._invoke("__ray_tpu_collective_init__", (ws, i, group_name), {}, 1)
        for i, a in enumerate(actors)
    ]
    api.get(refs, timeout=120)


def destroy_collective_group_on(actors, group_name: str = "default") -> None:
    """Driver-side teardown pair of create_collective_group: drops the
    membership inside every member actor and deregisters their ranks."""
    from . import api

    refs = []
    for a in actors:
        try:
            refs.append(a._invoke("__ray_tpu_collective_destroy__", (group_name,), {}, 1))
        except Exception:  # lint: swallow-ok(dead member; destroy the rest)
            # A dead member raises at submit time; its membership died
            # with its worker.
            pass
    try:
        api.get(refs, timeout=60)
    except Exception:  # lint: swallow-ok(members may already be dead; keys are guard-deleted)
        pass
    # No blanket key sweep here: each member's destroy() deletes its own
    # key only while it still holds that member's address, so a same-name
    # group being re-created concurrently keeps its fresh registrations
    # (create_collective_group sweeps stale keys on the CREATE side,
    # where the new owner's intent is unambiguous).
