"""Owner-side leased-worker fast path: direct owner->worker task push (copy
of ray_tpu/core/fastpath.py for the PyTorch port).

Re-design of the reference's direct task submission (reference:
src/ray/core_worker/transport/normal_task_submitter.cc:354 — lease
request — and :555 — direct PushTask RPC to the leased worker — plus
actor_task_submitter.h:75 for the actor direction). The owner asks its
raylet for a worker lease ONCE, then pushes task payloads straight to
the worker's direct socket with unbounded pipelining; the raylet is only
involved in lease grant/return, so the per-task hot path is two socket
writes and two pickles — no daemon in the middle.

Completion rides the object plane (results land in the node's shared
memory store, where the owner's `get` finds them) plus a tiny in-band
`("d", task_id, ok, sealed)` ack used for in-flight accounting and
failure handling: a broken socket fails or resubmits everything
outstanding on that worker (reference: task_manager.h retry on worker
death).

Actor calls route through an ordered per-actor channel: every call is
buffered until the actor's direct socket is known, then ALL calls flow
over that one socket — mixing the raylet path and the direct path would
break per-caller ordering (reference: actor_task_submitter's ordered
send queue)."""

from __future__ import annotations

import os
import pickle
import socket
import threading
import time
from typing import Callable, Dict, List, Optional

from .. import exceptions as exc
from ..utils import internal_metrics as imet
from .rpc import _recv_msg, _send_msg, parse_address

# Tunables (modest defaults; the fast path must not starve the node).
# Lease count is capped by host parallelism: on a small host extra leased
# workers only add context switches — the owner thread is the bottleneck
# for cheap tasks (measured: 1-core box peaks at ONE lease).
MAX_LEASES = max(1, min(8, (os.cpu_count() or 1) // 2))
SCALE_BACKLOG = 64  # extra lease when in-flight exceeds this per conn
LEASE_COOLDOWN_S = 0.5


def _connect_uds(path: str, timeout: float = 15.0) -> socket.socket:
    deadline = time.monotonic() + timeout
    last: Optional[Exception] = None
    while time.monotonic() < deadline:
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        try:
            s.connect(path)
            return s
        except OSError as e:
            last = e
            s.close()
            time.sleep(0.05)
    raise ConnectionError(f"cannot connect to worker direct socket {path}: {last}")


class DirectConn:
    """One pipelined socket to a worker's direct server."""

    def __init__(
        self,
        sock_path: str,
        worker_id: str,
        on_dead: Callable[[List[dict]], None],
        connect_timeout: float = 15.0,
        on_sealed: Optional[Callable[[List[str]], None]] = None,
        lessor=None,
        lease_token: Optional[str] = None,
    ):
        self.worker_id = worker_id
        self.sock_path = sock_path
        # The raylet that granted this lease + the grant token: an owner
        # close tells the lessor directly (token-guarded) instead of
        # relying on the worker observing EOF — a wedged worker must not
        # pin the node's CPUs forever.
        self.lessor = lessor
        self.lease_token = lease_token
        self._sock = _connect_uds(sock_path, connect_timeout)
        self._wlock = threading.Lock()
        self._iflock = threading.Lock()
        self.inflight: Dict[str, dict] = {}
        self.sent_hashes: set = set()
        self.alive = True
        self.draining = False  # raylet revoked the lease: no new pushes
        self.acked = 0
        self.last_used = time.monotonic()
        self._dead_lock = threading.Lock()
        self._on_dead = on_dead
        self._on_sealed = on_sealed
        threading.Thread(
            target=self._reader, daemon=True, name=f"fp-read-{worker_id[:6]}"
        ).start()

    def send(self, frame: tuple, entry: dict) -> None:
        """Pushes one task; registers it in-flight first so a crash between
        send and ack still fails/retries it."""
        blob = pickle.dumps(frame)
        tid = entry["task_id"]
        self.last_used = time.monotonic()
        entry["_send_ts"] = self.last_used  # the round trip's start
        with self._iflock:
            self.inflight[tid] = entry
        try:
            with self._wlock:
                _send_msg(self._sock, blob)
        except OSError:
            # This entry goes back to the caller (raise), the REST of the
            # in-flight set goes through the failure handler.
            with self._iflock:
                self.inflight.pop(tid, None)
            self._die()
            raise

    def depth(self) -> int:
        with self._iflock:
            return len(self.inflight)

    def close(self) -> None:
        """Owner-initiated close (janitor/shutdown): the worker sees EOF
        and returns its lease; nothing outstanding is failed. The lessor
        is ALSO told directly (token-guarded one-way) — EOF delivery has
        been observed to race multi-conn direct servers, and a lease whose
        return is lost pins the node's CPUs until the next placement
        starves (the elastic grow-back failure mode)."""
        with self._dead_lock:
            self.alive = False
        try:
            self._sock.close()
        except OSError:
            pass
        if self.lessor is not None and self.lease_token is not None:
            try:
                self.lessor.notify(
                    "return_worker_lease", self.worker_id, self.lease_token
                )
            except Exception:  # lint: swallow-ok(raylet gone; its successor holds no such lease)
                pass

    def _reader(self) -> None:
        while True:
            try:
                msg = pickle.loads(_recv_msg(self._sock))
            except Exception:
                break
            if msg[0] == "d":  # ("d", task_id, ok, sealed, inline_blobs)
                self.last_used = time.monotonic()
                self.acked += 1
                with self._iflock:
                    done_entry = self.inflight.pop(msg[1], None)
                    drained = self.draining and not self.inflight
                if done_entry is not None and "_send_ts" in done_entry:
                    imet.FASTPATH_RTT.observe((self.last_used - done_entry["_send_ts"]) * 1e3)
                if self._on_sealed is not None:
                    # Wake the owner's get() directly — the in-band ack
                    # beats the raylet's batched seal notification by ~ms.
                    self._on_sealed(msg[3], msg[4] if len(msg) > 4 else None)
                if drained:
                    break  # revoked lease fully drained: close it
            elif msg[0] == "si":  # stream item: ("si", sealed, inline)
                self.last_used = time.monotonic()
                if self._on_sealed is not None:
                    self._on_sealed(msg[1], msg[2])
            elif msg[0] == "r":
                # Lease revoked by the raylet (queued work needs the
                # resources): stop new pushes, close once drained.
                self.draining = True
                with self._iflock:
                    if not self.inflight:
                        break
        self._die()

    def _die(self) -> None:
        with self._dead_lock:
            if not self.alive:
                return  # owner-closed or already handled
            self.alive = False
        try:
            self._sock.close()
        except OSError:
            pass
        with self._iflock:
            pending, self.inflight = list(self.inflight.values()), {}
        if pending:
            try:
                self._on_dead(pending)
            except Exception:  # lint: swallow-ok(failure callback on a dying channel; callee logs)
                pass


def task_frame(entry: dict, conn: DirectConn) -> tuple:
    """Slim wire frame for a leased normal task; the function blob ships
    once per (connection, function) and is hash-cached worker-side."""
    fh = entry["func_hash"]
    blob = None if fh in conn.sent_hashes else entry["func_blob"]
    return (
        "t",
        entry["task_id"],
        fh,
        blob,
        entry["args_blob"],
        entry["return_ids"],
        entry.get("desc", ""),
        bool(entry.get("streaming")),
        entry.get("trace_ctx"),
    )


def actor_frame(entry: dict) -> tuple:
    return (
        "a",
        entry["task_id"],
        entry["actor_id"],
        entry["method_name"],
        entry["args_blob"],
        entry["return_ids"],
        entry.get("desc", ""),
        bool(entry.get("streaming")),
        entry.get("concurrency_group"),
        entry.get("trace_ctx"),
    )


from .ids import ObjectID as _ObjectID


def _eligible(entry: dict, store) -> bool:
    """A task may ride a shared lease lane only when it needs nothing the
    lane doesn't provide: default placement, default 1-CPU shape, no
    placement group, no runtime env, and deps already local (a lease lane
    is FIFO — one blocking pull would stall unrelated tasks behind it)."""
    if entry.get("pg_id") or entry.get("actor_id"):
        return False
    if (entry.get("strategy") or "DEFAULT") != "DEFAULT":
        return False
    if entry.get("runtime_env"):
        return False
    res = entry.get("resources") or {}
    if res and res != {"CPU": 1.0}:
        return False
    for dep in entry.get("deps", ()):
        if not store.contains(_ObjectID.from_hex(dep)):
            return False
    return True


class FastPath:
    """Manages task leases for one owner process (reference:
    normal_task_submitter.h worker_to_lease_entry_ caching)."""

    def __init__(self, runtime):
        self._rt = runtime
        self._lock = threading.Lock()
        self._conns: List[DirectConn] = []
        self._rr = 0
        self._rate_mark = None  # (acked_total, t) for drain-rate estimate
        self._scale_tick = 0
        self._requesting = False
        self._cooldown_until = 0.0
        self._closed = False
        # Direct sockets are UDS paths on the raylet's host: a driver whose
        # raylet is a tcp:// endpoint (a remote client) cannot reach them.
        # A test may set _disabled to force the raylet path.
        self._disabled = parse_address(runtime._raylet.path)[0] != "uds"
        if not self._disabled:
            threading.Thread(
                target=self._janitor, daemon=True, name="fp-janitor"
            ).start()

    def _janitor(self) -> None:
        """Returns idle leases: a burst of .remote() calls must not pin the
        node's CPUs forever (reference: the idle lease expiration in
        normal_task_submitter / worker_lease_policy)."""
        while not self._closed:
            time.sleep(1.0)
            now = time.monotonic()
            idle: List[DirectConn] = []
            with self._lock:
                keep = []
                for c in self._conns:
                    if (
                        c.alive
                        and c.depth() == 0
                        and now - c.last_used > 5.0
                    ):
                        idle.append(c)
                    else:
                        keep.append(c)
                self._conns = keep
            for c in idle:
                c.close()  # worker sees EOF and returns its lease

    # ------------------------------------------------------------- submit
    def try_submit(self, entry: dict) -> bool:
        if self._disabled or self._closed:
            return False
        if not _eligible(entry, self._rt._store):
            return False
        conn = self._pick_conn()
        if conn is None:
            return False
        frame = task_frame(entry, conn)
        self._rt._fast_register(entry)
        try:
            conn.send(frame, entry)
        except OSError:
            self._rt._fast_sealed(entry["return_ids"])  # unregister interest
            return False  # lease died mid-send: slow path takes this one
        conn.sent_hashes.add(entry["func_hash"])
        entry["_fast"] = conn.worker_id
        # Scale checks sum queue depths under the lock — amortize to every
        # 32nd submit (it's a heuristic; 31-task lag is noise next to
        # SCALE_BACKLOG) so the hot path is two socket writes + a pickle.
        self._scale_tick += 1
        if not (self._scale_tick & 31):
            self._maybe_scale()
        return True

    def _pick_conn(self) -> Optional[DirectConn]:
        # Hot path: round-robin over a snapshot without rebuilding the
        # list per task; prune dead/draining conns only when one is seen.
        # The cursor is read once and used modulo the SNAPSHOT length — a
        # concurrent submitter bumping self._rr against a longer list must
        # not index past this thread's snapshot.
        conns = self._conns
        n = len(conns)
        rr = self._rr + 1
        self._rr = rr  # benign race: approximate round-robin is fine
        for i in range(n):
            c = conns[(rr + i) % n]
            if c.alive and not c.draining:
                return c
        with self._lock:
            self._conns = [c for c in self._conns if c.alive and not c.draining]
            if self._conns:
                self._rr = 0
                return self._conns[0]
            self._spawn_acquire_locked()
            return None

    def _maybe_scale(self) -> None:
        with self._lock:
            n = len(self._conns)
            if n == 0 or n >= MAX_LEASES:
                return
            depth = sum(c.depth() for c in self._conns)
            if depth <= SCALE_BACKLOG * n:
                return
            # Backlog alone is not a reason to scale: cheap tasks backlog
            # because the OWNER outruns the ack loop, and another worker
            # only adds scheduling noise. Scale when the backlog would take
            # a while to drain at the measured completion rate.
            now = time.monotonic()
            acked = sum(c.acked for c in self._conns)
            if self._rate_mark is None or now - self._rate_mark[1] > 5.0:
                self._rate_mark = (acked, now)
                return
            d_acked = acked - self._rate_mark[0]
            dt = now - self._rate_mark[1]
            if dt < 0.2:
                return
            self._rate_mark = (acked, now)
            rate = d_acked / dt
            if rate <= 0 or depth / rate > 0.5:
                self._spawn_acquire_locked()

    def _spawn_acquire_locked(self) -> None:
        if self._requesting or time.monotonic() < self._cooldown_until:
            return
        self._requesting = True
        threading.Thread(target=self._acquire, daemon=True, name="fp-lease").start()

    # ------------------------------------------------------------- leases
    def _acquire(self) -> None:
        try:
            conn = self._request_from(self._rt._raylet)
            if conn is not None:
                with self._lock:
                    if self._closed:
                        conn.close()
                    else:
                        self._conns.append(conn)
            else:
                self._cooldown_until = time.monotonic() + LEASE_COOLDOWN_S
        except Exception:
            self._cooldown_until = time.monotonic() + LEASE_COOLDOWN_S
        finally:
            self._requesting = False

    def _request_from(self, raylet, hop: int = 0) -> Optional[DirectConn]:
        resp = raylet.call("request_worker_lease", {"CPU": 1.0}, "")
        granted = resp.get("granted")
        if granted:
            return DirectConn(
                granted["sock"],
                granted["worker_id"],
                self._on_lease_dead,
                on_sealed=self._rt._fast_sealed,
                lessor=raylet,
                lease_token=granted.get("token"),
            )
        spill = resp.get("spill")
        if spill and hop < 2 and parse_address(spill)[0] == "uds":
            return self._request_from(self._rt._raylet_for(spill), hop + 1)
        return None  # another host's raylet: its direct sockets are out of reach

    def _on_lease_dead(self, entries: List[dict]) -> None:
        self._rt._fastpath_failed(entries)

    def close(self) -> None:
        with self._lock:
            self._closed = True
            conns, self._conns = self._conns, []
        for c in conns:
            c.close()


class ActorChannel:
    """Ordered submission channel for ONE actor handle-owner pair.

    All calls flow through the channel from the first submit on: while the
    actor's direct socket is unknown (constructing, restarting) calls
    buffer in order; once known they stream directly; with the fast path
    disabled every call takes the raylet path. This keeps per-caller
    ordering single-laned (reference: actor_task_submitter.h send queue +
    out-of-band actor state subscription)."""

    def __init__(self, runtime, actor_hex: str):
        self._rt = runtime
        self.aid = actor_hex
        self._lock = threading.Lock()
        self._state = "CONNECTING"  # CONNECTING | DIRECT | SLOW | DEAD
        self._buffer: List[dict] = []
        self._conn: Optional[DirectConn] = None
        self._death_reason = ""
        if getattr(runtime._fastpath, "_disabled", True):
            self._state = "SLOW"
        else:
            self._start_connector_locked()

    def _start_connector_locked(self) -> None:
        threading.Thread(
            target=self._connect_loop, daemon=True, name=f"ach-{self.aid[:6]}"
        ).start()

    # ------------------------------------------------------------- submit
    def submit(self, entry: dict) -> None:
        with self._lock:
            st = self._state
            if st == "CONNECTING":
                # Register completion interest NOW, not at send time: a
                # get() racing the channel connect must take the ack-wakeup
                # wait, not commit to a multi-second raylet poll that can
                # never see an inline-only result (measured: this was a
                # flat 2 s on every create->first-call sequence).
                self._rt._fast_register(entry)
                self._buffer.append(entry)
                return
            if st == "DEAD":
                raise exc.ActorDiedError(self.aid, self._death_reason)
            conn = self._conn if st == "DIRECT" else None
        if conn is not None:
            self._rt._fast_register(entry)
            try:
                conn.send(actor_frame(entry), entry)
                return
            except OSError:
                self._rt._fast_sealed(entry["return_ids"])
                self._handle_conn_death()
                self.submit(entry)  # re-enters as CONNECTING (buffered)
                return
        self._rt._submit_actor_slow(entry)

    # --------------------------------------------------------- connection
    def _connect_loop(self) -> None:
        """Resolves the actor's direct socket, then drains the buffer over
        it IN ORDER before any new submit can race ahead."""
        # Known-location shortcut: the create reply already named the
        # hosting raylet, so the first resolution asks IT directly —
        # skipping the GCS get_actor round trip per channel (a launch
        # storm's first-call wave otherwise serializes on the GCS).
        # Any miss (no entry, not ALIVE there yet, moved) falls through
        # to the authoritative GCS loop below.
        known = self._rt._actor_location.get(self.aid)
        if known and parse_address(known)[0] == "uds":
            try:
                dsock = self._rt._raylet_for(known).call(
                    "actor_direct_sock", self.aid
                )
            except Exception:
                dsock = None
            if dsock and os.path.exists(dsock):
                if self._adopt_conn(dsock):
                    return
        while True:
            try:
                info = self._rt._gcs.call("get_actor", self.aid)
            except Exception:
                time.sleep(0.2)
                continue
            if info is None or info.get("state") == "DEAD":
                self._to_dead(
                    (info or {}).get("death_reason", "unknown or dead actor")
                )
                return
            sock = info.get("sock")
            if not sock:  # RESTARTING/PENDING without a node yet
                time.sleep(0.1)
                continue
            if parse_address(sock)[0] != "uds":
                self._to_slow()  # another host: every call goes through its raylet
                return
            if info.get("state") == "ALIVE":
                try:
                    dsock = self._rt._raylet_for(sock).call(
                        "actor_direct_sock", self.aid
                    )
                except Exception:
                    dsock = None
                if dsock and os.path.exists(dsock):
                    if self._adopt_conn(dsock):
                        return
                    time.sleep(0.1)
                    continue
            time.sleep(0.05)

    def _adopt_conn(self, dsock: str) -> bool:
        """Connects to a resolved direct socket and drains the buffer
        over it IN ORDER; True once the channel is DIRECT. False =
        connect refused or the worker died mid-drain (caller re-resolves
        fresh state and retries)."""
        try:
            # Short per-attempt timeout: right after a worker
            # death this dsock can be the DEAD incarnation's
            # still-on-disk socket (the GCS/raylet records go
            # stale for one monitor tick), and a long blind
            # connect burns the whole window refusing. The
            # caller re-resolves fresh state each pass, so a
            # legitimately slow boot just reconnects next
            # round (measured: actor restore 7 s -> 2.5 s).
            conn = DirectConn(
                dsock,
                f"actor-{self.aid[:8]}",
                self._on_conn_dead,
                connect_timeout=1.0,
                on_sealed=self._rt._fast_sealed,
            )
        except ConnectionError:
            return False
        with self._lock:
            buf, self._buffer = self._buffer, []
            failed_at = None
            for i, e in enumerate(buf):
                self._rt._fast_register(e)
                try:
                    conn.send(actor_frame(e), e)
                except OSError:
                    self._rt._fast_sealed(e["return_ids"])
                    failed_at = i
                    break
            if failed_at is None:
                self._conn = conn
                self._state = "DIRECT"
                return True
            # Worker died during the flush: conn._die() fails
            # what was sent; re-buffer the rest and retry.
            self._buffer = buf[failed_at:] + self._buffer
        return False

    def _to_slow(self) -> None:
        with self._lock:
            buf, self._buffer = self._buffer, []
            self._state = "SLOW"
        for e in buf:
            # These results arrive through the raylet: drop the fast-path
            # interest, or get() first waits out the ack wakeup.
            self._rt._fast_sealed(e["return_ids"])
            try:
                self._rt._submit_actor_slow(e)
            except Exception as err:  # noqa: BLE001 - stored for the caller's get
                self._rt._store_error_object(e, err)

    def _to_dead(self, reason: str) -> None:
        with self._lock:
            buf, self._buffer = self._buffer, []
            self._state = "DEAD"
            self._death_reason = reason
        err = exc.ActorDiedError(self.aid, reason)
        for e in buf:
            self._rt._store_error_object(e, err)
            self._rt._fast_sealed(e["return_ids"])

    def _on_conn_dead(self, entries: List[dict]) -> None:
        """Socket to the actor worker broke: fail what was in flight (the
        reference fails in-flight actor calls on death too) and go back to
        CONNECTING — a restartable actor comes back, otherwise the GCS
        reports DEAD and later submits raise."""
        self._rt._actor_fast_failed(self.aid, entries)
        self._handle_conn_death()

    def _handle_conn_death(self) -> None:
        with self._lock:
            if self._state != "DIRECT":
                return
            self._conn = None
            self._state = "CONNECTING"
            self._start_connector_locked()

    def close(self) -> None:
        with self._lock:
            conn, self._conn = self._conn, None
            self._state = "DEAD"
            self._death_reason = "owner shut down"
        if conn is not None:
            conn.close()
