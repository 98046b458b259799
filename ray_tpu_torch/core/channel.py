"""Preallocated SPSC channels (copy of ray_tpu/core/channel.py for the
PyTorch port): the transport of the LLM feed (serve/llm/feed.py).

One transport, the node-local **shm ring**: an mmap'd ring buffer file
holding length-prefixed pickled records, plus a tiny UDS used purely for
blocking wakeups (data never rides it). Writer blocks when the ring is
full (backpressure), reader blocks when empty. Positions are monotonic
u64s so free space is one subtraction. (ray_tpu/core/channel.py also has
a TCP stream transport for writers on other hosts; it belongs to the
cluster runtime, which the port does not have yet.)

The READER hosts the channel (creates the ring file + listener); writers
attach by descriptor.
"""

from __future__ import annotations

import contextlib
import mmap
import os
import pickle
import select
import socket
import struct
import time
import uuid
from typing import Any, Optional

from ..chaos.controller import maybe_inject as _chaos_inject
from ..observability.flight_recorder import record as _flight_record


def _apply_channel_chaos(point: str, name: str) -> bool:
    """Chaos hook shared by reader and writer. Returns True when the
    message must be DROPPED (writer only); `delay` sleeps here; `raise`
    surfaces as ChannelClosed — the same exception a dead peer produces,
    so recovery paths are exercised, not special-cased. Disabled cost:
    one global load inside maybe_inject."""
    rule = _chaos_inject(point, name)
    if rule is None:
        return False
    if rule.action == "delay":
        time.sleep(rule.delay_s)
        return False
    if rule.action == "drop":
        _flight_record("chan.chaos_drop", name)
        return True
    if rule.action == "raise":
        raise ChannelClosed(f"{name} (chaos: injected channel fault)")
    return False

_HDR = struct.Struct("<QQII")  # write_pos, read_pos, reader_closed, writer_closed
_LEN = struct.Struct("<I")
_WRAP = 0xFFFFFFFF
_DATA_OFF = 64  # header page; positions are offsets into the data region

# Floor below which a ring cannot hold even one tiny record on each side
# of the half-capacity rule; ChannelSpec rejects these at build time.
MIN_CAPACITY = 64

# A blocked reader/writer re-checks the shared header at least this often
# even if its wakeup socket never fires: peer close is detected promptly
# whether or not the close managed to send a token (bounded poll).
_POLL_S = 0.2


class ChannelClosed(Exception):
    """The peer closed the channel (teardown or process death)."""


def _align(n: int) -> int:
    return (n + 7) & ~7


def required_capacity(max_message: int) -> int:
    """Smallest ring capacity that can carry a `max_message`-byte payload.

    Records are capped at half the capacity (see ChannelWriter.write_bytes:
    the wrap-tail + record must fit an empty ring), so the requirement is
    2x one aligned framed record."""
    return max(MIN_CAPACITY, 2 * _align(_LEN.size + int(max_message)))


def validate_capacity(capacity: int, max_message: int = 0) -> int:
    """Validates a channel buffer size up front (compile time) instead of
    letting the first oversized write fail mid-pipeline."""
    if not isinstance(capacity, int) or isinstance(capacity, bool):
        raise TypeError(f"channel capacity must be an int, got {type(capacity).__name__}")
    if capacity < MIN_CAPACITY:
        raise ValueError(
            f"channel capacity {capacity} below minimum {MIN_CAPACITY}"
        )
    need = required_capacity(max_message) if max_message else MIN_CAPACITY
    if capacity < need:
        raise ValueError(
            f"channel capacity {capacity} cannot hold one aligned "
            f"{max_message}-byte message (records are capped at half the "
            f"capacity; need >= {need})"
        )
    return capacity


class ChannelSpec:
    """Serializable descriptor a writer uses to attach."""

    __slots__ = ("name", "ring_path", "uds_path", "capacity")

    def __init__(self, name, ring_path, uds_path, capacity):
        validate_capacity(capacity)
        self.name = name
        self.ring_path = ring_path
        self.uds_path = uds_path
        self.capacity = capacity

    def __reduce__(self):
        return (
            ChannelSpec,
            (self.name, self.ring_path, self.uds_path, self.capacity),
        )


class _Ring:
    """Shared-memory ring state over an mmap'd file."""

    def __init__(self, path: str, capacity: int, create: bool):
        self.capacity = capacity
        size = _DATA_OFF + capacity
        flags = os.O_RDWR | (os.O_CREAT if create else 0)
        fd = os.open(path, flags, 0o600)
        try:
            if create:
                os.ftruncate(fd, size)
            self.mm = mmap.mmap(fd, size)
        finally:
            os.close(fd)
        if create:
            _HDR.pack_into(self.mm, 0, 0, 0, 0, 0)

    # positions are monotonic; offset = pos % capacity
    def header(self):
        try:
            return _HDR.unpack_from(self.mm, 0)
        except ValueError:  # mmap closed under a concurrent reader/writer
            raise ChannelClosed("ring unmapped")

    def set_write_pos(self, pos: int):
        struct.pack_into("<Q", self.mm, 0, pos)

    def set_read_pos(self, pos: int):
        struct.pack_into("<Q", self.mm, 8, pos)

    def set_reader_closed(self):
        struct.pack_into("<I", self.mm, 16, 1)

    def set_writer_closed(self):
        struct.pack_into("<I", self.mm, 20, 1)

    def write_record(self, wpos: int, payload) -> int:
        """Writes one record at wpos (caller checked space); returns new wpos."""
        cap = self.capacity
        n = len(payload)
        off = wpos % cap
        if cap - off < _LEN.size:
            # No room even for a length: implicit wrap (reader mirrors).
            wpos += cap - off
            off = 0
        elif cap - off < _LEN.size + n:
            # Length fits but payload would split: explicit wrap marker.
            _LEN.pack_into(self.mm, _DATA_OFF + off, _WRAP)
            wpos += cap - off
            off = 0
        _LEN.pack_into(self.mm, _DATA_OFF + off, n)
        self.mm[_DATA_OFF + off + _LEN.size : _DATA_OFF + off + _LEN.size + n] = payload
        return wpos + _align(_LEN.size + n)

    def space_needed(self, wpos: int, n: int) -> int:
        """Exact ring bytes consumed writing an n-byte payload at wpos —
        includes the skipped tail when the record wraps."""
        cap = self.capacity
        off = wpos % cap
        rec = _align(_LEN.size + n)
        if cap - off < _LEN.size + n:  # wraps (implicitly or via marker)
            return (cap - off) + rec
        return rec

    def read_record(self, rpos: int) -> tuple:
        """Returns (payload_bytes, new_rpos). Caller checked non-empty."""
        cap = self.capacity
        off = rpos % cap
        if cap - off < _LEN.size:
            rpos += cap - off
            off = 0
        (n,) = _LEN.unpack_from(self.mm, _DATA_OFF + off)
        if n == _WRAP:
            rpos += cap - off
            off = 0
            (n,) = _LEN.unpack_from(self.mm, _DATA_OFF + off)
        start = _DATA_OFF + off + _LEN.size
        payload = bytes(self.mm[start : start + n])
        return payload, rpos + _align(_LEN.size + n)

    def close(self):
        with contextlib.suppress(Exception):
            self.mm.close()


def _drain(sock: socket.socket) -> bool:
    """Consumes pending wakeup tokens; False when the peer closed."""
    try:
        while True:
            data = sock.recv(4096)
            if not data:
                return False
    except (BlockingIOError, InterruptedError):
        return True
    except OSError:
        return False


def _token(sock: Optional[socket.socket]) -> None:
    if sock is None:
        return
    try:
        sock.send(b"\x01")
    except (BlockingIOError, InterruptedError):
        pass  # peer has wakeups pending already
    except OSError:
        pass  # peer gone; positions/closed flag are authoritative


class ChannelReader:
    """Reader end; hosts the ring + listener. One reader per channel."""

    def __init__(
        self,
        session_dir: str,
        name: Optional[str] = None,
        capacity: int = 8 << 20,
        max_message: int = 0,
    ):
        validate_capacity(capacity, max_message)
        self.name = name or uuid.uuid4().hex[:12]
        self.capacity = capacity
        self._closed = False
        base = os.path.join(session_dir, f"ch_{self.name}")
        self.ring_path = base + ".ring"
        self.uds_path = base + ".sock"
        self._ring = _Ring(self.ring_path, capacity, create=True)
        with contextlib.suppress(OSError):
            os.unlink(self.uds_path)
        self._uds_srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._uds_srv.bind(self.uds_path)
        self._uds_srv.listen(2)
        self._conn: Optional[socket.socket] = None  # wakeup/credit

    def spec(self) -> ChannelSpec:
        return ChannelSpec(self.name, self.ring_path, self.uds_path, self.capacity)

    def _accept(self, timeout: Optional[float]) -> None:
        """Waits for a writer to attach over the UDS."""
        r, _, _ = select.select([self._uds_srv], [], [], timeout)
        if not r:
            raise TimeoutError(f"channel {self.name}: no writer attached")
        conn, _ = self._uds_srv.accept()
        conn.setblocking(False)
        self._conn = conn

    def read(self, timeout: Optional[float] = None) -> Any:
        payload = self.read_bytes(timeout)
        return pickle.loads(payload)

    def read_bytes(self, timeout: Optional[float] = None) -> bytes:
        if self._closed:
            raise ChannelClosed(self.name)
        if self._conn is None:
            self._accept(timeout)
        _apply_channel_chaos("chan.read", self.name)
        # Flight-recorder bracket: a `chan.read_wait` with no matching
        # `chan.read` in a hang dump names the blocked channel.
        _flight_record("chan.read_wait", self.name)
        try:
            payload = self._read_ring(timeout)
        except TimeoutError:
            _flight_record("chan.read_timeout", self.name)
            raise
        except ChannelClosed:
            _flight_record("chan.closed", self.name)
            raise
        _flight_record("chan.read", (self.name, len(payload)))
        return payload

    def _read_ring(self, timeout: Optional[float]) -> bytes:
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            wpos, rpos, rclosed, wclosed = self._ring.header()
            if wpos != rpos:
                payload, new_rpos = self._ring.read_record(rpos)
                self._ring.set_read_pos(new_rpos)
                _token(self._conn)  # credit: unblock a full writer
                return payload
            if rclosed or wclosed:
                # Peer (or we) closed and the ring is drained: surface it
                # rather than waiting for data that can never arrive.
                raise ChannelClosed(self.name)
            remain = None if deadline is None else max(0.0, deadline - time.monotonic())
            if remain is not None and remain <= 0.0:
                raise TimeoutError(f"channel {self.name}: empty after {timeout}s")
            # Bounded poll: the writer-closed flag is written without a
            # guaranteed token (the close may race socket teardown), so
            # never sleep unboundedly on the wakeup socket alone.
            wait = _POLL_S if remain is None else min(remain, _POLL_S)
            r, _, _ = select.select([self._conn], [], [], wait)
            if r and not _drain(self._conn):
                # Writer hung up; drain anything it published first.
                wpos, rpos, rclosed, wclosed = self._ring.header()
                if wpos == rpos:
                    raise ChannelClosed(self.name)

    def close(self) -> None:
        if self._closed:
            return  # idempotent: teardown and loop-exit cascade both close
        self._closed = True
        with contextlib.suppress(Exception):
            self._ring.set_reader_closed()
        for s in (self._conn, self._uds_srv):
            if s is not None:
                with contextlib.suppress(OSError):
                    s.close()
        self._ring.close()
        for p in (self.ring_path, self.uds_path):
            with contextlib.suppress(OSError):
                os.unlink(p)


class ChannelWriter:
    """Writer end; attaches to a reader-hosted channel by descriptor.

    `metrics_label` (optional) turns on data-plane instrumentation: bytes
    and messages written plus the ring occupancy high-water mark flow to
    utils/internal_metrics tagged with that label (the LLM feed labels
    its response channels)."""

    def __init__(
        self,
        spec: ChannelSpec,
        connect_timeout: float = 20.0,
        metrics_label: Optional[str] = None,
    ):
        self.spec = spec
        self._closed = False
        self._ring: Optional[_Ring] = None
        self._sock: Optional[socket.socket] = None
        self._m_msgs = self._m_bytes = self._m_hwm = None
        self._hwm = 0
        if metrics_label:
            from ..utils import internal_metrics as imet

            self._m_msgs = imet.CGRAPH_CHANNEL_MSGS.labels(channel=metrics_label)
            self._m_bytes = imet.CGRAPH_CHANNEL_BYTES.labels(channel=metrics_label)
            self._m_hwm = imet.CGRAPH_RING_HWM.labels(channel=metrics_label)
        deadline = time.monotonic() + connect_timeout
        last: Optional[Exception] = None
        while time.monotonic() < deadline:
            try:
                s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
                try:
                    s.connect(spec.uds_path)
                    self._ring = _Ring(spec.ring_path, spec.capacity, create=False)
                except OSError:
                    s.close()
                    raise
                s.setblocking(False)
                self._sock = s
                return
            except OSError as e:
                last = e
                time.sleep(0.05)
        raise ConnectionError(f"cannot attach channel {spec.name}: {last}")

    def write(self, value: Any, timeout: Optional[float] = None) -> None:
        self.write_bytes(pickle.dumps(value, protocol=5), timeout)

    def write_bytes(self, payload: bytes, timeout: Optional[float] = None) -> None:
        if self._closed:
            raise ChannelClosed(self.spec.name)
        if _apply_channel_chaos("chan.write", self.spec.name):
            return  # injected message drop: the bytes never hit the wire
        _flight_record("chan.write_wait", self.spec.name)
        try:
            self._write_bytes_inner(payload, timeout)
        except TimeoutError:
            _flight_record("chan.write_timeout", self.spec.name)
            raise
        except ChannelClosed:
            _flight_record("chan.closed", self.spec.name)
            raise
        _flight_record("chan.write", (self.spec.name, len(payload)))

    def _write_bytes_inner(self, payload: bytes, timeout: Optional[float]) -> None:
        ring = self._ring
        # Half-capacity record cap: guarantees wrap-tail + record always fit
        # in an empty ring ((cap-off)+rec < cap), so a full-size record can
        # never deadlock waiting for space that cannot exist.
        if _align(_LEN.size + len(payload)) > ring.capacity // 2:
            raise ValueError(
                f"record of {len(payload)} bytes exceeds half the channel "
                f"capacity ({ring.capacity}); raise capacity at compile time"
            )
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            wpos, rpos, rclosed, _wclosed = ring.header()
            if rclosed:
                raise ChannelClosed(self.spec.name)
            need = ring.space_needed(wpos, len(payload))
            if ring.capacity - (wpos - rpos) >= need:
                new_wpos = ring.write_record(wpos, payload)
                ring.set_write_pos(new_wpos)
                _token(self._sock)
                self._record_write(len(payload), new_wpos - rpos)
                return
            remain = None if deadline is None else max(0.0, deadline - time.monotonic())
            if remain is not None and remain <= 0.0:
                raise TimeoutError(
                    f"channel {self.spec.name}: full after {timeout}s (backpressure)"
                )
            # Bounded credit wait: the reader-closed flag may be set
            # without a reachable wakeup socket (reader died mid-close).
            wait = _POLL_S if remain is None else min(remain, _POLL_S)
            r, _, _ = select.select([self._sock], [], [], wait)
            if r and not _drain(self._sock):
                raise ChannelClosed(self.spec.name)

    def _record_write(self, nbytes: int, occupancy) -> None:
        if self._m_msgs is None:
            return
        self._m_msgs.inc()
        self._m_bytes.inc(float(nbytes))
        if occupancy > self._hwm:
            self._hwm = occupancy
            self._m_hwm.set(float(occupancy))

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        if self._ring is not None:
            # Publish the close through the ring itself, then best-effort
            # wake the reader: a reader blocked in read() must see
            # ChannelClosed promptly even if the token never lands (its
            # poll is bounded).
            with contextlib.suppress(Exception):
                self._ring.set_writer_closed()
            _token(self._sock)
        if self._sock is not None:
            with contextlib.suppress(OSError):
                self._sock.close()
        if self._ring is not None:
            self._ring.close()
