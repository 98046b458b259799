"""Python client for the native shared-memory object pool (copy of
ray_tpu/core/shm_store.py for the PyTorch port).

Analogue of the reference's plasma client (reference:
src/ray/object_manager/plasma/client.h, python binding in _raylet.pyx):
put serializes directly into pool memory; get returns values whose large
buffers (numpy arrays) alias pool memory zero-copy, pinned until the last
Python reference to them drops (PEP-688 buffer wrapper replaces plasma's
client-side object-in-use tracking).
"""

from __future__ import annotations

import ctypes
import errno
import mmap
import os
import time
from typing import Any, Optional

from .. import exceptions as exc
from ..native.build import shm_pool_lib
from ..utils import internal_metrics as imet
from . import serialization
from .ids import ObjectID

_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(shm_pool_lib())
        lib.rtpt_pool_create.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
        lib.rtpt_pool_create.restype = ctypes.c_int
        lib.rtpt_pool_attach.argtypes = [ctypes.c_char_p]
        lib.rtpt_pool_attach.restype = ctypes.c_int
        lib.rtpt_create.argtypes = [
            ctypes.c_int,
            ctypes.c_char_p,
            ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_uint64),
        ]
        lib.rtpt_create.restype = ctypes.c_int
        for f in ("rtpt_seal", "rtpt_contains", "rtpt_release", "rtpt_delete"):
            fn = getattr(lib, f)
            fn.argtypes = [ctypes.c_int, ctypes.c_char_p]
            fn.restype = ctypes.c_int
        lib.rtpt_get.argtypes = [
            ctypes.c_int,
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_uint64),
        ]
        lib.rtpt_get.restype = ctypes.c_int
        for f in ("rtpt_bytes_in_use", "rtpt_num_objects", "rtpt_capacity",
                  "rtpt_largest_free"):
            fn = getattr(lib, f)
            fn.argtypes = [ctypes.c_int]
            fn.restype = ctypes.c_uint64
        lib.rtpt_pool_detach.argtypes = [ctypes.c_int]
        lib.rtpt_pool_detach.restype = ctypes.c_int
        _lib = lib
    return _lib


class _Pin:
    """Keeps a pool object pinned while any deserialized buffer aliases it.

    Supports the buffer protocol (PEP 688) so it can back PickleBuffers;
    numpy arrays reconstructed from it hold a reference chain
    array -> memoryview -> _Pin, and the pin is released when that chain dies.
    """

    __slots__ = ("_store", "_key", "_view", "_released", "__weakref__")

    def __init__(self, store: "SharedMemoryStore", key: bytes, view: memoryview):
        self._store = store
        self._key = key
        self._view = view
        self._released = False

    def __buffer__(self, flags: int) -> memoryview:
        return self._view

    def slice(self, start: int, stop: int) -> memoryview:
        return self._view[start:stop]

    def release(self):
        if not self._released:
            self._released = True
            self._store._release(self._key)

    def __del__(self):
        try:
            self.release()
        except Exception:  # lint: swallow-ok(interpreter teardown; the OS unmaps the pool)
            pass


class SharedMemoryStore:
    """One node's shared object pool; every local process attaches to it."""

    DEFAULT_CAPACITY = 2 << 30

    def __init__(self, path: str):
        self._path = path
        self._lib = _load()
        self._handle = self._lib.rtpt_pool_attach(path.encode())
        if self._handle < 0:
            raise OSError(-self._handle, f"failed to attach pool at {path}")
        fd = os.open(path, os.O_RDWR)
        try:
            self._map = mmap.mmap(fd, 0)
        finally:
            os.close(fd)
        try:
            # Hint the kernel to fault tmpfs pages in ahead of first write:
            # cold-page faults during a large put() otherwise dominate.
            self._map.madvise(mmap.MADV_WILLNEED)
        except (AttributeError, OSError):
            pass
        self._mv = memoryview(self._map)
        self._closed = False

    # ----------------------------------------------------------------- admin
    @classmethod
    def create(cls, path: str, capacity: int = DEFAULT_CAPACITY) -> "SharedMemoryStore":
        rc = _load().rtpt_pool_create(path.encode(), capacity)
        if rc != 0 and rc != -errno.EEXIST:
            raise OSError(-rc, f"failed to create pool at {path}")
        # On -EEXIST another process won the O_EXCL race and may still be
        # initializing (magic is written last); retry attach briefly.
        deadline = time.monotonic() + 10.0
        while True:
            try:
                return cls(path)
            except OSError:
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.01)

    def close(self):
        if self._handle < 0 or self._closed:
            return
        self._closed = True
        try:
            self._mv.release()
            self._map.close()
        except BufferError:
            # Zero-copy arrays from get() are still alive and alias the map.
            # Leave the mapping and handle in place so their pins can still
            # release; the OS reclaims everything at process exit.
            return
        self._lib.rtpt_pool_detach(self._handle)
        self._handle = -1

    # ------------------------------------------------------------------- put
    def put(self, oid: ObjectID, value: Any) -> None:
        meta, buffers = serialization.serialize(value)
        size = serialization.packed_size(meta, buffers)
        off = ctypes.c_uint64()
        rc = self._lib.rtpt_create(self._handle, oid.binary(), size, ctypes.byref(off))
        if rc == -errno.EEXIST:
            return  # idempotent: object already present
        if rc == -errno.ENOMEM:
            raise exc.ObjectStoreFullError(
                f"object of {size} bytes does not fit (in use: {self.bytes_in_use()}"
                f" / {self.capacity()})",
                nbytes=size,
            )
        if rc != 0:
            raise OSError(-rc, "rtpt_create failed")
        dst = self._mv[off.value : off.value + size]
        # Write the framed payload directly into pool memory (one copy).
        pos = 0
        dst[pos : pos + 4] = len(buffers).to_bytes(4, "little")
        pos += 4
        dst[pos : pos + 8] = len(meta).to_bytes(8, "little")
        pos += 8
        dst[pos : pos + len(meta)] = meta
        pos += len(meta)
        for b in buffers:
            dst[pos : pos + 8] = b.nbytes.to_bytes(8, "little")
            pos += 8
            flat = b.cast("B") if b.ndim != 1 or b.format != "B" else b
            if flat.nbytes >= (1 << 20):
                # numpy's copy loop beats CPython's memoryview slice-assign
                # on wide buffers.
                import numpy as _np

                _np.copyto(
                    _np.frombuffer(dst, dtype=_np.uint8, count=flat.nbytes, offset=pos),
                    _np.frombuffer(flat, dtype=_np.uint8),
                )
            else:
                dst[pos : pos + flat.nbytes] = flat
            pos += flat.nbytes
        del dst
        self._lib.rtpt_seal(self._handle, oid.binary())
        imet.STORE_PUTS.inc()

    def put_raw(self, oid: ObjectID, data: bytes) -> None:
        """Stores pre-framed bytes (used by the transfer path)."""
        off = ctypes.c_uint64()
        rc = self._lib.rtpt_create(self._handle, oid.binary(), len(data), ctypes.byref(off))
        if rc == -errno.EEXIST:
            return
        if rc == -errno.ENOMEM:
            raise exc.ObjectStoreFullError(
                f"object of {len(data)} bytes does not fit", nbytes=len(data)
            )
        if rc != 0:
            raise OSError(-rc, "rtpt_create failed")
        self._mv[off.value : off.value + len(data)] = data
        self._lib.rtpt_seal(self._handle, oid.binary())
        imet.STORE_PUTS.inc()

    # --------------------------------------------- chunked transfer path
    def begin_put_raw(self, oid: ObjectID, size: int) -> Optional[int]:
        """Allocates an unsealed region for incremental chunk writes
        (reference: plasma CreateAndSpillIfNeeded + the object manager
        writing received chunks in place, object_buffer_pool.h). Returns
        the pool offset, or None when the object already exists."""
        off = ctypes.c_uint64()
        rc = self._lib.rtpt_create(self._handle, oid.binary(), size, ctypes.byref(off))
        if rc == -errno.EEXIST:
            return None
        if rc == -errno.ENOMEM:
            raise exc.ObjectStoreFullError(
                f"object of {size} bytes does not fit", nbytes=size
            )
        if rc != 0:
            raise OSError(-rc, "rtpt_create failed")
        return off.value

    def write_raw_at(self, pool_offset: int, pos: int, data: bytes) -> None:
        self._mv[pool_offset + pos : pool_offset + pos + len(data)] = data

    def finish_put_raw(self, oid: ObjectID) -> None:
        self._lib.rtpt_seal(self._handle, oid.binary())
        imet.STORE_PUTS.inc()

    def raw_size(self, oid: ObjectID) -> Optional[int]:
        off = ctypes.c_uint64()
        size = ctypes.c_uint64()
        rc = self._lib.rtpt_get(self._handle, oid.binary(), ctypes.byref(off), ctypes.byref(size))
        if rc != 0:
            return None
        try:
            return size.value
        finally:
            self._lib.rtpt_release(self._handle, oid.binary())

    def read_raw_chunk(self, oid: ObjectID, chunk_off: int, length: int) -> Optional[bytes]:
        """Copies one chunk of the framed payload out (pinned only for the
        duration of the copy)."""
        off = ctypes.c_uint64()
        size = ctypes.c_uint64()
        rc = self._lib.rtpt_get(self._handle, oid.binary(), ctypes.byref(off), ctypes.byref(size))
        if rc != 0:
            return None
        try:
            end = min(size.value, chunk_off + length)
            if chunk_off >= size.value:
                return b""
            return bytes(self._mv[off.value + chunk_off : off.value + end])
        finally:
            self._lib.rtpt_release(self._handle, oid.binary())

    # ------------------------------------------------------------------- get
    def get(self, oid: ObjectID, timeout: Optional[float] = None) -> Any:
        """Fetches and deserializes; with a timeout, waits for a concurrent
        writer to create+seal the object. timeout=None raises KeyError
        immediately when absent (the runtime layer waits on task futures
        before calling get, so absent normally means lost)."""
        off = ctypes.c_uint64()
        size = ctypes.c_uint64()
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            rc = self._lib.rtpt_get(self._handle, oid.binary(), ctypes.byref(off), ctypes.byref(size))
            if rc == 0:
                break
            if rc in (-errno.ENOENT, -errno.EAGAIN):
                if rc == -errno.ENOENT and deadline is None:
                    raise KeyError(oid.hex())
                if deadline is not None and time.monotonic() > deadline:
                    if rc == -errno.ENOENT:
                        raise KeyError(oid.hex())
                    raise exc.GetTimeoutError(f"object {oid.hex()[:12]} never sealed")
                time.sleep(0.0002)
                continue
            raise OSError(-rc, "rtpt_get failed")
        # Readers get read-only views: pool objects are immutable after seal.
        pin = _Pin(self, oid.binary(), self._mv[off.value : off.value + size.value].toreadonly())
        try:
            view = memoryview(pin)  # PEP 688: pin rides the buffer chain
        except TypeError:
            # Python < 3.12 has no pure-python __buffer__: nothing can tie
            # the pin's lifetime to reconstructed arrays, so deserialize
            # from a COPY (correctness over zero-copy) and unpin.
            data = bytes(pin.slice(0, size.value))
            pin.release()
            value, _ = serialization.unpack_info(data)
            return value
        value, n_oob = serialization.unpack_info(view)
        if n_oob == 0:
            pin.release()  # nothing aliases the pool; unpin now
        return value

    def get_raw(self, oid: ObjectID) -> Optional[bytes]:
        """Copies the framed payload out (used by the transfer path)."""
        off = ctypes.c_uint64()
        size = ctypes.c_uint64()
        rc = self._lib.rtpt_get(self._handle, oid.binary(), ctypes.byref(off), ctypes.byref(size))
        if rc != 0:
            return None
        try:
            return bytes(self._mv[off.value : off.value + size.value])
        finally:
            self._lib.rtpt_release(self._handle, oid.binary())

    # --------------------------------------------------------------- manage
    def contains(self, oid: ObjectID) -> bool:
        return self._lib.rtpt_contains(self._handle, oid.binary()) == 1

    def _release(self, key: bytes) -> None:
        if self._handle >= 0:
            self._lib.rtpt_release(self._handle, key)

    def delete(self, oid: ObjectID) -> bool:
        """Returns True if freed now; False if pinned (caller retries later)."""
        if self._closed or self._handle < 0:
            # Interpreter-shutdown ObjectRef finalizers can fire after
            # close(); a call with a dead handle would index out of bounds.
            return False
        rc = self._lib.rtpt_delete(self._handle, oid.binary())
        return rc == 0

    def put_with_pressure(
        self, oid: ObjectID, value: Any, raylet, deadline_s: float = 15.0, pre_pressure=None
    ) -> None:
        """put() with bounded retry under pool pressure: asks the raylet to
        evict/spill and waits for readers to drop zero-copy pins (reference:
        plasma's queued CreateRequest retries before ObjectStoreFullError).
        `pre_pressure` runs first (e.g. the owner flushing its pending frees
        so eviction isn't asked to spill objects that are already dead)."""
        deadline = time.monotonic() + deadline_s
        while True:
            try:
                self.put(oid, value)
                return
            except exc.ObjectStoreFullError as e:
                if pre_pressure is not None:
                    try:
                        pre_pressure()
                    # lint: swallow-ok(advisory pre-pressure; ensure_space below is the guarantee)
                    except Exception:
                        pass
                raylet.call("ensure_space", e.nbytes)
                try:
                    self.put(oid, value)
                    return
                except exc.ObjectStoreFullError:
                    if time.monotonic() > deadline:
                        raise
                    time.sleep(0.25)

    def bytes_in_use(self) -> int:
        return self._lib.rtpt_bytes_in_use(self._handle)

    def fits(self, nbytes: int) -> bool:
        """True when one free block can take an object of `nbytes` now: the
        first-fit pool can hold fewer bytes than its capacity less
        bytes_in_use in one piece."""
        return (int(nbytes) + 63) // 64 * 64 <= self._lib.rtpt_largest_free(self._handle)

    def num_objects(self) -> int:
        return self._lib.rtpt_num_objects(self._handle)

    def capacity(self) -> int:
        return self._lib.rtpt_capacity(self._handle)
