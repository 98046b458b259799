"""ObjectRef: a future-like handle to a task output or put object (copy of
ray_tpu/core/object_ref.py for the PyTorch port).

Re-design of the reference's ObjectRef (reference:
python/ray/_raylet.pyx ObjectRef, src/ray/core_worker/reference_count.h):
ownership is tracked by the submitting process; dropping the last local
reference releases the object from the owner's stores.
"""

from __future__ import annotations

import concurrent.futures
from typing import TYPE_CHECKING, Optional

from .ids import ObjectID

if TYPE_CHECKING:
    from .runtime_base import Runtime


class ObjectRef:
    __slots__ = ("_id", "_runtime", "_owner_addr", "__weakref__")

    def __init__(self, object_id: ObjectID, runtime: Optional["Runtime"] = None, owner_addr: str = ""):
        self._id = object_id
        self._owner_addr = owner_addr
        if runtime is None:
            from . import runtime_base

            runtime = runtime_base.maybe_runtime()
        self._runtime = runtime
        if self._runtime is not None:
            self._runtime.add_local_ref(self._id)

    def id(self) -> ObjectID:
        return self._id

    def binary(self) -> bytes:
        return self._id.binary()

    def hex(self) -> str:
        return self._id.hex()

    def future(self) -> concurrent.futures.Future:
        """Returns a concurrent.futures.Future resolving to the object value."""
        assert self._runtime is not None
        return self._runtime.object_future(self._id)

    def __await__(self):
        import asyncio

        return asyncio.wrap_future(self.future()).__await__()

    def __del__(self):
        rt = self._runtime
        if rt is not None:
            try:
                rt.remove_local_ref(self._id)
            except Exception:  # lint: swallow-ok(__del__ during interpreter teardown)
                pass

    def __hash__(self):
        return hash(self._id)

    def __eq__(self, other):
        return isinstance(other, ObjectRef) and other._id == self._id

    def __repr__(self):
        return f"ObjectRef({self.hex()[:16]})"

    def __reduce__(self):
        # Serializing a ref inside task args/returns transfers a borrow; the
        # receiving process re-binds it to its own runtime on deserialization.
        # The owner remembers the escape: objects whose refs never left the
        # process can be freed from the pool eagerly on last-ref drop
        # (reference: reference_count.h borrower bookkeeping — Ray frees
        # immediately when it knows there are no borrowers).
        if self._runtime is not None:
            self._runtime.mark_escaped(self._id)
        return (ObjectRef._from_wire, (self._id.binary(), self._owner_addr))

    @staticmethod
    def _from_wire(id_bytes: bytes, owner_addr: str) -> "ObjectRef":
        return ObjectRef(ObjectID(id_bytes), owner_addr=owner_addr)


STREAM_COUNT_KEY = "__stream_count__"


class ObjectRefGenerator:
    """Iterator over the ObjectRefs of a streaming task
    (num_returns="streaming"; reference: python/ray/_raylet.pyx:281
    ObjectRefGenerator / streaming generator returns).

    Each `next()` blocks until the task has yielded its next value, then
    returns that value's ObjectRef — the consumer overlaps with the
    producer instead of waiting for the whole task. Item i lives at the
    task's return index i+1; index 0 is the stream header (item count),
    written when the generator finishes."""

    def __init__(self, task_id, runtime):
        self._task_id = task_id
        self._rt = runtime
        self._i = 0
        self._done = False
        # Own the header: its ref drop is what releases the task record,
        # lineage pins, and the header object itself (without this, every
        # streaming call would leak its record + header forever).
        self._header_ref = ObjectRef(task_id.object_id_for_return(0), runtime)

    def __iter__(self) -> "ObjectRefGenerator":
        return self

    def __next__(self) -> "ObjectRef":
        if self._done:
            raise StopIteration
        oid = self._rt.stream_next(self._task_id, self._i)
        if oid is None:
            self._done = True
            self._rt.stream_done(self._task_id)
            raise StopIteration
        self._i += 1
        return ObjectRef(oid, self._rt)

    def completed(self) -> bool:
        return self._done

    def __del__(self):
        try:
            if not self._done:
                self._rt.stream_done(self._task_id)
        except Exception:  # lint: swallow-ok(__del__ during interpreter teardown)
            pass
