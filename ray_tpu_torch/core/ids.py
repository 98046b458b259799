"""Unique identifiers for tasks, objects, and actors (copy of
ray_tpu/core/ids.py for the PyTorch port).

TPU-native re-design of the reference's binary ID scheme
(reference: src/ray/design_docs/id_specification.md, src/ray/common/id.h).
We keep the same conceptual hierarchy (JobID < ActorID < TaskID < ObjectID)
but use flat 16-byte random ids; the put-index / return-index is encoded in
the low 4 bytes of ObjectID like the reference does.
"""

from __future__ import annotations

import os
import threading

_ID_LEN = 16


class BaseID:
    __slots__ = ("_bytes",)

    def __init__(self, id_bytes: bytes):
        if len(id_bytes) != _ID_LEN:
            raise ValueError(f"expected {_ID_LEN} bytes, got {len(id_bytes)}")
        self._bytes = id_bytes

    @classmethod
    def from_random(cls):
        return cls(os.urandom(_ID_LEN))

    @classmethod
    def from_hex(cls, hex_str: str):
        return cls(bytes.fromhex(hex_str))

    @classmethod
    def nil(cls):
        return cls(b"\x00" * _ID_LEN)

    def binary(self) -> bytes:
        return self._bytes

    def hex(self) -> str:
        return self._bytes.hex()

    def is_nil(self) -> bool:
        return self._bytes == b"\x00" * _ID_LEN

    def __hash__(self):
        return hash(self._bytes)

    def __eq__(self, other):
        return type(other) is type(self) and other._bytes == self._bytes

    def __repr__(self):
        return f"{type(self).__name__}({self.hex()[:12]}…)"

    def __reduce__(self):
        return (type(self), (self._bytes,))


class JobID(BaseID):
    pass


class ActorID(BaseID):
    pass


class TaskID(BaseID):
    _counter = 0
    _lock = threading.Lock()

    @classmethod
    def for_task(cls) -> "TaskID":
        return cls.from_random()

    def object_id_for_return(self, index: int) -> "ObjectID":
        # Return object ids are derived from the task id + return index, as in
        # the reference (ObjectID::FromIndex, src/ray/common/id.h).
        return ObjectID(self._bytes[:12] + index.to_bytes(4, "little"))


class ObjectID(BaseID):
    def task_id(self) -> TaskID:
        return TaskID(self._bytes[:12] + b"\x00" * 4)

    def return_index(self) -> int:
        return int.from_bytes(self._bytes[12:], "little")


class PlacementGroupID(BaseID):
    pass


class NodeID(BaseID):
    pass


class WorkerID(BaseID):
    pass
