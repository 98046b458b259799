"""Remote-client driver: attaches to a cluster from any host over TCP (the
port of ray_tpu/core/client_runtime.py).

Re-design of the reference's ray client (reference: python/ray/util/client/,
a proxy through which a driver outside the cluster calls the API). The
client is a ClusterRuntime without the node-local parts: its control RPCs to
the GCS and to a gateway raylet already ride TCP (core/rpc.py), so only the
object plane is proxied, through the gateway's `client_put` / `client_get`
instead of a pool mapped on this host. Ownership, reference counting, task
records and retries run in the client as in a driver inside the cluster. The
fast path is off (the workers' direct sockets are on their own hosts): tasks
and actor calls go through the gateway raylet. A runtime env's working_dir
and py_modules directories on the client's host upload through the same GCS
KV as a driver's (ClusterRuntime._process_renv), so any node can fetch them.
Streaming returns (num_returns="streaming") step through the gateway: each
`next()` is one long poll there (`wait_objects`, woken by the item's seal
anywhere in the cluster), never a poll loop over the network. The JAX
client inherits the in-cluster driver's wait, which looks for the item in a
pool the client does not have, and blocks on the first item; the port's
gives what a driver inside the cluster gives: the items in order, the end
of the stream, an error at the index it was raised, and a cancellation.

Usage: ``ray_tpu_torch.init(address="tcp://head:port")`` against a head
started with `Cluster(head_port=...)`, with the cluster's
RAY_TPU_AUTH_TOKEN in the environment.
"""

from __future__ import annotations

import time
from typing import Any, Optional

from .. import exceptions as exc
from . import serialization
from .cluster_runtime import ClusterRuntime
from .ids import ObjectID
from .object_transport import StoredError
from .rpc import RpcClient


class _RemoteStoreProxy:
    """The part of the shared-memory store's surface ClusterRuntime uses,
    through the gateway raylet. Values cross the network: no zero copy."""

    def __init__(self, raylet: RpcClient):
        self._raylet = raylet

    def put(self, oid: ObjectID, value: Any) -> None:
        self._raylet.call("client_put", oid.hex(), serialization.pack(value))

    def put_with_pressure(self, oid, value, raylet, deadline_s=15.0, pre_pressure=None):
        self.put(oid, value)  # client_put relieves the gateway's pool itself

    def put_raw(self, oid: ObjectID, blob: bytes) -> None:
        self._raylet.call("client_put", oid.hex(), blob)

    def get(self, oid: ObjectID, timeout: Optional[float] = None) -> Any:
        window = 5.0 if timeout is None else timeout
        raw = self._raylet.call("client_get", oid.hex(), window, timeout=window + 15.0)
        if raw is None:
            raise KeyError(oid.hex())
        return serialization.unpack(raw)

    def contains(self, oid: ObjectID) -> bool:
        return False  # nothing is held here: get() always asks the gateway

    def delete(self, oid: ObjectID) -> bool:
        return False  # frees go through the GCS

    def bytes_in_use(self) -> int:
        return 0

    def num_objects(self) -> int:
        return 0

    def capacity(self) -> int:
        return 0

    def close(self) -> None:
        pass


class ClientRuntime(ClusterRuntime):
    """A driver outside the cluster. Only the object plane differs from a
    driver inside it."""

    @classmethod
    def connect_tcp(cls, gcs_address: str) -> "ClientRuntime":
        gcs = RpcClient(gcs_address)
        nodes = [n for n in gcs.call("list_nodes") if n.get("Alive")]
        if not nodes:
            raise RuntimeError(f"no alive nodes behind {gcs_address}")
        # The gateway: a raylet a client on another host can reach.
        gw = next((n for n in nodes if str(n["sock"]).startswith("tcp://")), nodes[0])
        raylet = RpcClient(gw["sock"])
        return cls(gcs, raylet, _RemoteStoreProxy(raylet), gw["NodeID"], driver=True)

    def stream_next(self, task_id, index: int, timeout: Optional[float] = None):
        """Next item oid of a streaming task, or None at the end: one
        `wait_objects` long poll on the gateway per window, which returns
        once the item or the stream's header exists on any node."""
        from .object_ref import STREAM_COUNT_KEY

        header_oid = task_id.object_id_for_return(0)
        item_oid = task_id.object_id_for_return(index + 1)
        h_item, h_header = item_oid.hex(), header_oid.hex()
        deadline = None if timeout is None else time.monotonic() + timeout
        header_seen = False
        while True:
            remaining = None if deadline is None else deadline - time.monotonic()
            if remaining is not None and remaining <= 0:
                raise exc.GetTimeoutError(
                    f"stream item {index} of {task_id.hex()[:12]} timed out")
            window = 5.0 if remaining is None else max(0.05, min(5.0, remaining))
            # Once the header says the item is in the stream, the wait is for
            # the item alone (a present header would end every wait at once).
            want = [h_item] if header_seen else [h_item, h_header]
            ready = self._raylet.call("wait_objects", want, 1, window, False,
                                      timeout=window + 15.0)
            if h_item in ready:
                self._adopt_stream_item(h_item)
                return item_oid
            if h_header in ready:
                hdr = self._get_one(header_oid, None)  # raises the task's error
                if index >= hdr.get(STREAM_COUNT_KEY, 0):
                    return None
                header_seen = True
                continue
            # Nothing this window: the header's task record drives a retry,
            # or raises for a producer that is gone.
            self._maybe_recover(header_oid)

    def _get_one(self, oid: ObjectID, deadline: Optional[float]) -> Any:
        h = oid.hex()
        while True:
            remaining = None if deadline is None else deadline - time.monotonic()
            if remaining is not None and remaining <= 0:
                raise exc.GetTimeoutError(f"get() timed out for {h[:12]}")
            window = 5.0 if remaining is None else max(0.05, min(5.0, remaining))
            raw = self._raylet.call("client_get", h, window, timeout=window + 15.0)
            if raw is not None:
                value = serialization.unpack(raw)
                if isinstance(value, StoredError):
                    raise value.error
                return value
            self._maybe_recover(oid)  # a lost task resubmits through the gateway
