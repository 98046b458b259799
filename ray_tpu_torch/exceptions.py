"""The port's copies of the exception types that the runtimes, Serve, the
trainer and the LLM engine raise (ray_tpu/exceptions.py)."""

from __future__ import annotations

import traceback
from typing import Optional


class RayTpuError(Exception):
    """Base class for all framework errors."""


class TaskError(RayTpuError):
    """A task raised an exception; re-raised at `get` on the caller, with the
    remote traceback attached."""

    def __init__(self, cause: BaseException, remote_tb: Optional[str] = None, task_desc: str = ""):
        self.cause = cause
        self.remote_tb = remote_tb or "".join(
            traceback.format_exception(type(cause), cause, cause.__traceback__)
        )
        self.task_desc = task_desc
        super().__init__(str(cause))

    def __reduce__(self):
        return (TaskError, (self.cause, self.remote_tb, self.task_desc))

    def __str__(self):
        return (
            f"{type(self.cause).__name__}: {self.cause}\n"
            f"--- remote traceback ({self.task_desc}) ---\n{self.remote_tb}"
        )


class ActorError(RayTpuError):
    pass


class ActorDiedError(ActorError):
    def __init__(self, actor_id_hex: str = "", reason: str = "actor died"):
        self.actor_id_hex = actor_id_hex
        self.reason = reason
        super().__init__(f"Actor {actor_id_hex[:12]} died: {reason}")

    def __reduce__(self):
        return (ActorDiedError, (self.actor_id_hex, self.reason))


class ActorUnavailableError(ActorError):
    pass


class GetTimeoutError(RayTpuError, TimeoutError):
    pass


class ObjectLostError(RayTpuError):
    def __init__(self, object_id_hex: str = ""):
        super().__init__(f"Object {object_id_hex[:12]} was lost and could not be reconstructed")


class ObjectStoreFullError(RayTpuError):
    def __init__(self, msg: str = "", nbytes: int = 0):
        self.nbytes = nbytes  # allocation size that failed (spill hint)
        super().__init__(msg)

    def __reduce__(self):
        return (ObjectStoreFullError, (str(self), self.nbytes))


class WorkerCrashedError(RayTpuError):
    pass


class RpcUnavailableError(RayTpuError, ConnectionError):
    """A control-plane peer (GCS/raylet) stayed unreachable past the
    reconnect deadline. Subclasses ConnectionError so transport handlers
    keep catching it."""

    def __init__(self, address: str = "", elapsed_s: float = 0.0, attempts: int = 0,
                 last_error: Optional[BaseException] = None):
        self.address = address
        self.elapsed_s = elapsed_s
        self.attempts = attempts
        self.last_error = last_error
        super().__init__(
            f"rpc peer {address} unavailable after {elapsed_s:.1f}s "
            f"({attempts} connect attempts): {last_error!r}"
        )

    def __reduce__(self):
        return (RpcUnavailableError, (self.address, self.elapsed_s, self.attempts,
                                      self.last_error))


class CollectiveTimeoutError(RayTpuError, TimeoutError):
    """A collective rendezvous (or ring establishment, or a ring op)
    exceeded its deadline. Names the group, this member's rank, and which
    ranks never registered: the difference between "socket timeout" and an
    actionable gang post-mortem."""

    def __init__(self, group: str = "", rank: int = -1, world_size: int = 0,
                 missing: Optional[list] = None, detail: str = ""):
        self.group = group
        self.rank = rank
        self.world_size = world_size
        self.missing = sorted(missing or [])
        self.detail = detail
        miss = f"; ranks never joined: {self.missing}" if self.missing else ""
        super().__init__(
            f"collective group {group!r} (rank {rank}/{world_size}) "
            f"rendezvous timed out{miss}" + (f" — {detail}" if detail else ""))

    def __reduce__(self):
        return (CollectiveTimeoutError,
                (self.group, self.rank, self.world_size, self.missing, self.detail))


class PreemptionError(RayTpuError):
    """A gang lost capacity to a (possibly synthetic) preemption notice:
    the node drained, workers checkpointed and stopped. Supervisors catch
    this to restore on replacement capacity instead of counting it as a
    training failure."""

    def __init__(self, node_ids: Optional[list] = None, reason: str = "preempted"):
        self.node_ids = list(node_ids or [])
        self.reason = reason
        nodes = ", ".join(n[:12] for n in self.node_ids) or "?"
        super().__init__(f"gang preempted (node(s) {nodes} draining): {reason}")

    def __reduce__(self):
        return (PreemptionError, (self.node_ids, self.reason))


class CapacityTimeoutError(RayTpuError, TimeoutError):
    """The capacity wait after a preemption expired and no feasible gang
    exists (non-elastic run, or feasible world below min_workers). Raised
    INSTEAD of launching a doomed attempt that would burn a retry against
    an empty cluster."""

    def __init__(self, needed: int, feasible: int, waited_s: float, min_workers: int = 0):
        self.needed = needed
        self.feasible = feasible
        self.waited_s = waited_s
        self.min_workers = min_workers
        super().__init__(
            f"no capacity for a {needed}-worker gang after {waited_s:.0f}s "
            f"(largest feasible world: {feasible}"
            + (f", elastic floor {min_workers}" if min_workers else "")
            + ")"
        )

    def __reduce__(self):
        return (CapacityTimeoutError,
                (self.needed, self.feasible, self.waited_s, self.min_workers))


class StaleNodeEpochError(RayTpuError, ConnectionError):
    """An RPC came from a node incarnation the GCS has fenced: the node was
    declared dead (heartbeat expiry during a partition) or the epoch it
    carries is not the one the GCS stamped at its registration. The caller
    is a zombie: it kills its workers, drops its leases and pins, and
    registers again as a fresh incarnation with a new epoch. A
    ConnectionError, so transport handlers treat it as the loss of the
    control-plane session, never as data."""

    def __init__(self, node_id: str = "", claimed_epoch: Optional[int] = None,
                 current_epoch: Optional[int] = None, reason: str = "node declared dead"):
        self.node_id = node_id
        self.claimed_epoch = claimed_epoch
        self.current_epoch = current_epoch
        self.reason = reason
        super().__init__(
            f"node {node_id[:12]} is fenced ({reason}; claimed epoch {claimed_epoch}, "
            f"current {current_epoch}): kill workers, drop leases, and re-register as a "
            "fresh node")

    def __reduce__(self):
        return (StaleNodeEpochError,
                (self.node_id, self.claimed_epoch, self.current_epoch, self.reason))


class TaskCancelledError(RayTpuError):
    pass


class RuntimeEnvSetupError(RayTpuError):
    pass


class PlacementGroupError(RayTpuError, RuntimeError):
    """A placement group could not be created, was removed mid-wait, or a
    bundle lease was refused."""


class SchedulingError(RayTpuError, RuntimeError):
    """No node can ever satisfy a task's or actor's resource or affinity
    demand (a permanent infeasibility, not transient load)."""


class ActorNameTakenError(RayTpuError, ValueError):
    """An actor name/namespace pair is already claimed. Subclasses
    ValueError to match the reference's naming error shape."""


class BackpressureError(RayTpuError):
    """A serve-side admission control rejected the request: the system is
    at capacity and queueing further would only grow tail latency. The
    caller should back off and retry (or route elsewhere) — the request
    was NOT partially executed."""

    def __init__(self, reason: str = "at capacity", retry_after_s: float = 0.5):
        self.reason = reason
        self.retry_after_s = retry_after_s
        super().__init__(f"request shed: {reason} (retry after {retry_after_s:.1f}s)")

    def __reduce__(self):
        return (type(self), (self.reason, self.retry_after_s))


class KVPoolExhaustedError(BackpressureError):
    """The paged KV-cache pool cannot hold the request's prompt even
    after evicting every unreferenced cached prefix. Carries pool
    occupancy so clients can distinguish 'transiently full' (retry) from
    'prompt larger than the pool' (never admissible)."""

    def __init__(self, needed_pages: int = 0, free_pages: int = 0,
                 total_pages: int = 0, retry_after_s: float = 0.5):
        self.needed_pages = needed_pages
        self.free_pages = free_pages
        self.total_pages = total_pages
        BackpressureError.__init__(
            self,
            reason=(
                f"KV page pool exhausted (need {needed_pages} pages, "
                f"{free_pages} free of {total_pages})"
            ),
            retry_after_s=retry_after_s,
        )

    def __reduce__(self):
        return (
            KVPoolExhaustedError,
            (self.needed_pages, self.free_pages, self.total_pages, self.retry_after_s),
        )


class BatchItemError(RayTpuError):
    """One item of a `@serve.batch` invocation failed: the batch handler
    put an Exception instance in that item's result slot, and only this
    item's waiter sees it."""

    def __init__(self, cause: BaseException, index: int = -1):
        self.cause = cause
        self.index = index
        super().__init__(
            f"batch item {index} failed: {type(cause).__name__}: {cause}"
        )

    def __reduce__(self):
        return (BatchItemError, (self.cause, self.index))
