"""Autoscaler v2: the reconciling instance manager over asynchronous
providers (the port of ray_tpu/autoscaler_v2.py).

Re-design of the reference's autoscaler v2 (reference:
python/ray/autoscaler/v2/instance_manager/instance_manager.py:29, the
instance state machine, and autoscaler/v2/autoscaler.py:42). Clouds
allocate asynchronously, fail and lose machines, so v2 keeps desired state
(instance records) and drives each instance through

    QUEUED -> REQUESTED -> ALLOCATED -> RAY_RUNNING
                     \\-> ALLOCATION_FAILED (retried with backoff)
    ... -> TERMINATING -> TERMINATED

against what the provider and the GCS report: failed allocations retry
after a doubling backoff, a RAY_RUNNING instance whose node died is
terminated and replaced, scale-down takes the least progressed first, and
a multi-host shape is requested as one unit. `set_pending_actors` relays an
actor-launch forecast to the GCS (`report_demand_forecast`), which sizes
the raylets' warm pools from it.

Providers: `FakeCloudProvider` (tests) and, re-exported from
accelerators/node_provider.py, `NodeProvider` and `LocalNodeProvider`
(labelled raylets on this machine; shape `{"cpus", "gpus", "slice_hosts"}`).
A multi-host shape is a GPU slice (one NVLink domain's hosts), as the
v1 loop's GPUSliceProvider gives a pending SLICE_GANG. The JAX package's
GCETPUProvider drives the gcloud CLI for Cloud TPU VMs and stays TPU-only:
it has no counterpart here. This module never imports torch.
"""

from __future__ import annotations

import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

# Instance lifecycle states (reference: v2 instance_manager's
# Instance.status values, collapsed to the load-bearing subset).
QUEUED = "QUEUED"
REQUESTED = "REQUESTED"
ALLOCATED = "ALLOCATED"
RAY_RUNNING = "RAY_RUNNING"
ALLOCATION_FAILED = "ALLOCATION_FAILED"
TERMINATING = "TERMINATING"
TERMINATED = "TERMINATED"


@dataclass
class Instance:
    instance_id: str
    shape: Dict[str, Any]  # {"cpus": .., "gpus": .., "slice_hosts": ..}
    status: str = QUEUED
    cloud_id: Optional[str] = None  # provider's handle once REQUESTED
    node_id: Optional[str] = None  # ray node id once RAY_RUNNING
    requested_at: float = 0.0
    retries: int = 0
    history: List[str] = field(default_factory=list)

    def to(self, status: str) -> None:
        self.history.append(self.status)
        self.status = status


class CloudProvider:
    """Async provider ABC (reference: node_provider.py:13, made honest
    about asynchrony): request() returns immediately; poll() reports the
    cloud's view; the reconciler converges the difference.

    The accelerators subsystem implements this contract as
    :class:`ray_tpu_torch.accelerators.NodeProvider`; its
    `LocalNodeProvider` (real raylet processes, the e2e test provider) is
    re-exported at the bottom of this module."""

    def request(self, instance: Instance) -> str:
        """Begins allocation; returns the provider's cloud_id."""
        raise NotImplementedError

    def poll(self) -> Dict[str, str]:
        """cloud_id -> "pending" | "running" | "failed" | "gone"."""
        raise NotImplementedError

    def terminate(self, cloud_id: str) -> None:
        raise NotImplementedError

    def ray_node_for(self, cloud_id: str) -> Optional[str]:
        """The ray node id running on this instance, if the provider can
        tell (the fake can; clouds match by node labels/IP)."""
        return None


class FakeCloudProvider(CloudProvider):
    """Deterministic async cloud for tests/e2e (reference:
    _private/fake_multi_node/node_provider.py:236 FakeMultiNodeProvider):
    allocations become "running" after `delay_s`, optionally failing the
    first `fail_first` requests; a running instance starts a REAL local
    node in the given Cluster so ray actually joins."""

    def __init__(self, cluster, delay_s: float = 0.2, fail_first: int = 0):
        self._cluster = cluster
        self.delay_s = delay_s
        self._fail_budget = fail_first
        self._lock = threading.Lock()
        self._instances: Dict[str, dict] = {}

    def request(self, instance: Instance) -> str:
        cloud_id = f"fake-{uuid.uuid4().hex[:8]}"
        with self._lock:
            fail = self._fail_budget > 0
            if fail:
                self._fail_budget -= 1
            self._instances[cloud_id] = {
                "ready_at": time.monotonic() + self.delay_s,
                "fail": fail,
                "node_id": None,
                "shape": instance.shape,
            }
        return cloud_id

    def poll(self) -> Dict[str, str]:
        out: Dict[str, str] = {}
        with self._lock:
            items = list(self._instances.items())
        for cid, rec in items:
            if rec["fail"]:
                out[cid] = "failed"
            elif time.monotonic() >= rec["ready_at"]:
                if rec["node_id"] is None:
                    rec["node_id"] = self._cluster.add_node(
                        num_cpus=rec["shape"].get("cpus", 2.0), num_workers=0
                    )
                out[cid] = "running"
            else:
                out[cid] = "pending"
        return out

    def ray_node_for(self, cloud_id: str) -> Optional[str]:
        rec = self._instances.get(cloud_id)
        return rec and rec["node_id"]

    def terminate(self, cloud_id: str) -> None:
        with self._lock:
            rec = self._instances.pop(cloud_id, None)
        if rec and rec["node_id"]:
            try:
                self._cluster.remove_node(rec["node_id"])
            except Exception:  # lint: swallow-ok(node already gone)
                pass


class InstanceManager:
    """The reconciler (reference: instance_manager.py:29): converges the
    instance table toward `target` instances RAY_RUNNING, absorbing async
    allocation, failures, and node death."""

    def __init__(
        self,
        provider: CloudProvider,
        gcs=None,
        *,
        shape: Optional[Dict[str, Any]] = None,
        request_timeout_s: float = 120.0,
        max_retries: int = 3,
        retry_backoff_s: float = 1.0,
    ):
        self._provider = provider
        self._gcs = gcs
        self.shape = shape or {"cpus": 2.0}
        self.request_timeout_s = request_timeout_s
        self.max_retries = max_retries
        self.retry_backoff_s = retry_backoff_s
        self.target = 0
        self.instances: Dict[str, Instance] = {}
        self._lock = threading.Lock()
        self._retry_at: Dict[str, float] = {}
        # Pending-actor forecast: the workload layer (serve autoscale,
        # elastic grow-back, an RL fleet about to scale out) declares how
        # many actor launches are imminent; reconcile() relays it to the
        # GCS, which shares it across raylet heartbeats as each node's
        # warm-pool hint — pools pre-size BEFORE the storm arrives.
        self._pending_actors = 0

    # ------------------------------------------------------------- control
    def set_target(self, n: int) -> None:
        with self._lock:
            self.target = int(n)

    def set_pending_actors(self, n: int) -> None:
        """Declares imminent actor-launch demand (forecast, not a
        reservation). Relayed to the GCS on the next reconcile round
        under the "autoscaler" forecast source (the data plane's
        starved-operator pools declare under "data" directly; the GCS
        sums sources into each heartbeat's pool_hint); TTL-bounded there
        so a stale forecast decays on its own."""
        with self._lock:
            self._pending_actors = max(0, int(n))

    def counts(self) -> Dict[str, int]:
        with self._lock:
            out: Dict[str, int] = {}
            for inst in self.instances.values():
                out[inst.status] = out.get(inst.status, 0) + 1
            return out

    def _live(self) -> List[Instance]:
        """Instances counting toward the target — including failed ones
        that will still retry (queuing a replacement for those would
        double capacity once the retry succeeds)."""
        return [
            i
            for i in self.instances.values()
            if i.status in (QUEUED, REQUESTED, ALLOCATED, RAY_RUNNING)
            or (i.status == ALLOCATION_FAILED and i.retries < self.max_retries)
        ]

    # ----------------------------------------------------------- reconcile
    def reconcile(self) -> None:
        """One reconciliation round; call from a control loop."""
        now = time.monotonic()
        cloud = {}
        try:
            cloud = self._provider.poll()
        except Exception:
            # Drive off the last view this round — but a provider that
            # stays unreachable must be visible, not silently stale.
            from .observability.logs import get_logger

            get_logger("autoscaler").warning(
                "provider poll failed; reconciling on stale view", exc_info=True
            )

        # None = GCS unreachable (no information; keep prior judgement);
        # an EMPTY set is a real observation (all nodes dead).
        alive_nodes: Optional[set] = None
        if self._gcs is not None:
            try:
                alive_nodes = {
                    n["NodeID"] for n in self._gcs.call("list_nodes") if n["Alive"]
                }
            except Exception:
                alive_nodes = None
            # Relay the pending-actor forecast ONCE per declaration: the
            # GCS consumes it per registration and TTL-expires the rest,
            # so re-sending every round would reset that consumption and
            # re-arm the TTL forever — a one-shot declaration would pin
            # every node's pool at storm size indefinitely. The local
            # value is cleared on successful relay; a failed relay
            # retries next round.
            with self._lock:
                forecast = self._pending_actors
            if forecast > 0:
                try:
                    # 60 s TTL: pools on a loaded box need tens of
                    # seconds to pre-boot a large fleet's inventory.
                    # Source-keyed: the data plane's starved-operator
                    # forecasts ("data") coexist without clobbering.
                    self._gcs.call(
                        "report_demand_forecast", forecast, 60.0, "autoscaler"
                    )
                except Exception:
                    pass  # lint: swallow-ok(forecast is an optimization hint; next round retries)
                else:
                    with self._lock:
                        if self._pending_actors == forecast:
                            self._pending_actors = 0

        with self._lock:
            # 1. Observe: move REQUESTED/ALLOCATED along per the cloud view.
            for inst in list(self.instances.values()):
                if inst.status == REQUESTED:
                    state = cloud.get(inst.cloud_id)
                    if state == "running":
                        inst.to(ALLOCATED)
                    elif state == "failed" or (
                        now - inst.requested_at > self.request_timeout_s
                    ):
                        self._fail(inst, now)
                if inst.status == ALLOCATED:
                    state = cloud.get(inst.cloud_id)
                    if state in ("failed", "gone", None) and cloud:
                        # The machine vanished between cloud-READY and ray
                        # join (preemption/manual delete): fail + replace.
                        self._fail(inst, now)
                        continue
                    node = self._provider.ray_node_for(inst.cloud_id)
                    if node and (alive_nodes is None or node in alive_nodes):
                        inst.node_id = node
                        inst.to(RAY_RUNNING)
                    elif now - inst.requested_at > self.request_timeout_s * 2:
                        # Cloud says running but ray never joined (boot
                        # script wedged): give up on this machine.
                        self._fail(inst, now)
                        continue
                if inst.status == RAY_RUNNING and alive_nodes is not None and (
                    inst.node_id not in alive_nodes
                ):
                    # The machine's ray node died (crash/preemption):
                    # terminate and let scale-up replace it.
                    inst.to(TERMINATING)
                if inst.status == TERMINATING:
                    try:
                        self._provider.terminate(inst.cloud_id)
                        inst.to(TERMINATED)
                    except Exception:  # lint: swallow-ok(terminate retried next reconcile round)
                        pass

            # 2. Retry failed allocations after backoff.
            for inst in list(self.instances.values()):
                if inst.status == ALLOCATION_FAILED:
                    if inst.retries >= self.max_retries:
                        continue
                    if now >= self._retry_at.get(inst.instance_id, 0.0):
                        inst.retries += 1
                        inst.to(QUEUED)

            # 3. Converge count: queue new / terminate surplus.
            live = self._live()
            for _ in range(self.target - len(live)):
                iid = uuid.uuid4().hex
                self.instances[iid] = Instance(iid, dict(self.shape))
            surplus = len(live) - self.target
            if surplus > 0:
                # Prefer terminating the least-progressed instances.
                order = {
                    ALLOCATION_FAILED: 0,
                    QUEUED: 1,
                    REQUESTED: 2,
                    ALLOCATED: 3,
                    RAY_RUNNING: 4,
                }
                for inst in sorted(live, key=lambda i: order[i.status])[:surplus]:
                    if inst.status in (QUEUED, ALLOCATION_FAILED):
                        inst.to(TERMINATED)
                    else:
                        inst.to(TERMINATING)

            # 4. Collect queued requests; issue them OUTSIDE the lock
            # (a real provider's request is a seconds-long cloud call;
            # holding the lock would block set_target/counts for the
            # whole batch).
            to_request = [i for i in self.instances.values() if i.status == QUEUED]
        for inst in to_request:
            try:
                cloud_id = self._provider.request(inst)
            except Exception:
                with self._lock:
                    self._fail(inst, now)
                continue
            with self._lock:
                inst.cloud_id = cloud_id
                inst.requested_at = now
                inst.to(REQUESTED)

    def _fail(self, inst: Instance, now: float) -> None:
        inst.to(ALLOCATION_FAILED)
        if inst.cloud_id:
            try:
                self._provider.terminate(inst.cloud_id)
            except Exception:
                pass  # lint: swallow-ok(failed-allocation cleanup; poll reconciles leftovers)
            inst.cloud_id = None
        self._retry_at[inst.instance_id] = now + self.retry_backoff_s * (
            2**inst.retries
        )

    # ------------------------------------------------------------ blocking
    def wait_running(self, n: int, timeout: float = 60.0, interval: float = 0.1) -> bool:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            self.reconcile()
            if self.counts().get(RAY_RUNNING, 0) >= n:
                return True
            time.sleep(interval)
        return False

    def wait_allocated(self, n: int, timeout: float = 600.0, interval: float = 0.5) -> bool:
        """Converge until `n` instances are at least cloud-allocated
        (ALLOCATED or RAY_RUNNING). The `ray-tpu up` launcher waits on
        this when it has no GCS to observe ray joins through (the head
        may be one of the machines being created)."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            self.reconcile()
            c = self.counts()
            if c.get(ALLOCATED, 0) + c.get(RAY_RUNNING, 0) >= n:
                return True
            time.sleep(interval)
        return False


# The providers live with the accelerator subsystem (one import surface for
# the reconciler and its providers).
from .accelerators.node_provider import LocalNodeProvider, NodeProvider  # noqa: E402,F401
