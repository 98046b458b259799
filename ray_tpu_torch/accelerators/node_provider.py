"""NodeProvider and LocalNodeProvider: the asynchronous provider contract
the autoscaler-v2 reconciler drives, and its provider on one machine (the
port of ray_tpu/accelerators/node_provider.py).

Re-design of the reference's provider split (reference:
python/ray/autoscaler/node_provider.py:13 NodeProvider;
_private/fake_multi_node/node_provider.py:236 the test double):

* The contract is asynchronous: `request` returns a cloud id at once and
  `poll` reports the provider's view; the reconciler converges the two.
* A multi-host shape (`slice_hosts` > 1) is one unit: all of its hosts come
  up, labelled with one `slice_name` and their `worker_index`, or none do.
* Labels close the loop: every node of an instance carries the label
  `ray_tpu_cloud_id=<cloud id>`, and `ray_node_for` finds the instance's
  node in the GCS's node table by that label, which is how the reconciler
  reaches RAY_RUNNING.

A shape is `{"cpus": c, "gpus": g, "slice_hosts": n, "resources": {...}}`
(`gpus` where the JAX package has `tpus`); each host is
`Cluster.add_node(num_cpus=c, num_gpus=g, labels=...)`. The JAX package's
GceTpuNodeProvider is a Cloud TPU REST client and stays TPU-only. This
module never imports torch.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional

from ..chaos.controller import maybe_inject as _chaos_inject
from ..observability.flight_recorder import record as _flight_record
from ..observability.logs import get_logger as _get_logger

_log = _get_logger("accelerators")

CLOUD_ID_LABEL = "ray_tpu_cloud_id"


class NodeProvider:
    """The asynchronous provider the autoscaler-v2 InstanceManager drives
    (its method set is autoscaler_v2.CloudProvider's)."""

    def request(self, instance) -> str:
        """Begins allocating `instance` (.instance_id, .shape); returns the
        provider's cloud id. A multi-host shape allocates atomically."""
        raise NotImplementedError

    def poll(self) -> Dict[str, str]:
        """cloud_id -> "pending" | "running" | "failed" | "gone"."""
        raise NotImplementedError

    def terminate(self, cloud_id: str) -> None:
        raise NotImplementedError

    def ray_node_for(self, cloud_id: str) -> Optional[str]:
        """The ray node id of the instance (worker 0 of a slice) once every
        host of it has joined; None before then."""
        return None

    def node_labels(self, cloud_id: str) -> Dict[str, str]:
        """Labels the provider stamped on this instance's node(s)."""
        return {}


class LocalNodeProvider(NodeProvider):
    """Real nodes on one machine: every `request` starts raylet processes
    through a `core.cluster_runtime.Cluster` (not in-process fakes), so the
    autoscalers' end-to-end tests exercise registration, heartbeats,
    draining and death with no cloud."""

    def __init__(self, cluster, num_cpus_per_node: float = 2.0):
        self._cluster = cluster
        self._num_cpus = num_cpus_per_node
        self._lock = threading.Lock()
        self._seq = 0
        # cloud_id -> {"status", "nodes": [node_id...]}
        self._instances: Dict[str, dict] = {}
        self._gcs_cli = None

    def _gcs(self):
        if self._gcs_cli is None:
            from ..core.rpc import RpcClient

            self._gcs_cli = RpcClient(self._cluster.gcs_sock)
        return self._gcs_cli

    # ----------------------------------------------------------- preemption
    def inject_preemption(self, cloud_id: str, deadline_s: float = 1.0) -> bool:
        """A spot preemption of one instance: the notice lands now (each of
        its nodes goes DRAINING in the GCS and `node_draining` goes out on
        node_events), and the machines die at the deadline. The chaos
        `provider.poll` rule with action `preempt` drives this; tests and
        operators may call it directly."""
        with self._lock:
            rec = self._instances.get(cloud_id)
            if rec is None or rec["status"] != "running":
                return False
            rec["status"] = "preempting"
            nodes = list(rec["nodes"])
        _flight_record("chaos.preempt", (cloud_id, deadline_s))
        for nid in nodes:
            try:
                self._gcs().call("report_preemption", nid, deadline_s,
                                 "spot preemption (injected)")
            except Exception as e:  # noqa: BLE001 - the termination below still happens
                # A lost notice turns the graceful drain into a blunt death.
                _log.warning("preemption notice for %s failed: %r", nid[:12], e)

        def _terminate():
            time.sleep(max(0.0, deadline_s))
            for nid in nodes:
                try:
                    self._cluster.remove_node(nid)
                except Exception:  # lint: swallow-ok(node already gone at preemption deadline)
                    pass
            with self._lock:
                cur = self._instances.get(cloud_id)
                if cur is not None and cur["status"] == "preempting":
                    cur["status"] = "gone"

        threading.Thread(target=_terminate, daemon=True, name="preempt").start()
        return True

    # ------------------------------------------------------------- requests
    def request(self, instance) -> str:
        with self._lock:
            self._seq += 1
            cloud_id = f"local-{self._seq}"
            self._instances[cloud_id] = {"status": "pending", "nodes": [], "labels": {}}
        threading.Thread(target=self._allocate, args=(cloud_id, dict(instance.shape)),
                         daemon=True, name="allocate").start()
        return cloud_id

    def _allocate(self, cloud_id: str, shape: Dict[str, Any]) -> None:
        hosts = max(1, int(shape.get("slice_hosts", 1)))
        cpus = float(shape.get("cpus", self._num_cpus))
        gpus = float(shape.get("gpus", 0.0))
        # Extra custom resources (tests pin work to provider-made nodes).
        extra = {str(k): float(v) for k, v in (shape.get("resources") or {}).items()}
        labels: Dict[str, Any] = {CLOUD_ID_LABEL: cloud_id}
        if hosts > 1:
            labels["slice_name"] = cloud_id
        nodes: List[str] = []
        try:
            for i in range(hosts):
                node_labels = dict(labels)
                if hosts > 1:
                    node_labels["worker_index"] = i
                nodes.append(self._cluster.add_node(
                    num_cpus=cpus, num_gpus=gpus or None, resources=dict(extra),
                    labels=node_labels))
        except Exception:  # noqa: BLE001 - the instance fails as a whole
            # Atomicity: a partial slice is torn down, never reported up.
            for nid in nodes:
                try:
                    self._cluster.remove_node(nid)
                except Exception:
                    pass  # lint: swallow-ok(partial-slice teardown is best-effort per node)
            with self._lock:
                rec = self._instances.get(cloud_id)
                if rec is not None:
                    rec["status"] = "failed"
            return
        with self._lock:
            rec = self._instances.get(cloud_id)
            if rec is not None:
                rec["nodes"] = nodes
                rec["labels"] = labels
                rec["status"] = "running"
        if rec is None:
            # Terminated while allocating: nobody wants these nodes.
            for nid in nodes:
                try:
                    self._cluster.remove_node(nid)
                except Exception:  # lint: swallow-ok(nobody wants these nodes; removal best-effort)
                    pass

    def poll(self) -> Dict[str, str]:
        with self._lock:
            snapshot = {cid: rec["status"] for cid, rec in self._instances.items()}
        for cid, status in snapshot.items():
            # The chaos hook: a `provider.poll` rule with action `preempt`
            # turns a healthy instance into a preemption casualty.
            if status == "running":
                rule = _chaos_inject("provider.poll", cid)
                if rule is not None and rule.action == "preempt":
                    self.inject_preemption(cid, deadline_s=rule.delay_s)
        # In the grace window the machines are still up; the reconciler
        # learns of the loss when their nodes die.
        return {cid: ("running" if st == "preempting" else st) for cid, st in snapshot.items()}

    def ray_node_for(self, cloud_id: str) -> Optional[str]:
        """The alive GCS node labelled with this cloud id (worker 0 of a
        slice), once all of the instance's hosts are in the node table."""
        with self._lock:
            rec = self._instances.get(cloud_id)
            if rec is None or rec["status"] not in ("running", "preempting") or not rec["nodes"]:
                return None
            hosts = len(rec["nodes"])
        mine = [n for n in self._gcs().call("list_nodes")
                if n["Alive"] and (n.get("Labels") or {}).get(CLOUD_ID_LABEL) == cloud_id]
        if len(mine) < hosts:
            return None
        mine.sort(key=lambda n: int((n.get("Labels") or {}).get("worker_index", 0)))
        return mine[0]["NodeID"]

    def node_labels(self, cloud_id: str) -> Dict[str, str]:
        with self._lock:
            rec = self._instances.get(cloud_id)
            return dict(rec["labels"]) if rec else {}

    def terminate(self, cloud_id: str) -> None:
        with self._lock:
            rec = self._instances.pop(cloud_id, None)
        for nid in (rec or {}).get("nodes", ()):
            try:
                self._cluster.remove_node(nid)
            except Exception:  # lint: swallow-ok(terminate of an already-dead node)
                pass
