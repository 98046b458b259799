"""Autoscaler (v1): demand-driven node provisioning (the port of
ray_tpu/autoscaler.py).

Re-design of the reference's autoscaler (reference:
python/ray/autoscaler/v2/autoscaler.py:42, a scheduler over resource
demands; node_provider.py NodeProvider). The loop reads the GCS's task
table and resource view: queued work that the alive nodes' free CPUs cannot
take (under one CPU free in all) for `upscale_delay_s` asks the provider for
a node; a node this autoscaler made that stays idle (every resource free,
no task running on it) for `idle_timeout_s` is released, down to
`min_nodes`.

The provider here is synchronous (`create_node` returns a node id); the
asynchronous contract is autoscaler_v2's. Left out: the JAX package's
TPUSliceProvider / LocalTPUSliceProvider and the gang upscale for pending
SLICE_GANG placement groups (the port's GCS has no SLICE_GANG; ROADMAP).
This module never imports torch.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional


class NodeProvider:
    """(reference: autoscaler/node_provider.py) Maps a provision request to
    a machine."""

    def create_node(self, resources: Dict[str, float]) -> str:
        raise NotImplementedError

    def terminate_node(self, node_id: str) -> None:
        raise NotImplementedError


class LocalNodeProvider(NodeProvider):
    """Adds raylet processes to a local `Cluster` (the test and e2e
    provider)."""

    def __init__(self, cluster, num_cpus_per_node: float = 2.0):
        self._cluster = cluster
        self._num_cpus = num_cpus_per_node

    def create_node(self, resources: Dict[str, float]) -> str:
        res = dict(resources)
        res.setdefault("CPU", self._num_cpus)
        return self._cluster.add_node(resources=res)

    def terminate_node(self, node_id: str) -> None:
        self._cluster.remove_node(node_id)


class Autoscaler:
    """The control loop (reference: autoscaler/v2/autoscaler.py:42)."""

    def __init__(self, provider: NodeProvider, *, min_nodes: int = 1, max_nodes: int = 4,
                 upscale_delay_s: float = 2.0, idle_timeout_s: float = 10.0,
                 interval_s: float = 1.0):
        from .core import runtime_base

        self._rt = runtime_base.current_runtime()
        self._provider = provider
        self.min_nodes = min_nodes
        self.max_nodes = max_nodes
        self.upscale_delay_s = upscale_delay_s
        self.idle_timeout_s = idle_timeout_s
        self.interval_s = interval_s
        self._managed: List[str] = []  # nodes this autoscaler created
        self._idle_since: Dict[str, float] = {}
        self._demand_since: Optional[float] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.num_upscales = 0
        self.num_downscales = 0

    # ------------------------------------------------------------ control
    def start(self) -> None:
        self._thread = threading.Thread(target=self._loop, daemon=True, name="autoscaler")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.step()
            except Exception:  # noqa: BLE001 - retried next tick, but said
                from .observability.logs import get_logger

                get_logger("autoscaler").warning("autoscaler step failed", exc_info=True)

    # -------------------------------------------------------------- logic
    def step(self) -> None:
        gcs = self._rt._gcs
        alive = [n for n in gcs.call("list_nodes") if n["Alive"]]
        tasks = gcs.call("list_tasks", 2000)
        queued = [t for t in tasks if t["state"] == "QUEUED"]
        running_nodes = {t.get("node") for t in tasks
                         if t["state"] == "RUNNING" and t.get("node")}

        # Upscale: a queue that the free capacity cannot absorb, sustained.
        total_free: Dict[str, float] = {}
        for n in alive:
            for k, v in n["Available"].items():
                total_free[k] = total_free.get(k, 0.0) + v
        starved = len(queued) > 0 and total_free.get("CPU", 0.0) < 1.0
        now = time.monotonic()
        if starved:
            if self._demand_since is None:
                self._demand_since = now
            elif now - self._demand_since >= self.upscale_delay_s:
                if len(alive) < self.max_nodes:
                    self._managed.append(self._provider.create_node({}))
                    self.num_upscales += 1
                self._demand_since = None
        else:
            self._demand_since = None

        # Downscale: managed nodes idle past the timeout.
        for n in alive:
            nid = n["NodeID"]
            if nid not in self._managed:
                continue
            fully_free = all(abs(n["Available"].get(k, 0.0) - v) < 1e-9
                             for k, v in n["Resources"].items())
            if not (fully_free and nid not in running_nodes):
                self._idle_since.pop(nid, None)
                continue
            first = self._idle_since.setdefault(nid, now)
            if now - first >= self.idle_timeout_s and len(alive) > self.min_nodes:
                self._provider.terminate_node(nid)
                self._managed.remove(nid)
                self._idle_since.pop(nid, None)
                self.num_downscales += 1
                alive = [m for m in alive if m["NodeID"] != nid]
