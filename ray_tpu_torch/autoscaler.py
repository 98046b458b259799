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

A pending SLICE_GANG placement group is slice-shaped demand: with a
GPUSliceProvider (the counterpart of the JAX package's TPUSliceProvider)
the loop asks for a whole slice, one host per bundle, all labelled with one
`slice_name` and their `worker_index` or none at all, after the gang has
waited `upscale_delay_s`, and nudges the GCS to place the gang at once. A
gang still pending `gang_reprovision_s` after its slice was asked for (a
host died while the slice came up) gets another.

The provider here is synchronous (`create_node` returns a node id); the
asynchronous contract is autoscaler_v2's. This module never imports torch.
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


class GPUSliceProvider(NodeProvider):
    """A provider that can also allocate a whole GPU slice (the hosts of one
    NVLink domain) at once: one node per host, every one labelled with the
    slice's name and its index, all up or none (the counterpart of the JAX
    package's TPUSliceProvider; reference: the slice-atomic provisioning the
    TPU-{pod}-head idiom approximates, accelerators/tpu.py:334-397)."""

    def create_slice(self, num_hosts: int, gpus_per_host: float,
                     cpus_per_host: float = 2.0) -> List[str]:
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


class LocalGPUSliceProvider(LocalNodeProvider, GPUSliceProvider):
    """Slices of raylets on this machine, over a local `Cluster` (reference:
    autoscaler/_private/fake_multi_node/node_provider.py:236). Nodes on one
    machine lease the same device ids, so the hosts of a slice share its
    cards."""

    def __init__(self, cluster, num_cpus_per_node: float = 2.0):
        super().__init__(cluster, num_cpus_per_node)
        self._slice_seq = 0

    def create_slice(self, num_hosts: int, gpus_per_host: float,
                     cpus_per_host: float = 2.0) -> List[str]:
        self._slice_seq += 1
        slice_name = f"local-slice-{self._slice_seq}"
        nodes: List[str] = []
        try:
            for i in range(num_hosts):
                nodes.append(self._cluster.add_node(
                    num_cpus=cpus_per_host, num_gpus=gpus_per_host or None,
                    labels={"slice_name": slice_name, "worker_index": i}))
        except Exception:
            # All or none: a partial slice is of no use to a gang.
            for nid in nodes:
                try:
                    self.terminate_node(nid)
                # lint: swallow-ok(partial-slice teardown best-effort; original error re-raised)
                except Exception:
                    pass
            raise
        return nodes


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
        self._gang_demand_since: Dict[str, float] = {}
        # pg id -> when its slice was asked for: a gang still pending long
        # after (a host died while the slice came up) gets another; pruned
        # once the gang is placed or gone.
        self._gangs_provisioned: Dict[str, float] = {}
        self.gang_reprovision_s = 60.0
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

        # Gang upscale: a pending SLICE_GANG needs a whole slice (reference:
        # the autoscaler state service reading placement-group demand,
        # gcs_autoscaler_state_manager.h:30).
        if isinstance(self._provider, GPUSliceProvider):
            self._upscale_gangs(gcs, alive, now)

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

    def _upscale_gangs(self, gcs, alive: List[dict], now: float) -> None:
        try:
            pgs = gcs.call("placement_group_table")
        except Exception:  # noqa: BLE001 - the next tick reads it again
            pgs = {}
        for stale in [g for g in self._gangs_provisioned
                      if g not in pgs or pgs[g].get("state") != "PENDING"]:
            self._gangs_provisioned.pop(stale, None)
        for pg_id, pg in pgs.items():
            if pg.get("state") != "PENDING" or pg.get("strategy") != "SLICE_GANG":
                self._gang_demand_since.pop(pg_id, None)
                continue
            asked = self._gangs_provisioned.get(pg_id)
            if asked is not None and now - asked < self.gang_reprovision_s:
                continue  # its slice is on the way
            if now - self._gang_demand_since.setdefault(pg_id, now) < self.upscale_delay_s:
                continue
            bundles = pg.get("bundles") or []
            if len(alive) + len(bundles) > self.max_nodes:
                continue
            gpus = max((b.get("GPU", 0.0) for b in bundles), default=0.0)
            cpus = max((b.get("CPU", 1.0) for b in bundles), default=1.0)
            self._managed.extend(self._provider.create_slice(len(bundles), gpus,
                                                             cpus_per_host=max(1.0, cpus)))
            self._gangs_provisioned[pg_id] = now
            self.num_upscales += 1
            try:
                # Place it now; the waiter's ready() poll would get there too.
                gcs.call("retry_pending_placement_group", pg_id)
            except Exception:  # lint: swallow-ok(advisory nudge; waiter poll gets there anyway)
                pass
