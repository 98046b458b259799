"""Placement groups: gang reservation of resource bundles (copy of
ray_tpu/core/placement_group.py for the PyTorch port).

API analogue of the reference's placement groups
(reference: python/ray/util/placement_group.py:145, bundle policies at
src/ray/raylet/scheduling/policy/bundle_scheduling_policy.h). Strategies:
PACK, SPREAD, STRICT_PACK, STRICT_SPREAD, plus the TPU-native addition
SLICE_GANG — one bundle per host of a pod slice, leased atomically
(replaces the reference's TPU-{pod}-head custom-resource idiom,
python/ray/_private/accelerators/tpu.py:334-397).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

STRATEGIES = ("PACK", "SPREAD", "STRICT_PACK", "STRICT_SPREAD", "SLICE_GANG")


@dataclass
class PlacementGroupHandle:
    id_hex: str
    bundles: List[Dict[str, float]]
    strategy: str = "PACK"
    name: str = ""
    # bundle_index -> node_id, filled once scheduled
    bundle_placements: Dict[int, str] = field(default_factory=dict)

    @property
    def bundle_count(self) -> int:
        return len(self.bundles)

    def ready(self, timeout: Optional[float] = None) -> bool:
        from .runtime_base import current_runtime

        rt = current_runtime()
        ok = rt.placement_group_ready(self.id_hex, timeout=timeout)
        if ok and not self.bundle_placements:
            # PENDING at creation (async placement): pick up the bundle
            # node assignments now that the group is placed.
            info = rt.placement_group_table().get(self.id_hex)
            if info:
                self.bundle_placements = dict(enumerate(info.get("placements", [])))
        return ok

    def wait(self, timeout_seconds: Optional[float] = None) -> bool:
        return self.ready(timeout=timeout_seconds)

    def __repr__(self):
        return f"PlacementGroup({self.id_hex[:12]}, {self.strategy}, {len(self.bundles)} bundles)"


def placement_group(
    bundles: List[Dict[str, float]],
    strategy: str = "PACK",
    name: str = "",
) -> PlacementGroupHandle:
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown strategy {strategy!r}; expected one of {STRATEGIES}")
    if not bundles or any(not b for b in bundles):
        raise ValueError("bundles must be a non-empty list of non-empty dicts")
    from .runtime_base import current_runtime

    return current_runtime().create_placement_group(bundles, strategy, name)


def remove_placement_group(pg: PlacementGroupHandle) -> None:
    from .runtime_base import current_runtime

    current_runtime().remove_placement_group(pg.id_hex)


@dataclass
class PlacementGroupSchedulingStrategy:
    """Mirror of the reference's scheduling_strategies.PlacementGroupSchedulingStrategy
    (reference: python/ray/util/scheduling_strategies.py)."""

    placement_group: PlacementGroupHandle
    placement_group_bundle_index: int = -1
    placement_group_capture_child_tasks: bool = False


@dataclass
class NodeAffinitySchedulingStrategy:
    """Pin a task/actor to a specific node (reference:
    python/ray/util/scheduling_strategies.py NodeAffinitySchedulingStrategy).
    hard (soft=False): fail the task if the node is gone; soft=True: fall
    back to default placement."""

    node_id: str
    soft: bool = False


def encode_node_affinity(node_id: str, soft: bool) -> str:
    """Wire form of NodeAffinity carried in SchedulingOptions — the single
    source of truth for the format (decoded by the raylet and GCS)."""
    return f"NODE:{node_id}:{'soft' if soft else 'hard'}"


def decode_node_affinity(strategy: str):
    """Returns (node_id, soft) or None when the strategy isn't NodeAffinity."""
    if not strategy or not strategy.startswith("NODE:"):
        return None
    _, node_id, softness = strategy.split(":", 2)
    return node_id, softness == "soft"
