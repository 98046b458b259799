"""AIR-layer shared execution utilities (reference: python/ray/air/)."""

from .execution import ActorManager, TrackedActor  # noqa: F401
