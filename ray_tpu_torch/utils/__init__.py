"""Runtime utilities of the port: the `raytpu_*` catalog
(internal_metrics), user metrics, pubsub channels, the state API, node
events, ActorPool and the distributed Queue.

Loaded on first use (PEP 562): the GCS and raylet daemons import
`utils.internal_metrics` and `utils.config` and must not pull in the API
that ActorPool and Queue stand on.
"""

import importlib

__all__ = ["state", "ActorPool", "Queue", "Empty", "Full", "metrics", "internal_metrics",
           "pubsub"]

_ATTRS = {"ActorPool": "actor_pool", "Queue": "queue", "Empty": "queue", "Full": "queue"}
_MODULES = {"state", "metrics", "internal_metrics", "pubsub", "config", "node_events",
            "actor_pool", "queue"}


def __getattr__(name):
    if name in _ATTRS:
        return getattr(importlib.import_module(f".{_ATTRS[name]}", __name__), name)
    if name in _MODULES:
        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
