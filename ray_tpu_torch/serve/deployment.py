"""Deployment definition API (copy of ray_tpu/serve/deployment.py for the
PyTorch port).

Re-design of the reference's serve deployment surface (reference:
python/ray/serve/api.py:246 @serve.deployment, deployment.py:64
Deployment). A Deployment is a declarative spec (class + config); binding
arguments produces an Application that `serve.run` materializes via the
controller.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple


@dataclasses.dataclass
class AutoscalingConfig:
    """(reference: python/ray/serve/config.py AutoscalingConfig)"""

    min_replicas: int = 1
    max_replicas: int = 4
    target_ongoing_requests: float = 2.0
    upscale_delay_s: float = 0.5
    downscale_delay_s: float = 2.0


@dataclasses.dataclass
class DeploymentConfig:
    num_replicas: int = 1
    max_ongoing_requests: int = 8
    autoscaling_config: Optional[AutoscalingConfig] = None
    ray_actor_options: Dict[str, Any] = dataclasses.field(default_factory=dict)


class Deployment:
    """(reference: python/ray/serve/deployment.py:64)"""

    def __init__(self, func_or_class: Any, name: str, config: DeploymentConfig):
        self.func_or_class = func_or_class
        self.name = name
        self.config = config

    def options(self, **kwargs) -> "Deployment":
        cfg = dataclasses.replace(self.config)
        name = kwargs.pop("name", self.name)
        for k, v in kwargs.items():
            if not hasattr(cfg, k):
                raise ValueError(f"unknown deployment option {k!r}")
            setattr(cfg, k, v)
        return Deployment(self.func_or_class, name, cfg)

    def bind(self, *args, **kwargs) -> "Application":
        return Application(self, args, kwargs)

    def __repr__(self):
        return f"Deployment({self.name}, replicas={self.config.num_replicas})"


@dataclasses.dataclass
class Application:
    """A deployment bound to its constructor args (reference:
    serve's built-app DAG node; single-deployment apps here)."""

    deployment: Deployment
    init_args: Tuple[Any, ...]
    init_kwargs: Dict[str, Any]


def deployment(
    _func_or_class: Optional[Any] = None,
    *,
    name: Optional[str] = None,
    num_replicas: int = 1,
    max_ongoing_requests: int = 8,
    autoscaling_config: Optional[Dict[str, Any] | AutoscalingConfig] = None,
    ray_actor_options: Optional[Dict[str, Any]] = None,
):
    """@serve.deployment (reference: python/ray/serve/api.py:246)."""

    def wrap(target):
        asc = autoscaling_config
        if isinstance(asc, dict):
            asc = AutoscalingConfig(**asc)
        cfg = DeploymentConfig(
            num_replicas=num_replicas,
            max_ongoing_requests=max_ongoing_requests,
            autoscaling_config=asc,
            ray_actor_options=dict(ray_actor_options or {}),
        )
        return Deployment(target, name or target.__name__, cfg)

    if _func_or_class is not None:
        return wrap(_func_or_class)
    return wrap
