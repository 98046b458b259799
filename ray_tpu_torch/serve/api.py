"""serve.run / serve.delete / serve.shutdown — the user entrypoints
(copy of ray_tpu/serve/api.py for the PyTorch port; reference:
python/ray/serve/api.py serve.run)."""

from __future__ import annotations

from typing import Any, Optional, Union

from .. import api as core_api
from .controller import get_or_create_controller
from .deployment import Application, Deployment
from .handle import DeploymentHandle


def run(
    target: Union[Application, Deployment],
    *,
    name: str = "default",
    blocking: bool = False,
    http_port: Optional[int] = None,
) -> DeploymentHandle:
    """Deploys an application and returns its handle
    (reference: serve/api.py serve.run). The HTTP proxy is not ported:
    `http_port` must stay None."""
    if http_port is not None:
        raise NotImplementedError(
            "the HTTP proxy is not ported; call the returned handle, or an LLM "
            "app's LLMClient feed, with http_port=None"
        )
    if isinstance(target, Deployment):
        target = target.bind()
    if not isinstance(target, Application):
        raise TypeError("serve.run expects a Deployment or bound Application")

    if not core_api.is_initialized():
        core_api.init(local_mode=True)
    controller = get_or_create_controller()
    _deploy_application(controller, target, name)
    return DeploymentHandle(name)


def _deploy_application(controller, app: Application, name: str, _seen=None) -> None:
    """Deploys an application, recursively deploying bound inner
    applications found in its init args and replacing them with
    DeploymentHandles — deployment composition (reference: serve's
    multi-deployment apps, `Outer.bind(Inner.bind())`; the inner DAG node
    resolves to a handle inside the outer replica,
    python/ray/serve/_private/build_app.py). A shared inner Application
    bound into multiple slots deploys ONCE (like the reference's shared
    DAG nodes); inner app names are recorded as children so delete()
    cascades."""
    seen: dict = {} if _seen is None else _seen  # id(Application) -> name
    children: list = []

    def resolve(value, slot: str):
        if isinstance(value, Application):
            inner_name = seen.get(id(value))
            if inner_name is None:
                inner_name = f"{name}-{value.deployment.name}-{slot}"
                seen[id(value)] = inner_name
                _deploy_application(controller, value, inner_name, seen)
                children.append(inner_name)
            return DeploymentHandle(inner_name)
        # Applications nested in containers must resolve too.
        if isinstance(value, list):
            return [resolve(v, f"{slot}.{i}") for i, v in enumerate(value)]
        if isinstance(value, tuple):
            return tuple(resolve(v, f"{slot}.{i}") for i, v in enumerate(value))
        if isinstance(value, dict):
            return {k: resolve(v, f"{slot}.{k}") for k, v in value.items()}
        return value

    init_args = tuple(resolve(a, f"a{i}") for i, a in enumerate(app.init_args))
    init_kwargs = {k: resolve(v, k) for k, v in app.init_kwargs.items()}
    dep = app.deployment
    asc = dep.config.autoscaling_config
    core_api.get(
        controller.deploy.remote(
            name,
            dep.func_or_class,
            init_args,
            init_kwargs,
            dep.config.num_replicas,
            dep.config.max_ongoing_requests,
            asc.__dict__ if asc else None,
            dep.config.ray_actor_options,
            children,
        )
    )


def get_app_handle(name: str = "default") -> DeploymentHandle:
    return DeploymentHandle(name)


def delete(name: str = "default") -> None:
    controller = get_or_create_controller()
    core_api.get(controller.delete_app.remote(name))


def shutdown() -> None:
    try:
        controller = core_api.get_actor("__serve_controller__")
        core_api.get(controller.shutdown.remote())
        core_api.kill(controller)
    except Exception:  # lint: swallow-ok(no controller running; shutdown is idempotent)
        pass
