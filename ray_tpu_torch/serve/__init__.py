"""Serve for the PyTorch port (ray_tpu/serve): the controller and its
replica actors, power-of-two-choices handles, request batching and model
multiplexing, on the in-process runtime; and serve.llm, the LLM engine as
a deployment with its channel feed. The HTTP and gRPC proxies and the
feature-table ingest are not ported yet."""

from .api import delete, get_app_handle, run, shutdown
from .batching import batch, get_multiplexed_model_id, multiplexed
from .deployment import Application, AutoscalingConfig, Deployment, DeploymentConfig, deployment
from .handle import DeploymentHandle, DeploymentResponse

__all__ = [
    "Application", "AutoscalingConfig", "Deployment", "DeploymentConfig",
    "DeploymentHandle", "DeploymentResponse", "batch", "delete", "deployment",
    "get_app_handle", "get_multiplexed_model_id", "llm", "multiplexed", "run",
    "shutdown",
]


def __getattr__(name):
    # serve.llm loads lazily (PEP 562): it pulls in the model stack, which
    # plain request/response serve users should not pay for at import.
    if name == "llm":
        import importlib

        mod = importlib.import_module(".llm", __name__)
        globals()["llm"] = mod
        return mod
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
