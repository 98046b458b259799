"""Serve for the PyTorch port (ray_tpu/serve): the controller and its
replica actors, power-of-two-choices handles, request batching and model
multiplexing, on both runtimes; the HTTP proxy (`serve.run(...,
http_port=)`, `start_proxy`), the gRPC ingress (serve.grpc_proxy) and the
channel-fed FeatureTable (serve.ingest); and serve.llm, the LLM engine as a
deployment with its channel feed."""

from .api import delete, get_app_handle, run, shutdown
from .batching import batch, get_multiplexed_model_id, multiplexed
from .deployment import Application, AutoscalingConfig, Deployment, DeploymentConfig, deployment
from .handle import DeploymentHandle, DeploymentResponse, start_proxy, stop_proxy
from .ingest import FeatureTable

__all__ = [
    "Application", "AutoscalingConfig", "Deployment", "DeploymentConfig",
    "DeploymentHandle", "DeploymentResponse", "FeatureTable", "batch",
    "delete", "deployment", "get_app_handle", "get_multiplexed_model_id",
    "llm", "multiplexed", "run", "shutdown", "start_proxy", "stop_proxy",
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
