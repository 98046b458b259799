"""Fault injection for recovery tests (ray_tpu/chaos for the PyTorch port):
see chaos/controller.py for the rule schema and the injection points."""

from .controller import (  # noqa: F401
    ENV_VAR,
    POINTS,
    SEED_ENV,
    ChaosController,
    ChaosRule,
    configure,
    controller,
    disable,
    enabled,
    kill_now,
    maybe_inject,
)
