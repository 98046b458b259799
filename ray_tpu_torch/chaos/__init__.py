"""Fault injection for recovery tests (ray_tpu/chaos for the PyTorch port):
see chaos/controller.py for the rule schema and the injection points, and
chaos/net.py for control-plane partitions (`partition`)."""

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
from .net import Partition, partition  # noqa: F401,E402
