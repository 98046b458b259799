"""Observability of the port: the flight recorder (always-on per-process
rings, their dumps and crash hooks), structured logs (logs.py), the
anomaly trigger bus and incident bundles (postmortem.py), the Perfetto
trace assembly (perfetto.py), the trainer's goodput ledger and MFU
helpers (goodput.py), and the GCS's metrics history and SLO watchdog
(history.py, watchdog.py). Spans are in ray_tpu_torch/tracing.py; the
sampling profiler in ray_tpu_torch/utils/sampling_profiler.py. The package
re-exports the JAX package's names; every module here imports only the
standard library, so the daemons that import the flight recorder stay
free of torch."""

from .. import tracing  # noqa: F401  (re-export: the span half)
from .flight_recorder import (  # noqa: F401
    RECORDER,
    FlightRecorder,
    dump,
    flight_dir,
    install_crash_hooks,
    record,
)
from .goodput import GoodputAccountant  # noqa: F401
from .history import MetricsHistory, merge_series  # noqa: F401
from .perfetto import build_trace, export  # noqa: F401
from .watchdog import Rule, Watchdog  # noqa: F401

__all__ = [
    "tracing",
    "FlightRecorder",
    "RECORDER",
    "record",
    "dump",
    "flight_dir",
    "install_crash_hooks",
    "build_trace",
    "export",
    "MetricsHistory",
    "merge_series",
    "Watchdog",
    "Rule",
    "GoodputAccountant",
]
