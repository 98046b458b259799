"""Observability of the port: the flight recorder (always-on per-process
rings, their dumps and crash hooks), structured logs (logs.py), the
anomaly trigger bus and incident bundles (postmortem.py), the Perfetto
trace assembly (perfetto.py), the trainer's goodput ledger and MFU
helpers (goodput.py), and the GCS's metrics history and SLO watchdog
(history.py, watchdog.py). Spans are in ray_tpu_torch/tracing.py; the
sampling profiler in ray_tpu_torch/utils/sampling_profiler.py."""
