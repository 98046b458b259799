"""Observability of the port: the flight recorder (always-on per-process
rings, their dumps and crash hooks), structured logs (logs.py), the
anomaly trigger bus and incident bundles (postmortem.py), the Perfetto
trace assembly (perfetto.py), and the trainer's goodput ledger and MFU
helpers (goodput.py). Spans are in ray_tpu_torch/tracing.py."""
