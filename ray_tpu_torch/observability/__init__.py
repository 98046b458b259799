"""Observability of the port: the flight recorder's `record` that
core/channel.py, the chaos controller and the trainer stamp events into,
and the trainer's goodput ledger and MFU helpers (goodput.py)."""
