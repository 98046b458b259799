"""Observability of the port: the flight recorder's `record` that
core/channel.py and the chaos controller stamp events into."""
