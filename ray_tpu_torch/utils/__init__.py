"""Runtime utilities of the port (utils/internal_metrics.py)."""
