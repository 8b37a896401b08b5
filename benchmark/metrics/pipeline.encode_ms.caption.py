"""Median of each batch's encode time (the runner's last_stats, ms)."""
from benchmark.readers import encode_ms as read  # noqa: F401
