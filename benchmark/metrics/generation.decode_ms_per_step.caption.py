"""Median of each batch's decode time over its decode steps (ms)."""
from benchmark.readers import decode_ms_per_step as read  # noqa: F401
