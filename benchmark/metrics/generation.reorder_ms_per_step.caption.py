"""Median, over the window's batches (beam searches started in it), of the
cache reorders' device ms over their count (ms a step)."""
from benchmark.program_spans import reorder_ms_per_step as read  # noqa: F401
