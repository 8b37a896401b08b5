"""Median host image preprocessing and upload per batch (ms), over the
batches whose preprocessing started in the window."""
from benchmark.program_spans import preprocess_ms as read  # noqa: F401
