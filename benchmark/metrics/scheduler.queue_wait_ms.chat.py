"""Median queue wait (ms): queued → admitted, over the requests the serving
helper admitted in the window (the program's "request" records)."""
from benchmark.program_spans import queue_wait_ms as read  # noqa: F401
