"""Median time to first token (ms): admitted → the device end of the step
that made it, over the requests admitted in the window."""
from benchmark.program_spans import first_token_ms as read  # noqa: F401
