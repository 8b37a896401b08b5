"""Median gap between tokens (ms): (last − first) / (tokens − 1), device
ends, over the requests whose last token fell in the window."""
from benchmark.program_spans import token_gap_ms as read  # noqa: F401
