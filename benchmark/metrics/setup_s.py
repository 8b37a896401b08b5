"""Set-up: process start to the window's first measured request (s)."""
from benchmark.readers import setup_s as read  # noqa: F401
