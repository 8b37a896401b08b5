"""Mean slots in use at the engine's step entries in the window."""
from benchmark.readers import rows_per_step as read  # noqa: F401
