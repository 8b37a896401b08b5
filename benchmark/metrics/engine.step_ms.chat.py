"""The window over the engine's decode and mixed steps in it (ms)."""
from benchmark.readers import step_ms as read  # noqa: F401
