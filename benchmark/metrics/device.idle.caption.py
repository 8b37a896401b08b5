"""Share of the traced window with no kernel running (%)."""
from benchmark.readers import device_idle as read  # noqa: F401
