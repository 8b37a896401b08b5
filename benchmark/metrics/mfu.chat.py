"""Model operations answered in the window over window x bf16 peak (%)."""
from benchmark.readers import mfu_served as read  # noqa: F401
