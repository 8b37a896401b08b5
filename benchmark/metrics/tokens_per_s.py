"""Output tokens generated in the window over its seconds."""
from benchmark.readers import tokens_per_s as read  # noqa: F401
