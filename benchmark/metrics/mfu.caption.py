"""Model operations of the window's batches over window x bf16 peak (%)."""
from benchmark.readers import mfu_caption as read  # noqa: F401
