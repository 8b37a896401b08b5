"""Images captioned over the seconds of the window's whole batches."""
from benchmark.readers import images_per_s as read  # noqa: F401
