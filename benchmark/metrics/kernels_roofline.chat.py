"""Bounds of the counted kernel calls over their device time (%)."""
from benchmark.readers import kernels_roofline as read  # noqa: F401
