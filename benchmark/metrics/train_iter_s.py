"""Seconds a boosting iteration on the dense store: the window over the
iterations it completed."""
from benchmark.readers import iter_s as read  # noqa: F401
