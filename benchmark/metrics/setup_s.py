"""Set-up seconds: process start to the window's first iteration (data,
Datasets, warm-up job). Moves itself."""
from benchmark.readers import setup_s as read  # noqa: F401
