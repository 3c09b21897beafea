"""The whole iteration's least time (work/counts.py, bandwidth-bound) over
the window's time an iteration. Moves train_iter_s."""
from benchmark.readers import mfu_pct as read  # noqa: F401
