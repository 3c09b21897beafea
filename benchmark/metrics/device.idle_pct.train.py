"""Share of the profiled slice in which no operation ran on the device.
Moves train_iter_s."""
from benchmark.readers import idle_pct as read  # noqa: F401
