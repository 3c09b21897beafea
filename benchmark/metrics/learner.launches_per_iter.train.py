"""Device kernels an iteration in the profiled slice. Moves train_iter_s."""
from benchmark.readers import launches_per_iter as read  # noqa: F401
