"""Share of the profiled slice in which the device idles under none of
the seven phases of benchmark/phases.py. Moves train_iter_s."""
from benchmark.phases import unattributed_idle_pct as read  # noqa: F401
