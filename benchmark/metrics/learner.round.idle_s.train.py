"""Device idle seconds an iteration of the profiled slice while
`lgbt::learner.round` is the innermost program range
(benchmark/phases.py). Moves train_iter_s."""
from benchmark.phases import idle_s


def read(run):
    return idle_s(run, "learner.round")
