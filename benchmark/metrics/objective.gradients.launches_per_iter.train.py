"""Kernel launches an iteration of the profiled slice, begun while
`lgbt::boosting` is the innermost program range (benchmark/phases.py).
Moves train_iter_s."""
from benchmark.phases import launches_per_iter


def read(run):
    return launches_per_iter(run, "objective.gradients")
