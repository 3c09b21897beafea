"""Host seconds of the run's Dataset constructs (train and valid) in the
program's `dataset.binning` phase: mappers and bundle plan. Moves
setup_s."""
from benchmark.phases import dataset_s


def read(run):
    return dataset_s("binning")
