"""Host seconds of the run's Dataset constructs (train and valid) in the
program's `dataset.store` phase: the binned store. Moves setup_s."""
from benchmark.phases import dataset_s


def read(run):
    return dataset_s("store")
