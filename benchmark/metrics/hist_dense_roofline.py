"""The dense histogram step's least time (work/counts.py) over the device
time of kernels/hist_dense/'s kernels, in the profiled slice.  Moves
train_iter_s."""
from benchmark.readers import roofline_pct


def read(run):
    return roofline_pct(run, "hist_dense")
