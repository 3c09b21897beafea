"""The benchmark of lightgbm_tpu_torch on NVIDIA GPUs.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Everything a cell needs is found by name from the repository's
BENCHMARK.json: the configuration in configs/<name>.json (its sizes,
parameters, limits and the generator in generators/ that makes its
data), the traffic in traffic/<name>.json (its parameters and the loop
in loops/ that drives its window), each metric's reader in
metrics/<metric>.py, the kernels of a roofline's step in
kernels/<step>/*.json, and the work counts and peaks in work/.  The plain
reference that decides `correct` lives in reference/ and imports nothing
of the program.
"""
