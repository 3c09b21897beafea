"""The control of `correct` on the card, at a size a test run holds:
the program as configured comes out correct, and the program with its
configuration's `control_params` (the nearest precision below the one it
states) comes out not correct.  Run on a GPU with
`python -m pytest -m cuda benchmark/tests/test_bench_control_cuda.py`;
the cells' own sizes run through `python3 -m benchmark.control`."""
import pytest
import torch

from benchmark import run, spec

SIZES = {"higgs.train": {"rows": 1_000_000, "valid_rows": 50_000}}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the program's kernels run only "
                    "on the card")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(SIZES))
def test_sound_correct_and_control_not(cell, cuda):
    bench = spec.load()
    lower = spec.config(bench, spec.cell(bench, cell))["control_params"]
    sound = run.run_cell(cell, 2 ** 31 + 7, 2.0, False, device=cuda,
                         sizes=SIZES[cell])
    assert sound["correct"], sound["checks"]
    ctl = run.run_cell(cell, 2 ** 31 + 7, 2.0, False, device=cuda,
                       sizes=SIZES[cell], params=lower)
    assert not ctl["correct"], ctl["checks"]
