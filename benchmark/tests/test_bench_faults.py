"""The whole run of a cell, small and on the CPU, with the timed path
broken underneath: each fault has to turn `correct` false, and the
unbroken program has to keep it true.  The faults are benchmark/faults.py's;
the look for a card is the only step of a run these skip."""
import numpy as np
import pytest

from benchmark import run
from benchmark.faults import FAULTS

# each cell at a size the CPU runs in seconds
SIZES = {"higgs.train": {"rows": 6000, "valid_rows": 1000}}
CELLS = sorted(SIZES)


def _run(cell):
    return run.run_cell(cell, 2 ** 31 + 99, 0.5, False, device="cpu",
                        sizes=SIZES[cell])


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    r = _run(cell)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1
    assert all(m["value"] > 0 for m in r["metrics"].values())


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_turns_correct_false(fault, cell, monkeypatch):
    FAULTS[fault](monkeypatch)
    r = _run(cell)
    assert not r["correct"], r["checks"]
    assert any(v["value"] > v["limit"] for v in r["checks"].values())
    assert np.isfinite([v["value"] for v in r["checks"].values()]).all()
