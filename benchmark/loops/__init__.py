"""Window loops, one module a kind of traffic, named by a traffic file's
`loop` key.  Each has

    run(cfg, traffic, seed, seconds, trace, device, params, t0) -> Run

which does a cell's set-up (marking `setup_s` from `t0` as its window
opens), drives the window for `seconds`, profiles a slice after it when
`trace` is set, reads the device's peak memory, and then, with the
program's state freed, works out the numbers `correct` compares against
the plain reference.  `params` are laid over the configuration's.  The
Run it returns carries what benchmark/run.py prints and what the metric
readers of metrics/ read.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

from ..trace import Trace


@dataclass
class Run:
    setup_s: float = 0.0
    attempted: int = 0
    failed: int = 0
    memory_peak_bytes: int = 0
    # name -> the number compared (its limit is the configuration's)
    checks: Dict[str, float] = field(default_factory=dict)
    # the profiled slice (--trace 1): its trace and wall seconds
    trace: Optional[Trace] = None
    slice_s: float = 0.0
