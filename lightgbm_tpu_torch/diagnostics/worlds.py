"""Run a world of rank processes on one host, and hold a mesh model
against the one-rank model.

`run_world` starts one process for each command line, polls them, and
returns each one's output once every one has exited 0.  When any
process exits non-zero, or the world runs past its time limit, every
process still running is killed and `WorldFailed` carries the tail of
every rank's output: a hung rank never outlives the limit.

`compare_models` holds a model string trained on a mesh against one
trained by one rank: bitwise where the histograms are integer sums,
else every tree's structure equal and its float lines within rtol 1e-4,
atol 1e-6, where a structure that parts must part first at an f32 gain
tie.
"""
from __future__ import annotations

import os
import subprocess
import tempfile
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

# the model lines that carry floats a float32 exchange may round
FLOAT_LINES = ("split_gain", "leaf_value", "internal_value")


class WorldFailed(RuntimeError):
    """A rank exited non-zero, or the world ran past its limit."""


def run_world(argvs: Sequence[Sequence[str]], *, timeout: float,
              env: Optional[Dict[str, str]] = None,
              log_dir: Optional[str] = None, name: str = "world",
              tail: int = 3000) -> List[str]:
    """Start one process for each command line of `argvs` (rank r runs
    argvs[r]) with `env`, and wait for all of them; returns each rank's
    output (stdout and stderr together).  Logs go to `log_dir` (a
    temporary directory when None)."""
    with tempfile.TemporaryDirectory() as tmp:
        d = log_dir or tmp
        logs = [open(os.path.join(d, f"{name}_rank{r}.log"), "w+")
                for r in range(len(argvs))]
        procs = []
        failed = None
        try:
            for r, argv in enumerate(argvs):
                procs.append(subprocess.Popen(
                    list(argv), stdout=logs[r], stderr=subprocess.STDOUT,
                    env=env))
            deadline = time.monotonic() + timeout
            while any(p.poll() is None for p in procs):
                bad = [r for r, p in enumerate(procs)
                       if p.returncode not in (None, 0)]
                if bad:
                    failed = f"rank {bad[0]} exited {procs[bad[0]].returncode}"
                    break
                if time.monotonic() > deadline:
                    failed = f"the world ran past its {timeout:.0f} s limit"
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        texts = []
        for f in logs:
            f.seek(0)
            texts.append(f.read())
            f.close()
    if failed is None and any(p.returncode != 0 for p in procs):
        failed = "a rank exited non-zero"
    if failed is not None:
        raise WorldFailed(f"{name}: {failed}\n" + "\n".join(
            f"--- rank {r} (rc {p.returncode}) ---\n{t[-tail:]}"
            for r, (p, t) in enumerate(zip(procs, texts))))
    return texts


def first_split_difference(ta, tb) -> Optional[int]:
    """The first node whose split or children differ between two host
    trees, else None."""
    n = min(ta.num_leaves, tb.num_leaves) - 1
    for i in range(n):
        if ((ta.split_feature[i], ta.threshold_in_bin[i], ta.left_child[i],
             ta.right_child[i])
                != (tb.split_feature[i], tb.threshold_in_bin[i],
                    tb.left_child[i], tb.right_child[i])):
            return i
    return None if ta.num_leaves == tb.num_leaves else n


def compare_models(ref: str, got: str, exact: bool) -> str:
    """How model string `got` holds against `ref`: "bitwise", "within
    tolerance" (every tree's structure equal, float lines within rtol
    1e-4, atol 1e-6), or "parted at tree t ..." when the first
    difference of structure is a split whose gains are an f32 tie
    (within 1e-5 relative).  Raises ValueError otherwise, and whenever
    `exact` and the strings differ."""
    from ..basic import Booster
    if got == ref:
        return "bitwise"
    a, b = ref.splitlines(), got.splitlines()
    if exact:
        first = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                     min(len(a), len(b)))
        raise ValueError(f"the model is not the reference bitwise; line "
                         f"{first}: {a[first:first + 1]} / "
                         f"{b[first:first + 1]}")
    ta, tb = (Booster(model_str=s)._gbdt.models for s in (ref, got))
    if len(ta) != len(tb):
        raise ValueError(f"{len(tb)} trees against {len(ta)}")
    for t, (x, y) in enumerate(zip(ta, tb)):
        i = first_split_difference(x, y)
        if i is None:
            continue
        ga, gb = float(x.split_gain[i]), float(y.split_gain[i])
        where = (f"tree {t} node {i}: reference (feature "
                 f"{x.split_feature[i]}, bin {x.threshold_in_bin[i]}, gain "
                 f"{ga!r}) vs (feature {y.split_feature[i]}, bin "
                 f"{y.threshold_in_bin[i]}, gain {gb!r})")
        if abs(ga - gb) > 1e-5 * max(abs(ga), abs(gb)):
            raise ValueError(f"another tree grew at {where}")
        return f"parted at {where}, an f32 gain tie"
    if len(a) != len(b):
        raise ValueError(f"{len(b)} model lines against {len(a)}")
    for x, y in zip(a, b):
        if x == y:
            continue
        key = x.split("=", 1)[0]
        if key not in FLOAT_LINES:
            raise ValueError(f"structural line differs: {x!r} / {y!r}")
        va = np.array(x.split("=", 1)[1].split(), np.float64)
        vb = np.array(y.split("=", 1)[1].split(), np.float64)
        if not np.allclose(vb, va, rtol=1e-4, atol=1e-6):
            raise ValueError(f"{key} beyond rtol 1e-4, atol 1e-6")
    return "within tolerance"
