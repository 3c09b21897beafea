"""Training traffic: lightgbm_tpu_torch.train jobs of `job_iterations`
(the traffic file's one parameter) back to back over the Datasets built
in set-up, the valid set evaluated every iteration as users run it for
early stopping.

Set-up: the configuration's generator draws the rows on the device from
the seed; the train and valid Datasets are built from them (the train
set's construct() timed as `construct_s`); torch's host threads are set
to WINDOW_THREADS; one job of WARMUP_ITERATIONS loads the kernels.

The window: jobs until its clock reads `seconds`.  The clock runs from
the first iteration of each job to the end of its last, each end taken
after a device synchronisation, so the start and finish of a job (a new
Booster given the store and valid bins) stay out of it, and a program
fast enough to fit one more job start into the window does not step the
seconds an iteration.  It closes at the end of the first iteration that
ends past `seconds`; iterations of the last, partial job count.  With
tracing on, the profiler then records TRACE_ITERATIONS more, and one
more job's start is timed on its own (`job_start_s`).  The last job runs
on, untimed, until it has CHECKED_TREES trees, which `correct` follows.
"""
from __future__ import annotations

import gc
import time
from dataclasses import dataclass, field
from importlib import import_module
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import spec
from ..reference import check
from ..reference.trees import Tree
from ..trace import Trace
from ..work import counts
from . import Run

WARMUP_ITERATIONS = 3
TRACE_ITERATIONS = 4
CHECKED_TREES = 3
# one host thread for torch's own operations: the loop is Python that
# launches kernels, and idle intra-op threads only take the host's cores
WINDOW_THREADS = 1


@dataclass
class TrainRun(Run):
    construct_s: float = 0.0
    seconds: float = 0.0
    iterations: int = 0
    jobs: int = 0
    # host reads a tree of the window's trees (the program's own counter)
    syncs_per_tree: List[int] = field(default_factory=list)
    slice_iterations: int = 0
    slice_trees: List[Tree] = field(default_factory=list)
    job_start_s: Optional[float] = None
    shape: Optional[counts.Shape] = None
    peaks: Dict = field(default_factory=dict)

    def hist_least_s(self) -> float:
        return sum(counts.histogram(t, self.shape).least_s(self.peaks)
                   for t in self.slice_trees)

    def iter_least_s(self) -> Optional[float]:
        if not self.slice_trees:
            return None
        return sum(counts.iteration(t, self.shape).least_s(self.peaks)
                   for t in self.slice_trees) / len(self.slice_trees)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def tree_of(t) -> Tree:
    """A program tree's fields, copied, as the model text has them (the
    text rounds gains to six digits; these are the stored float64s)."""
    n, s = int(t.num_leaves), max(int(t.num_leaves) - 1, 0)
    return Tree(num_leaves=n,
                split_feature=np.array(t.split_feature[:s], np.int64),
                threshold=np.array(t.threshold[:s], np.float64),
                decision_type=np.array(t.decision_type[:s], np.int64),
                left_child=np.array(t.left_child[:s], np.int64),
                right_child=np.array(t.right_child[:s], np.int64),
                split_gain=np.array(t.split_gain[:s], np.float64),
                leaf_value=np.array(t.leaf_value[:n], np.float64),
                leaf_count=np.array(t.leaf_count[:n], np.int64),
                internal_count=np.array(t.internal_count[:s], np.int64),
                shrinkage=float(t.shrinkage))


def _profiler(device: torch.device):
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def _window(lt, prm, train_ds, valid_ds, job_iters: int, seconds: float,
            trace: bool, device: torch.device, out: TrainRun, t0: float):
    """The jobs of the window and the traced slice; returns the last
    job's booster and its valid metric at every iteration."""
    stop = import_module(lt.__name__ + ".callback").EarlyStopException
    n_trace = TRACE_ITERATIONS if trace else 0
    st = {"phase": "window", "active": 0.0, "since": None}
    slice_at: List = []

    def before(env) -> None:
        if st["phase"] == "window" and env.iteration == env.begin_iteration:
            sync(device)
            st["since"] = time.perf_counter()
            if not out.setup_s:
                out.setup_s = st["since"] - t0
    before.before_iteration = True

    def after(env) -> None:
        if st["phase"] == "window":
            out.iterations += 1
            st["job_iters"] += 1
            now = time.perf_counter()
            if st["active"] + now - st["since"] >= seconds:
                sync(device)
                out.seconds = st["active"] + time.perf_counter() - st["since"]
                if device.type == "cuda":
                    out.memory_peak_bytes = torch.cuda.max_memory_allocated(
                        device)
                st["phase"] = "slice" if n_trace else "fill"
                if n_trace:
                    st["prof"] = _profiler(device)
                    st["prof"].start()
                    st["t_slice"] = time.perf_counter()
            elif env.iteration + 1 == env.end_iteration:
                sync(device)
                st["active"] += time.perf_counter() - st["since"]
        elif st["phase"] == "slice":
            slice_at.append((env.model, env.iteration))
            if len(slice_at) == n_trace:
                sync(device)
                out.slice_s = time.perf_counter() - st["t_slice"]
                st["prof"].stop()
                out.trace = Trace.from_profiler(st["prof"])
                st["phase"] = "fill"
        if st["phase"] == "fill" and env.iteration + 1 >= CHECKED_TREES:
            st["phase"] = "done"
            raise stop(env.iteration)
    after.order = 1000

    while st["phase"] != "done":
        evals: Dict = {}
        st["job_iters"] = 0
        bst = lt.train(prm, train_ds, job_iters, valid_sets=[valid_ds],
                       valid_names=["valid"], evals_result=evals,
                       callbacks=[before, after], verbose_eval=False)
        out.jobs += 1
        out.syncs_per_tree.extend(
            bst._gbdt.host_syncs_per_tree[:st["job_iters"]])
    out.slice_iterations = len(slice_at)
    out.slice_trees = [tree_of(b._gbdt.models[i]) for b, i in slice_at]
    return bst, {k: list(v) for k, v in evals.get("valid", {}).items()}


def _job_start_s(lt, prm, train_ds, valid_ds, device) -> float:
    """Seconds from a train() call to its first iteration: the start of
    a job, which the window leaves out."""
    mark: Dict = {}

    def first(env) -> None:
        sync(device)
        mark["t"] = time.perf_counter()
    first.before_iteration = True
    sync(device)
    t = time.perf_counter()
    lt.train(prm, train_ds, 1, valid_sets=[valid_ds], callbacks=[first],
             verbose_eval=False)
    return mark["t"] - t


def run(cfg: Dict, traffic: Dict, seed: int, seconds: float, trace: bool,
        device: torch.device, params: Dict, t0: float) -> TrainRun:
    import lightgbm_tpu_torch as lt
    prm = dict(cfg["params"], device_type=device.type, **params)
    out = TrainRun(peaks=spec.peaks())

    gen = import_module(f"{__package__.rsplit('.', 1)[0]}.generators."
                        f"{cfg['generator']}")
    train, valid = gen.make(cfg, seed, device)
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    t = time.perf_counter()
    train_ds = lt.Dataset(train.X, train.y, params=prm).construct()
    out.construct_s = time.perf_counter() - t
    valid_ds = lt.Dataset(valid.X, valid.y, reference=train_ds,
                          params=prm).construct()
    threads = torch.get_num_threads()
    torch.set_num_threads(WINDOW_THREADS)
    lt.train(prm, train_ds, WARMUP_ITERATIONS, valid_sets=[valid_ds],
             verbose_eval=False)
    gc.collect()
    bst, evals = _window(lt, prm, train_ds, valid_ds,
                         int(traffic["job_iterations"]), seconds, trace,
                         device, out, t0)
    if trace:
        out.job_start_s = _job_start_s(lt, prm, train_ds, valid_ds, device)
    torch.set_num_threads(threads)
    out.attempted = out.iterations
    out.shape = counts.Shape(rows=train.num_rows, valid_rows=valid.num_rows,
                             features=train.num_features,
                             max_bin=int(prm.get("max_bin", 255)))

    inner = train_ds._inner
    g = bst._gbdt
    outputs = check.Outputs(
        trees=[tree_of(t) for t in g.models],
        evals=evals,
        valid_score=g.valid_sets[0][2].score[0].double().cpu().numpy(),
        bounds={i: (None if m.is_trivial else np.array(m.bin_upper_bound))
                for i, m in enumerate(inner.mappers)},
        codes=inner._bins, code_features=list(inner.used_features))
    # the program's state goes before the reference runs
    del bst, g, inner, train_ds, valid_ds
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    out.checks = check.compare(prm, train, valid, outputs, device,
                               CHECKED_TREES)
    return out
