"""GBDT boosting loop.

Port of lightgbm_tpu/boosting/gbdt.py: boost-from-average, bagging
through `np.random.RandomState` (the same draws as JAX), K trees per
iteration (one per class, K = the objective's trees per iteration) with
the scores updated on the device, the degenerate-class bookkeeping of
multiclass labels, objectives and metrics initialised with the query
metadata, eval, rollback, early stopping, continued training (a loaded
model replayed onto the training scores), checkpoint/resume,
prediction (values and leaf indices; the device ensemble walk of
ops/predict.py past a work threshold, the host f64 walk below it), and
the LightGBM text model and JSON dump.

An iteration takes one of the JAX package's two paths (`_can_pipeline`):
- the device-tree path, for class GBDT with one tree an iteration, the
  rounds learner and no gradients passed in: the rounds learner returns
  device tree arrays, the training rows add by leaf id, valid sets walk
  the device tree arrays over their dense store or their sparse ELL
  rows, and leaf values are shrunk in f32 on the device (the JAX
  package's pipelined path, here with the tree fetched in the same
  iteration);
- the synchronous path otherwise (the exact learners — serial on the
  CPU, fused on CUDA — K > 1, a custom objective's gradients, GOSS,
  DART): each class tree comes to the host, is shrunk there in f64, and
  adds to score row k of the training rows by leaf id (by walking the
  training store when the serial learner's bag left rows out; the
  rounds and fused learners' leaf ids cover every row) and of each
  valid set by walking the tree.
Either walk reads an EFB-bundled store through its feature table.  On
a mesh (a distributed tree_learner in a `torch.distributed` world) the
loop runs in one of two modes (sharded/mesh.py).  Over a dataset of
every row, it runs replicated on every rank over all N rows, from the
same seeds, and only the tree learner shards the store.  Over a
pre-partitioned dataset (`Dataset.rank_rows`: the loader kept the
rank's rows) it runs over the local rows: local scores, gradients and
metrics (no metric is reduced across the ranks, as in the JAX package),
the bag drawn over the local rows from the shared seed, boost-from-
average from the world's label sum and count (`allgather_f64`, exact),
and the synchronous path, with host trees shrunk in f64, as the JAX
package's multi-process worlds take it.  Either way every rank's model
string is the same.

Observability, as in the JAX package: the TIMETAG phases `boosting`
(the objective's gradients), `bagging`, `tree`, `score` and `metric`
(profiling.phase: host seconds around asynchronous launches, no device
synchronisation), each also a host range `lgbt::<phase>` that
torch.profiler records, as are the rounds learner's `learner.*` ranges
inside `tree` (profiling.range; the tree's fetch here is
`learner.round`), so a device trace says which phase held the device
idle or launched a kernel, which the host seconds cannot; one
`train.iteration` record a completed iteration and one `train.eval`
record an evaluation, once telemetry is on (`telemetry_path` or
LIGHTGBM_TPU_TELEMETRY), with no device read of their own; the
`train.checkpoint` and `train.resume` spans, and the fault seams
`train.checkpoint` (a torn checkpoint write) and `train.after_checkpoint`
(a crash after the checkpoint landed).
"""
from __future__ import annotations

import dataclasses
import hashlib
import io
import json
import os
import time
import warnings
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import log, profiling, telemetry
from ..config import Config, default_metric_for_objective
from ..dataset import Dataset
from ..diagnostics import faults
from ..learner.fused import create_tree_learner, tree_arrays_to_host
from ..log import LightGBMError
from ..metrics import Metric, create_metric
from ..objectives import Objective, create_objective, \
    objective_from_model_string
from ..tree import NUMERICAL_DECISION, Tree
from .score_updater import ScoreUpdater, shrink_clip_leaves


CHECKPOINT_VERSION = 1

# fields that may differ between the run that wrote a checkpoint and the
# run resuming it (paths, logging, the resume machinery, serving and
# observability knobs); every other field is part of the fingerprint:
# resuming under another training recipe is an error, not a merge
_FINGERPRINT_EXCLUDE = frozenset({
    "task", "verbose", "num_threads", "num_iterations", "input_model",
    "output_model", "output_result", "config_file", "output_freq",
    "checkpoint_path", "checkpoint_interval",
    "serve_host", "serve_port", "max_batch_rows", "flush_deadline_ms",
    "model_poll_seconds", "min_bucket_rows", "serve_replicas",
    "max_pending_rows", "serve_request_timeout_ms",
    "replica_failure_threshold",
    "refit_decay_rate", "refit_min_rows", "online_trigger_rows",
    "online_mode",
    "telemetry_path", "metrics_port",
})


def config_fingerprint(config: Config) -> str:
    """Stable digest of every training-relevant Config field."""
    d = dataclasses.asdict(config)
    items = sorted((k, repr(v)) for k, v in d.items()
                   if k not in _FINGERPRINT_EXCLUDE)
    return hashlib.sha1(repr(items).encode()).hexdigest()


def _rng_state_to_json(rng: np.random.RandomState) -> Dict:
    kind, keys, pos, has_gauss, cached = rng.get_state()
    return {"kind": kind, "keys": np.asarray(keys).tolist(), "pos": int(pos),
            "has_gauss": int(has_gauss), "cached": float(cached)}


def _rng_state_from_json(d: Dict) -> Tuple:
    return (str(d["kind"]), np.asarray(d["keys"], np.uint32), int(d["pos"]),
            int(d["has_gauss"]), float(d["cached"]))


def load_checkpoint(path: str) -> Optional[Dict]:
    """Parse a training checkpoint; None when absent or unreadable.  A
    torn or corrupt checkpoint (a crash's leftover) logs a warning and
    the run starts from scratch, as if there were none."""
    try:
        with open(path) as f:
            state = json.load(f)
    except FileNotFoundError:
        return None
    except OSError as e:
        # an existing but unreadable checkpoint must not pass for "no
        # checkpoint" without a word
        log.warning(f"could not read checkpoint {path} "
                    f"({type(e).__name__}: {e}); starting fresh")
        return None
    except ValueError as e:
        log.warning(f"ignoring unreadable checkpoint {path} "
                    f"({type(e).__name__}: {e}); starting fresh")
        return None
    if (not isinstance(state, dict)
            or state.get("version") != CHECKPOINT_VERSION
            or "model" not in state):
        version = state.get("version") if isinstance(state, dict) else "?"
        log.warning(f"ignoring incompatible checkpoint {path} "
                    f"(version {version}); starting fresh")
        return None
    return state


def resolve_device(config: Config) -> torch.device:
    """The Config's device: "cuda" needs a visible GPU and raises without
    one (there is no silent fallback to the CPU); "cpu" runs the plain
    versions of the kernels."""
    if config.device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device_type=cuda but no CUDA device is visible; "
                           "pass device_type=cpu to run on the CPU")
    return torch.device(config.device_type)


class GBDT:
    """Gradient Boosting Decision Tree."""

    def __init__(self, config: Config, train_set: Optional[Dataset] = None,
                 objective: Optional[Objective] = None):
        self.config = config
        self.models: List[Tree] = []
        self.iter_ = 0
        self.num_init_iteration = 0
        self.boost_from_average_used = False
        self.train_set = None
        self.objective = objective
        self.shrinkage_rate = config.learning_rate
        self.num_class = config.num_class
        self.K = config.num_tree_per_iteration
        self.train_metrics: List[Metric] = []
        self.valid_sets: List[Tuple[str, Dataset, ScoreUpdater,
                                    List[Metric]]] = []
        self.label_idx = 0
        self.feature_names: List[str] = []
        self.feature_infos: List[str] = []
        self.max_feature_idx = 0
        # device->host reads per grown tree (round loop + tree fetch)
        self.host_syncs_per_tree: List[int] = []
        self._early_stopping_state: Dict = {}
        # a resumed run replays its trees one at a time ("walk"), in
        # training's order, so its scores are bitwise those of the
        # uninterrupted run
        self._replay_kernel: Optional[str] = None
        # device stacks of the predictor, by (kind, trees used, trees);
        # emptied by `_models_changed` whenever a tree is added, removed
        # or edited
        self._predict_stack_cache: Dict = {}
        if train_set is not None:
            self.reset_training_data(train_set, objective)

    # ------------------------------------------------------------------
    def _metrics_for(self, dataset: Dataset) -> List[Metric]:
        cfg = self.config
        names = cfg.metric or (default_metric_for_objective(cfg.objective),)
        ms = []
        for nm in names:
            m = create_metric(nm, cfg)
            if m is not None:
                m.init(dataset.metadata, dataset.num_data, self.device)
                ms.append(m)
        return ms

    def reset_training_data(self, train_set: Dataset,
                            objective: Optional[Objective] = None) -> None:
        cfg = self.config
        self.device = resolve_device(cfg)
        self.train_set = train_set
        self.num_data = train_set.num_data
        self.objective = objective or create_objective(cfg)
        self.objective.init(train_set.metadata, self.num_data, self.device)
        self.K = self.objective.num_tree_per_iteration
        self.learner = create_tree_learner(train_set, cfg)
        # the learner's store, resolved when a tree is first walked over
        # the training rows (bagged exact-learner iterations, DART,
        # rollback, the replay below)
        learner = self.learner
        self.train_score = ScoreUpdater(
            lambda: learner.walk_bins, self.num_data, self.K,
            self.device, train_set.metadata.init_score,
            feat_tbl=train_set.bundle_feat_table())
        # continued training: replay the loaded model onto the fresh
        # training scores (loaded trees first get in-bin thresholds for
        # this dataset's mappers)
        for t in self.models:
            t.rebin_to_dataset(train_set)
        if self.models:
            self.train_score.add_trees(self.models, self.K,
                                       self._replay_kernel
                                       or cfg.predict_kernel)
        self.feature_names = list(train_set.feature_names)
        self.feature_infos = train_set.feature_infos()
        self.max_feature_idx = train_set.num_total_features - 1
        self.train_metrics = self._metrics_for(train_set)
        self.bag_rng = np.random.RandomState(cfg.bagging_seed)
        self.bag_idx = None
        self.bag_cnt = self.num_data
        self.need_bagging = (cfg.bagging_fraction < 1.0
                             and cfg.bagging_freq > 0)
        # degenerate-class bookkeeping (gbdt.cpp:166-195): a class that no
        # row has, or that every row has, grows no tree and adds a fixed
        # output once
        self.class_need_train = [True] * self.K
        self.class_default_output = [0.0] * self.K
        if self.K > 1 and cfg.objective in ("multiclass", "multiclassova"):
            lab = np.asarray(train_set.metadata.label).astype(np.int64)
            for k in range(self.K):
                cnt = int((lab == k).sum())
                if cnt == 0:
                    self.class_need_train[k] = False
                    self.class_default_output[k] = -np.log(1e10)
                elif cnt == self.num_data:
                    self.class_need_train[k] = False
                    self.class_default_output[k] = -np.log(1e-10)

    def add_valid(self, valid_set: Dataset, name: str) -> None:
        if valid_set.sparse is not None:
            # the ELL triple: the walk probes row entries, never densifies
            bins_fn = valid_set.sparse_triple(self.device)
        else:
            bins_fn = torch.as_tensor(valid_set.bins.astype(np.int32),
                                      device=self.device)
        su = ScoreUpdater(bins_fn, valid_set.num_data, self.K, self.device,
                          valid_set.metadata.init_score,
                          feat_tbl=valid_set.bundle_feat_table())
        for t in self.models:
            t.rebin_to_dataset(valid_set)
        if self.models:
            su.add_trees(self.models, self.K,
                         self._replay_kernel or self.config.predict_kernel)
        self.valid_sets.append((name, valid_set, su,
                                self._metrics_for(valid_set)))

    # ------------------------------------------------------------------
    def _boost_from_average(self) -> None:
        cfg = self.config
        if (self.models or not cfg.boost_from_average
                or self.train_score.has_init_score or self.num_class > 1
                or self.objective is None
                or not self.objective.boost_from_average):
            return
        lab = np.asarray(self.train_set.metadata.label, np.float64)
        # rank_rows is set on every rank of a pre-partitioned world
        # torchlint: allow(divergent-collective) — and on none otherwise
        if self.train_set.rank_rows is not None:
            # every rank seeds the same constant: the mean of the world's
            # labels, from the ranks' sums and counts gathered bit for bit
            from ..distributed import allgather_f64
            sums = allgather_f64(np.asarray([lab.sum(), float(len(lab))]))
            init_score = float(sums[:, 0].sum()
                               / max(sums[:, 1].sum(), 1.0))
        else:
            init_score = float(lab.mean())
        t = Tree(2)
        t.split(0, 0, NUMERICAL_DECISION, 0, 0, 0.0, init_score, init_score,
                0, self.num_data, 1.0)
        self.train_score.add_constant(init_score, 0)
        for _, _, su, _ in self.valid_sets:
            su.add_constant(init_score, 0)
        self.models.append(t)
        self.boost_from_average_used = True

    def _bagging(self, iter_: int) -> None:
        """Re-draw the bag every bagging_freq iterations (gbdt.cpp:257-317)."""
        if not self.need_bagging or iter_ % self.config.bagging_freq != 0:
            return
        n = self.num_data
        cnt = int(self.config.bagging_fraction * n)
        idx = self.bag_rng.choice(n, size=cnt, replace=False)
        idx.sort()
        cap = 1 << max(cnt - 1, 1).bit_length()
        cap = min(cap, n)
        if cap < cnt:
            cap = cnt
        padded = np.full(cap, n, np.int32)
        padded[:cnt] = idx
        self.bag_idx = torch.as_tensor(padded, device=self.device)
        self.bag_cnt = cnt

    def boosting_gradients(self) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.objective.get_gradients(self.train_score.score)

    def _can_pipeline(self) -> bool:
        """The device-tree path: class GBDT (GOSS passes its sampled
        gradients in, DART walks its drops), one tree an iteration, the
        rounds learner, and a dataset of every row (a pre-partitioned
        world takes the synchronous path, as the JAX package's
        multi-process worlds do)."""
        return (type(self) is GBDT and self.K == 1
                and hasattr(self.learner, "train_device")
                and self.train_set.rank_rows is None)

    def train_one_iter(self, gradient: Optional[torch.Tensor] = None,
                       hessian: Optional[torch.Tensor] = None,
                       is_eval: bool = False) -> bool:
        """One boosting iteration on the objective's gradients, or on
        `gradient`/`hessian` ([K, N] float32 on the device) when given.
        Returns True when training should stop (no splittable leaves, or
        early stopping when `is_eval`)."""
        device_path = (gradient is None and hessian is None
                       and self._can_pipeline())
        self._telemetry_iter_begin()
        self._models_changed()
        self._boost_from_average()
        if gradient is None or hessian is None:
            with profiling.phase("boosting"):
                gradient, hessian = self.boosting_gradients()
        with profiling.phase("bagging"):
            self._bagging(self.iter_)
        bag = (self.bag_idx
               if self.need_bagging and self.bag_cnt < self.num_data
               else None)
        if device_path:
            if self._train_device_tree(gradient.reshape(-1),
                                       hessian.reshape(-1), bag):
                return True
            stop = self.eval_and_check_early_stopping() if is_eval else False
            self._telemetry_iter_end()
            return stop
        should_continue = False
        for k in range(self.K):
            if self.class_need_train[k]:
                tree = self._train_class_tree(gradient[k], hessian[k], bag,
                                              k)
            else:
                tree = Tree(2)
            if tree.num_leaves > 1:
                should_continue = True
            elif (not self.class_need_train[k]
                  and len(self.models) < self.K):
                out = self.class_default_output[k]
                tree.leaf_value[0] = out
                self.train_score.add_constant(out, k)
                for _, _, su, _ in self.valid_sets:
                    su.add_constant(out, k)
            self.models.append(tree)
        if not should_continue:
            warnings.warn("Stopped training because there are no more "
                          "leaves that meet the split requirements.")
            del self.models[-self.K:]
            return True
        self.iter_ += 1
        stop = self.eval_and_check_early_stopping() if is_eval else False
        self._telemetry_iter_end()
        return stop

    def rollback_one_iter(self) -> None:
        """Take the last iteration's trees back off the training and
        valid scores (each walked with its leaf values negated) and out of
        the model."""
        if self.iter_ <= 0:
            return
        for k in range(self.K):
            tree = self.models[-self.K + k]
            tree.apply_shrinkage(-1.0)
            self.train_score.add_tree(tree, k)
            for _, _, su, _ in self.valid_sets:
                su.add_tree(tree, k)
        del self.models[-self.K:]
        self._models_changed()
        self.iter_ -= 1

    def _train_device_tree(self, gradient: torch.Tensor,
                           hessian: torch.Tensor,
                           bag: Optional[torch.Tensor]) -> bool:
        """The rounds learner's iteration with one tree (the JAX package's
        pipelined path): leaf values shrunk and clamped in f32 on the
        device, training rows added by leaf id, valid sets walked over
        the device tree arrays."""
        with profiling.phase("tree"):
            arrs, leaf_id = self.learner.train_device(gradient, hessian, bag)
            with profiling.range("learner.round"):
                tree = tree_arrays_to_host(
                    arrs, self.train_set, self.config.num_leaves,
                    mesh=getattr(self.learner, "mesh", None),
                    name=self.learner.tree_name)
        self.host_syncs_per_tree.append(self.learner.last_host_syncs + 1)
        if tree.num_leaves <= 1:
            warnings.warn("Stopped training because there are no more "
                          "leaves that meet the split requirements.")
            return True
        with profiling.phase("score"):
            lv = shrink_clip_leaves(arrs.leaf_value, tree.num_leaves,
                                    self.shrinkage_rate)
            self.train_score.add_tree_by_leaf_id_dev(leaf_id, lv, 0)
            depth = tree.max_depth_grown
            for _, _, su, _ in self.valid_sets:
                su.add_tree_arrays_dev(arrs, lv, 0, tree.num_leaves, depth)
        tree.apply_shrinkage(self.shrinkage_rate)
        self.models.append(tree)
        self.iter_ += 1
        return False

    def _train_class_tree(self, gradient: torch.Tensor,
                          hessian: torch.Tensor, bag: Optional[torch.Tensor],
                          k: int) -> Tree:
        """Grow the tree of class k on gradient row k (the JAX package's
        synchronous path): a host tree, shrunk on the host, added to
        score row k of the training rows by leaf id (by walking the
        training store when the exact learner's bag left rows out) and
        of every valid set by walking it.  A tree that did not split is
        returned as it is and adds nothing."""
        with profiling.phase("tree"):
            if hasattr(self.learner, "train_device"):
                tree, leaf_id = self.learner.train(gradient, hessian, bag)
            else:
                tree, leaf_id = self.learner.train(
                    gradient, hessian, bag,
                    self.bag_cnt if bag is not None else None)
        # the rounds and fused learners' leaf ids cover out-of-bag rows too
        full_leaf_id = bag is None or getattr(self.learner, "full_leaf_id",
                                              False)
        self.host_syncs_per_tree.append(self.learner.last_host_syncs)
        if tree.num_leaves <= 1:
            return tree
        tree.apply_shrinkage(self.shrinkage_rate)
        with profiling.phase("score"):
            if full_leaf_id:
                self.train_score.add_tree_by_leaf_id(tree, leaf_id, k)
            else:
                self.train_score.add_tree(tree, k)
        for _, _, su, _ in self.valid_sets:
            su.add_tree(tree, k)
        return tree

    # -- per-iteration telemetry ----------------------------------------

    def _telemetry_iter_begin(self) -> None:
        """Snapshot the host-side phase totals and `tree/*` counters, so
        that the iteration's record reports deltas.  One cached check
        when telemetry is off; never touches the device either way.  An
        iteration that aborts (no splittable leaf: its trees are taken
        back) emits no record, so the stream holds only the iterations
        of the model it describes."""
        if not telemetry.enabled():
            self._telem_t0 = None
            return
        self._telem_t0 = time.perf_counter()
        self._telem_phases = profiling.timings()
        self._telem_ctrs = profiling.counters_nosync("tree/")

    def _telemetry_iter_end(self) -> None:
        t0 = getattr(self, "_telem_t0", None)
        if t0 is None:
            return
        dt = time.perf_counter() - t0
        ph = {}
        for k, v in profiling.timings().items():
            d = v - self._telem_phases.get(k, 0.0)
            if d > 1e-9:
                ph[k] = round(d, 6)
        # host-visible deltas only: `count_deferred` device totals fold
        # in at the next drain (a /metrics scrape or a counters() read),
        # so here they lag rather than force a device read
        deltas = {k.rsplit("/", 1)[-1]:
                  round(v - self._telem_ctrs.get(k, 0.0), 1)
                  for k, v in profiling.counters_nosync("tree/").items()}
        telemetry.event("train.iteration", iteration=self.iter_,
                        trees=len(self.models), rows=self.num_data,
                        seconds=round(dt, 6), phases=ph, counters=deltas)

    def _telemetry_eval(self, out: List) -> None:
        """Eval results as a `train.eval` record, emitted only where the
        caller already holds them on the host (`_materialize`'s one
        batched read), so the record adds no read of its own."""
        if out and telemetry.enabled():
            telemetry.event("train.eval", iteration=self.iter_,
                            results=[[s, n, v] for s, n, v, _ in out])

    # ------------------------------------------------------------------
    @staticmethod
    def _materialize(out: List) -> List[Tuple[str, str, float, bool]]:
        """Fetch every metric value of `out` in one transfer."""
        if not out:
            return out
        vals = torch.stack([v.reshape(()).to(torch.float64)
                            for _, _, v, _ in out]).cpu().tolist()
        return [(s, n, float(v), b) for (s, n, _, b), v in zip(out, vals)]

    def _eval_one_set(self, set_name: str, su: ScoreUpdater,
                      ms: List[Metric], out: List) -> None:
        for m in ms:
            for nm, v in m.eval(su.score):
                out.append((set_name, nm, v, m.factor_to_bigger_better > 0))

    def eval_train(self) -> List[Tuple[str, str, float, bool]]:
        out: List = []
        with profiling.phase("metric"):
            self._eval_one_set("training", self.train_score,
                               self.train_metrics, out)
            out = self._materialize(out)
        self._telemetry_eval(out)
        return out

    def eval_valid(self) -> List[Tuple[str, str, float, bool]]:
        out: List = []
        with profiling.phase("metric"):
            for name, _, su, ms in self.valid_sets:
                self._eval_one_set(name, su, ms, out)
            out = self._materialize(out)
        self._telemetry_eval(out)
        return out

    def eval_and_check_early_stopping(self, results=None) -> bool:
        """Early stopping over the valid metrics (gbdt.cpp:472-578): stop
        when none improved for early_stopping_round iterations, and drop
        the trees after the best one.  `results` spares a second metric
        pass to a caller that evaluated already."""
        esr = self.config.early_stopping_round
        if esr <= 0:
            return False
        res = self.eval_valid() if results is None else results
        if not res:
            return False
        st = self._early_stopping_state
        for name, metric, value, bigger_better in res:
            key = (name, metric)
            cmp = value if bigger_better else -value
            if key not in st or cmp > st[key][0]:
                st[key] = (cmp, self.iter_)
        best_iter = max(v[1] for v in st.values())
        if self.iter_ - best_iter >= esr:
            n_drop = (self.iter_ - best_iter) * self.K
            del self.models[-n_drop:]
            self._models_changed()
            self.iter_ = best_iter
            return True
        return False

    # ------------------------------------------------------------------
    @property
    def num_trees(self) -> int:
        return len(self.models)

    def current_iteration(self) -> int:
        extra = 1 if self.boost_from_average_used else 0
        return (len(self.models) - extra) // self.K

    def _num_used_models(self, num_iteration: int) -> int:
        n = len(self.models)
        if num_iteration > 0:
            ni = num_iteration + (1 if self.boost_from_average_used else 0)
            n = min(ni * self.K, n)
        return n

    # batch rows x trees above which prediction takes the device walk
    # (ops/predict.py); smaller calls keep the host f64 walk (exact
    # double compares).  LIGHTGBM_TPU_DEVICE_PREDICT=1 forces the device,
    # =0 the host.
    _DEVICE_PREDICT_MIN_WORK = 2_000_000
    _PREDICT_CHUNK = 262_144

    def _predict_device(self) -> torch.device:
        """The training device, or the Config's for a loaded model (a
        GPU must be visible for device_type=cuda)."""
        dev = getattr(self, "device", None)
        return dev if dev is not None else resolve_device(self.config)

    def _use_device_predict(self, n: int, used: int) -> bool:
        force = os.environ.get("LIGHTGBM_TPU_DEVICE_PREDICT", "")
        return used > 0 and force != "0" and (
            force == "1" or n * used >= self._DEVICE_PREDICT_MIN_WORK)

    def _models_changed(self) -> None:
        """Drop the predictor's cached stacks: a tree was added, removed
        or edited (training, rollback, early stopping, a loaded or
        continued model).  A key of (kind, trees used, trees) alone would
        hand a rolled-back-then-regrown model its old stack."""
        self._predict_stack_cache.clear()

    def _cached_stack(self, key, build):
        """The device stack under `key`, built once for the current
        trees (`_models_changed` empties the cache); a few keys at most
        (more evict wholesale)."""
        cache = self._predict_stack_cache
        if key not in cache:
            if len(cache) >= 4 * max(self.K, 1):
                cache.clear()
            cache[key] = build()
        return cache[key]

    def _run_chunked(self, X: np.ndarray, out: np.ndarray, kernel_fn,
                     device: torch.device) -> None:
        """The device-predict chunk loop: `_PREDICT_CHUNK` rows a pass
        (the [T, rows] walk temporaries are freed between passes), one
        host copy a pass.  `kernel_fn` maps a [rows, F] f32 tensor to
        values whose last axis is rows; they land in out[..., a:b]."""
        CHUNK = self._PREDICT_CHUNK
        for a in range(0, X.shape[0], CHUNK):
            b = min(a + CHUNK, X.shape[0])
            chunk = torch.as_tensor(
                np.ascontiguousarray(X[a:b], np.float32), device=device)
            out[..., a:b] = kernel_fn(chunk).cpu().numpy()

    def _trees_by_class(self, used: int) -> List[List[Tree]]:
        return [[self.models[i] for i in range(used) if i % self.K == k]
                for k in range(self.K)]

    def _predict_raw_device(self, X: np.ndarray, used: int) -> np.ndarray:
        """The device predictor: every tree and row advances one level a
        step, with f32 feature/threshold compares.  ``tensorized`` (what
        `auto` resolves to) walks every class's trees in one traversal,
        ``walk`` one traversal a class."""
        from ..ops.predict import (build_ensemble, ensemble_raw,
                                   predict_ensemble_any,
                                   resolve_predict_kernel, stack_trees,
                                   to_device)
        device = self._predict_device()
        out = np.zeros((self.K, X.shape[0]), np.float64)
        if resolve_predict_kernel(self.config.predict_kernel) == "walk":
            def build():
                stacks, depths = [], []
                for trees in self._trees_by_class(used):
                    stacks.append(to_device(stack_trees(trees, False),
                                            device) if trees else None)
                    depths.append(max((t.max_depth_grown for t in trees),
                                      default=1) or 1)
                return stacks, tuple(depths)
            stacks, depths = self._cached_stack(
                ("walk", used, len(self.models)), build)
            self._run_chunked(
                X, out, lambda c: ensemble_raw(stacks, c, depths=depths),
                device)
        else:
            def build():
                stack, meta = build_ensemble(self._trees_by_class(used),
                                             binned=False)
                return to_device(stack, device), meta
            stack, meta = self._cached_stack(
                ("ens", used, len(self.models)), build)
            self._run_chunked(
                X, out, lambda c: predict_ensemble_any(stack, c, meta=meta),
                device)
        return out[0] if self.K == 1 else out.T

    def predict_raw(self, X: np.ndarray, num_iteration: int = -1
                    ) -> np.ndarray:
        """Raw scores for a dense matrix (rows, raw features) -> [N] or
        [N, K]: the device predictor past `_DEVICE_PREDICT_MIN_WORK`
        (rows x trees), the host f64 walk of every tree below it."""
        X = np.ascontiguousarray(np.asarray(X, np.float64))
        n = X.shape[0]
        used = self._num_used_models(num_iteration)
        if self._use_device_predict(n, used):
            return self._predict_raw_device(X, used)
        out = np.zeros((self.K, n), np.float64)
        for i in range(used):
            out[i % self.K] += self.models[i].predict_raw(X)
        return out[0] if self.K == 1 else out.T

    def predict(self, X: np.ndarray, num_iteration: int = -1) -> np.ndarray:
        raw = self.predict_raw(X, num_iteration)
        if self.objective is not None:
            return self.objective.convert_output(raw)
        return raw

    def predict_leaf_index(self, X: np.ndarray, num_iteration: int = -1
                           ) -> np.ndarray:
        """Leaf index per (row, model): [N, num_models] int32.  Under
        ``predict_kernel=tensorized`` (`auto`) and the predict_raw work
        gate, one device traversal of every model
        (ops/predict.predict_ensemble_leaf); otherwise the host walk of
        each tree (exact f64 compares).  The two give the same indices:
        the device stack is built one tree a class in MODEL order (the
        class-major flatten of the value kernels would permute a
        multiclass model's columns), and its categorical compare carries
        the host walk's finite mask."""
        from ..ops.predict import resolve_predict_kernel
        X = np.ascontiguousarray(np.asarray(X, np.float64))
        used = self._num_used_models(num_iteration)
        if (resolve_predict_kernel(self.config.predict_kernel)
                == "tensorized" and self._use_device_predict(X.shape[0],
                                                             used)):
            return self._predict_leaf_device(X, used)
        if used == 0:
            return np.zeros((X.shape[0], 0), np.int32)
        return np.stack([self.models[i].predict_leaf_index(X)
                         for i in range(used)], axis=1)

    def _predict_leaf_device(self, X: np.ndarray, used: int) -> np.ndarray:
        """Tensorized leaf routing: one traversal of every model
        (model-order stack, [T, rows] leaves), chunked like the value
        kernels."""
        from ..ops.predict import (predict_ensemble_leaf, stack_ensemble,
                                   to_device)
        device = self._predict_device()

        def build():
            stack, meta = stack_ensemble(
                [[self.models[i]] for i in range(used)], binned=False)
            return to_device(stack, device), meta
        stack, meta = self._cached_stack(("leaf", used, len(self.models)),
                                         build)
        out = np.zeros((used, X.shape[0]), np.int32)
        self._run_chunked(
            X, out, lambda c: predict_ensemble_leaf(stack, c, meta=meta),
            device)
        return np.ascontiguousarray(out.T)

    # ------------------------------------------------------------------
    def feature_importance(self, importance_type: str = "split"
                           ) -> Dict[str, float]:
        """Per-feature split counts (gbdt.cpp:850-872) or summed gains."""
        cnt = np.zeros(self.max_feature_idx + 1, np.float64)
        for t in self.models:
            for i in range(t.num_leaves - 1):
                if importance_type == "gain":
                    cnt[t.split_feature[i]] += float(t.split_gain[i])
                else:
                    cnt[t.split_feature[i]] += 1
        pairs = [(float(c), self.feature_names[i]
                  if i < len(self.feature_names) else f"Column_{i}")
                 for i, c in enumerate(cnt) if c > 0]
        pairs.sort(key=lambda p: -p[0])
        if importance_type == "gain":
            return {name: c for c, name in pairs}
        return {name: int(c) for c, name in pairs}

    def sub_model_name(self) -> str:
        return "tree"

    def save_model_to_string(self, num_iteration: int = -1) -> str:
        """LightGBM-compatible model text (gbdt.cpp:694-738)."""
        buf = io.StringIO()
        buf.write(self.sub_model_name() + "\n")
        buf.write(f"num_class={self.num_class}\n")
        buf.write(f"num_tree_per_iteration={self.K}\n")
        buf.write(f"label_index={self.label_idx}\n")
        buf.write(f"max_feature_idx={self.max_feature_idx}\n")
        if self.objective is not None:
            buf.write(f"objective={self.objective.to_string()}\n")
        if self.boost_from_average_used:
            buf.write("boost_from_average\n")
        buf.write("feature_names=" + " ".join(self.feature_names) + "\n")
        buf.write("feature_infos=" + " ".join(self.feature_infos) + "\n")
        buf.write("\n")
        used = self._num_used_models(num_iteration)
        for i in range(used):
            buf.write(f"Tree={i}\n")
            buf.write(self.models[i].to_string())
            buf.write("\n")
        buf.write("\nfeature importances:\n")
        for name, c in self.feature_importance().items():
            buf.write(f"{name}={c}\n")
        return buf.getvalue()

    def save_model_to_file(self, filename: str,
                           num_iteration: int = -1) -> None:
        """Write the model string, through a temporary file renamed over
        `filename`, so that the ranks of one host writing the same model
        never interleave."""
        tmp = f"{filename}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            f.write(self.save_model_to_string(num_iteration))
        os.replace(tmp, filename)

    def load_model_from_string(self, model_str: str) -> None:
        """gbdt.cpp:752-848."""
        lines = model_str.splitlines()

        def find(prefix):
            for ln in lines:
                if ln.startswith(prefix):
                    return ln[len(prefix):].strip()
            return None

        nc = find("num_class=")
        if nc is not None:
            self.num_class = int(nc)
        k = find("num_tree_per_iteration=")
        self.K = int(k) if k is not None else self.num_class
        li = find("label_index=")
        if li is not None:
            self.label_idx = int(li)
        mf = find("max_feature_idx=")
        if mf is not None:
            self.max_feature_idx = int(mf)
        obj = find("objective=")
        if obj:
            self.objective = objective_from_model_string(obj, self.config)
        self.boost_from_average_used = any(
            ln.strip() == "boost_from_average" for ln in lines)
        fn = find("feature_names=")
        if fn:
            self.feature_names = fn.split()
        fi = find("feature_infos=")
        if fi:
            self.feature_infos = fi.split()
        self.models = []
        self._models_changed()
        text = "\n".join(lines)
        parts = text.split("Tree=")
        for p in parts[1:]:
            body = p.split("\n", 1)[1] if "\n" in p else ""
            stop = body.find("\nfeature importances")
            if stop >= 0:
                body = body[:stop]
            self.models.append(Tree.from_string(body))
        extra = 1 if self.boost_from_average_used else 0
        self.num_init_iteration = ((len(self.models) - extra)
                                   // max(self.K, 1))
        self.iter_ = 0

    def to_json(self) -> Dict:
        """DumpModel (gbdt.cpp:658-692): name, num_class,
        num_tree_per_iteration, label_index, max_feature_idx,
        feature_names and tree_info with a tree_index per entry; the
        per-tree fields of Tree.to_json.  `objective` is an extension (a
        reload needs it)."""
        return {
            "name": self.sub_model_name(),
            "num_class": self.num_class,
            "num_tree_per_iteration": self.K,
            "label_index": self.label_idx,
            "max_feature_idx": self.max_feature_idx,
            "objective": self.objective.to_string() if self.objective else "",
            "feature_names": self.feature_names,
            "tree_info": [dict(tree_index=i, **t.to_json())
                          for i, t in enumerate(self.models)],
        }

    # -- checkpoint / resume --------------------------------------------

    def _extra_training_state(self) -> Dict:
        """Subclass hook: sampler state beyond the base GBDT's (the GOSS
        key, DART's drop RNG and tree weights)."""
        return {}

    def _restore_extra_training_state(self, state: Dict) -> None:
        pass

    def training_state(self) -> Dict:
        """Everything a resumed run needs to go on bitwise where this one
        stands: the model text, the iteration counters, the early-stopping
        bests and the exact state of the sampler's RNG (a re-seeded RNG
        would draw the first bags again and fork the run)."""
        state = {
            "version": CHECKPOINT_VERSION,
            "fingerprint": config_fingerprint(self.config),
            "boosting": self.sub_model_name(),
            "iteration": self.iter_,
            "num_init_iteration": self.num_init_iteration,
            "shrinkage_rate": self.shrinkage_rate,
            "early_stopping": [
                [name, metric, cmp, it]
                for (name, metric), (cmp, it)
                in self._early_stopping_state.items()],
            "bag_rng": _rng_state_to_json(self.bag_rng),
            "model": self.save_model_to_string(),
        }
        state.update(self._extra_training_state())
        return state

    def save_checkpoint(self, path: str,
                        extra: Optional[Dict] = None) -> None:
        """Write the training state atomically (a temporary file, then
        os.replace), so that a crash while writing leaves the previous
        checkpoint whole.  `extra` rides along in the state (the engine
        records a `finished` marker, so a rerun of a finished call trains
        nothing).  The write is the `train.checkpoint` span; the fault
        seams `train.checkpoint` (half the payload lands at `path`, then
        a crash) and `train.after_checkpoint` (a crash once the file is
        in place) test the restart's recovery."""
        state = self.training_state()
        if extra:
            state.update(extra)
        with telemetry.span("train.checkpoint", path=path,
                            iteration=self.iter_, trees=len(self.models)):
            payload = json.dumps(state)
            faults.torn_write("train.checkpoint", path, payload)
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                f.write(payload)
            os.replace(tmp, path)
        log.debug(f"checkpoint saved to {path} (iteration {self.iter_}, "
                  f"{len(self.models)} trees)")
        faults.check("train.after_checkpoint")

    def restore_training_state(self, state: Dict) -> None:
        """Apply a checkpoint's counters and RNG state, after
        load_model_from_string(state["model"]) and reset_training_data
        (whose replay restores the training and valid scores)."""
        if state.get("fingerprint") != config_fingerprint(self.config):
            raise LightGBMError(
                "checkpoint was written under a different training "
                "config (fingerprint mismatch); resuming would silently "
                "mix recipes: delete the checkpoint to start fresh, or "
                "restore the original parameters")
        if state.get("boosting") != self.sub_model_name():
            raise LightGBMError(
                f"checkpoint holds a {state.get('boosting')!r} model, "
                f"this run is {self.sub_model_name()!r}")
        self.iter_ = int(state["iteration"])
        self.num_init_iteration = int(state.get("num_init_iteration", 0))
        self.shrinkage_rate = float(state["shrinkage_rate"])
        self._early_stopping_state = {
            (name, metric): (float(cmp), int(it))
            for name, metric, cmp, it in state.get("early_stopping", [])}
        if state.get("bag_rng"):
            self.bag_rng.set_state(_rng_state_from_json(state["bag_rng"]))
        self._restore_extra_training_state(state)

    def resume_from_checkpoint(self, state: Dict, train_set: Dataset,
                               objective: Optional[Objective] = None) -> int:
        """Load the checkpoint's model, replay it onto fresh training
        scores one tree at a time, and restore the counters and RNG
        state.  Returns the iteration to go on from.  Valid sets added
        after this call replay the restored model (add_valid does).  The
        resume is the `train.resume` span."""
        with telemetry.span(
                "train.resume",
                checkpoint_iteration=int(state.get("iteration", 0))) as sp:
            self.load_model_from_string(state["model"])
            self._replay_kernel = "walk"
            self.reset_training_data(train_set, objective)
            self.restore_training_state(state)
            sp.set(trees=len(self.models))
        return self.iter_


def create_boosting(config: Config, model_file: str = "",
                    model_str: Optional[str] = None) -> GBDT:
    """Factory (boosting.cpp:29-71): gbdt | dart | goss.  A model (a file
    or a string) names its boosting type on its first line, which wins
    over the Config's; the model is then loaded."""
    from .dart import DART
    from .goss import GOSS
    table = {"gbdt": GBDT, "tree": GBDT, "dart": DART, "goss": GOSS}
    btype = config.boosting_type
    if model_file:
        with open(model_file) as f:
            model_str = f.read()
    if model_str:
        first = model_str.split("\n", 1)[0].strip()
        if first in table:
            btype = first
    if btype not in table:
        raise ValueError(f"unknown boosting type: {btype}")
    gbdt = table[btype](config)
    if model_str:
        gbdt.load_model_from_string(model_str)
    return gbdt
