"""GBDT boosting loop.

Port of lightgbm_tpu/boosting/gbdt.py for this slice: boost-from-average,
bagging through `np.random.RandomState` (the same draws as JAX), one tree
per iteration from the rounds learner with the scores updated on the
device (training rows by leaf id, valid sets by walking the device tree
arrays — the JAX package's pipelined path, here with the tree fetched in
the same iteration), eval, host prediction, and the LightGBM text model
(save and load).  Checkpoint/resume, DART and GOSS are later slices.
"""
from __future__ import annotations

import io
import warnings
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import Config, default_metric_for_objective
from ..dataset import Dataset
from ..learner.fused import create_tree_learner, tree_arrays_to_host
from ..metrics import Metric, create_metric
from ..objectives import Objective, create_objective, \
    objective_from_model_string
from ..tree import NUMERICAL_DECISION, Tree
from .score_updater import ScoreUpdater, shrink_clip_leaves


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
        self.train_score = ScoreUpdater(
            None, self.num_data, self.K, self.device,
            train_set.metadata.init_score)
        if self.models:
            raise NotImplementedError(
                "continued training from a loaded model is not ported yet "
                "(ROADMAP.md §A item 7)")
        self.feature_names = list(train_set.feature_names)
        self.feature_infos = train_set.feature_infos()
        self.max_feature_idx = train_set.num_total_features - 1
        self.train_metrics = self._metrics_for(train_set)
        self.bag_rng = np.random.RandomState(cfg.bagging_seed)
        self.bag_idx = None
        self.bag_cnt = self.num_data
        self.need_bagging = (cfg.bagging_fraction < 1.0
                             and cfg.bagging_freq > 0)

    def add_valid(self, valid_set: Dataset, name: str) -> None:
        bins_fn = torch.as_tensor(valid_set.bins.astype(np.int32),
                                  device=self.device)
        su = ScoreUpdater(bins_fn, valid_set.num_data, self.K, self.device,
                          valid_set.metadata.init_score)
        for t in self.models:
            su.add_tree(t, 0)
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

    def train_one_iter(self) -> bool:
        """One boosting iteration.  Returns True when training should stop
        (no splittable leaves)."""
        self._boost_from_average()
        gradient, hessian = self.objective.get_gradients(
            self.train_score.score)
        self._bagging(self.iter_)
        bag = (self.bag_idx
               if self.need_bagging and self.bag_cnt < self.num_data
               else None)
        arrs, leaf_id = self.learner.train_device(
            gradient.reshape(-1), hessian.reshape(-1), bag)
        tree = tree_arrays_to_host(arrs, self.train_set,
                                   self.config.num_leaves)
        self.host_syncs_per_tree.append(self.learner.last_host_syncs + 1)
        if tree.num_leaves <= 1:
            warnings.warn("Stopped training because there are no more "
                          "leaves that meet the split requirements.")
            return True
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
        self._eval_one_set("training", self.train_score, self.train_metrics,
                           out)
        return self._materialize(out)

    def eval_valid(self) -> List[Tuple[str, str, float, bool]]:
        out: List = []
        for name, _, su, ms in self.valid_sets:
            self._eval_one_set(name, su, ms, out)
        return self._materialize(out)

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

    def predict_raw(self, X: np.ndarray, num_iteration: int = -1
                    ) -> np.ndarray:
        """Raw scores for a dense matrix (rows, raw features) -> [N] or
        [N, K], through the host f64 walk of every tree."""
        X = np.ascontiguousarray(np.asarray(X, np.float64))
        n = X.shape[0]
        used = self._num_used_models(num_iteration)
        out = np.zeros((self.K, n), np.float64)
        for i in range(used):
            out[i % self.K] += self.models[i].predict_raw(X)
        return out[0] if self.K == 1 else out.T

    def predict(self, X: np.ndarray, num_iteration: int = -1) -> np.ndarray:
        raw = self.predict_raw(X, num_iteration)
        if self.objective is not None:
            return self.objective.convert_output(raw)
        return raw

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
        with open(filename, "w") as f:
            f.write(self.save_model_to_string(num_iteration))

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
