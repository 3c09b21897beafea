"""DART boosting (Dropouts meet Multiple Additive Regression Trees).

Port of lightgbm_tpu/boosting/dart.py (dart.hpp): each iteration drops a
set of earlier trees (`_dropping_trees`: uniform or in proportion to the
tree weights, dart.hpp:84-128) by walking each over the training rows
with its leaf values negated, trains the new tree on the gradients of
the scores without them, then rescales the dropped trees by k/(k+1) (or
the xgboost mode's factor) and walks them again over the training rows
and the valid sets (`_normalize`, dart.hpp:139-178).  The drops come
from `np.random.RandomState(drop_seed)`, the same draws as the JAX
package's.  DART has no boost-from-average tree and takes the
synchronous path of every iteration (boosting/gbdt.py).
"""
from __future__ import annotations

from typing import List

import numpy as np

from ..config import Config
from .gbdt import GBDT, _rng_state_from_json, _rng_state_to_json


class DART(GBDT):
    def __init__(self, config: Config, train_set=None, objective=None):
        super().__init__(config, train_set, objective)
        self.drop_rng = np.random.RandomState(config.drop_seed)
        self.tree_weight: List[float] = []
        self.sum_weight = 0.0
        self.drop_index: List[int] = []

    def sub_model_name(self) -> str:
        return "dart"

    def _extra_training_state(self):
        return {"drop_rng": _rng_state_to_json(self.drop_rng),
                "tree_weight": [float(w) for w in self.tree_weight],
                "sum_weight": float(self.sum_weight)}

    def _restore_extra_training_state(self, state):
        if "drop_rng" in state:
            self.drop_rng.set_state(_rng_state_from_json(state["drop_rng"]))
        self.tree_weight = [float(w) for w in state.get("tree_weight", [])]
        self.sum_weight = float(state.get("sum_weight", 0.0))

    def reset_training_data(self, train_set, objective=None):
        super().reset_training_data(train_set, objective)
        self.shrinkage_rate = self.config.learning_rate

    def train_one_iter(self, gradient=None, hessian=None,
                       is_eval: bool = False) -> bool:
        self._dropping_trees()
        stop = GBDT.train_one_iter(self, gradient, hessian, False)
        if not stop:
            self._normalize()
            self.tree_weight.append(self.shrinkage_rate)
            self.sum_weight += self.shrinkage_rate
            if is_eval:
                return self.eval_and_check_early_stopping()
        return stop

    def _boost_from_average(self):
        return  # dart.hpp has no boost-from-average tree

    # ------------------------------------------------------------------
    def _dropping_trees(self) -> None:
        cfg = self.config
        self.drop_index = []
        is_skip = self.drop_rng.random_sample() < cfg.skip_drop
        if not is_skip and self.iter_ > 0:
            drop_rate = cfg.drop_rate
            if not cfg.uniform_drop:
                inv_avg_w = len(self.tree_weight) / max(self.sum_weight, 1e-30)
                if cfg.max_drop > 0:
                    drop_rate = min(drop_rate,
                                    cfg.max_drop * inv_avg_w /
                                    max(self.sum_weight, 1e-30))
                for i in range(self.iter_):
                    if (self.drop_rng.random_sample()
                            < drop_rate * self.tree_weight[i] * inv_avg_w):
                        self.drop_index.append(i)
            else:
                if cfg.max_drop > 0:
                    drop_rate = min(drop_rate, cfg.max_drop / self.iter_)
                for i in range(self.iter_):
                    if self.drop_rng.random_sample() < drop_rate:
                        self.drop_index.append(i)
        # drop: each dropped tree, negated, walks onto the training scores
        for i in self.drop_index:
            for k in range(self.K):
                tree = self._model_at(i, k)
                tree.apply_shrinkage(-1.0)
                self.train_score.add_tree(tree, k)
        k_drop = len(self.drop_index)
        if not cfg.xgboost_dart_mode:
            self.shrinkage_rate = cfg.learning_rate / (1.0 + k_drop)
        elif k_drop == 0:
            self.shrinkage_rate = cfg.learning_rate
        else:
            self.shrinkage_rate = (cfg.learning_rate /
                                   (cfg.learning_rate + k_drop))

    def _model_at(self, iteration: int, k: int):
        off = 1 if self.boost_from_average_used else 0
        return self.models[off + iteration * self.K + k]

    def _normalize(self) -> None:
        cfg = self.config
        k = float(len(self.drop_index))
        for i in self.drop_index:
            for ci in range(self.K):
                tree = self._model_at(i, ci)
                if not cfg.xgboost_dart_mode:
                    # valid scores: tree * (-1 + k/(k+1)), net -1/(k+1)
                    tree.apply_shrinkage(1.0 / (k + 1.0))
                    for _, _, su, _ in self.valid_sets:
                        su.add_tree(tree, ci)
                    # training scores, at -1 since the drop: add the tree
                    # shrunk by -k, net +k/(k+1)
                    tree.apply_shrinkage(-k)
                    self.train_score.add_tree(tree, ci)
                else:
                    tree.apply_shrinkage(self.shrinkage_rate)
                    for _, _, su, _ in self.valid_sets:
                        su.add_tree(tree, ci)
                    tree.apply_shrinkage(-k / cfg.learning_rate)
                    self.train_score.add_tree(tree, ci)
            if not cfg.uniform_drop:
                if not cfg.xgboost_dart_mode:
                    self.sum_weight -= self.tree_weight[i] / (k + 1.0)
                    self.tree_weight[i] *= k / (k + 1.0)
                else:
                    self.sum_weight -= (self.tree_weight[i]
                                        / (k + cfg.learning_rate))
                    self.tree_weight[i] *= k / (k + cfg.learning_rate)
