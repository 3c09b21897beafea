"""train() — the training loop.

Port of lightgbm_tpu/engine.py `train` for this slice: parameters, a
training set, a number of rounds and validation sets, evaluated every
iteration.  Callbacks, early stopping, init_model continuation,
checkpoints and `cv` are later slices (ROADMAP.md §A item 9).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Union

from .basic import Booster, Dataset


def train(params: Dict[str, Any], train_set: Dataset,
          num_boost_round: int = 100,
          valid_sets: Optional[Union[Dataset, List[Dataset]]] = None,
          valid_names: Optional[List[str]] = None,
          evals_result: Optional[Dict] = None) -> Booster:
    """Train a booster.  With valid sets, every iteration evaluates their
    metrics; `evals_result` (when given) collects them as
    {set name: {metric: [value per iteration]}}."""
    params = dict(params or {})
    for alias in ("num_iterations", "num_iteration", "num_trees", "num_tree",
                  "num_rounds", "num_round"):
        if alias in params:
            num_boost_round = int(params.pop(alias))
            break
    booster = Booster(params=params, train_set=train_set)
    if valid_sets is not None:
        if isinstance(valid_sets, Dataset):
            valid_sets = [valid_sets]
        for i, vs in enumerate(valid_sets):
            if vs is train_set:
                continue
            name = (valid_names[i] if valid_names is not None
                    and i < len(valid_names) else f"valid_{i}")
            if vs.reference is None:
                vs.reference = train_set
            booster.add_valid(vs, name)
    for _ in range(num_boost_round):
        finished = booster.update()
        if finished:
            break
        if booster._valid_names:
            res = booster.eval_valid()
            if evals_result is not None:
                for set_name, metric, value, _ in res:
                    evals_result.setdefault(set_name, {}).setdefault(
                        metric, []).append(value)
    booster.best_iteration = booster.current_iteration()
    return booster
