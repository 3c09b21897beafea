"""train() — the training loop.

Port of lightgbm_tpu/engine.py `train` for this slice: parameters, a
training set, a number of rounds and validation sets, evaluated every
iteration, and `callbacks` called with a `CallbackEnv` as the JAX
package calls them (lightgbm_tpu/engine.py:111-160).  The callback
library (early stopping, printing, recording, learning-rate schedules),
init_model continuation, checkpoints and `cv` are later slices
(ROADMAP.md §A item 9).
"""
from __future__ import annotations

import collections
from typing import Any, Callable, Dict, List, Optional, Union

from .basic import Booster, Dataset

CallbackEnv = collections.namedtuple(
    "CallbackEnv",
    ["model", "params", "iteration", "begin_iteration", "end_iteration",
     "evaluation_result_list"])


def train(params: Dict[str, Any], train_set: Dataset,
          num_boost_round: int = 100,
          valid_sets: Optional[Union[Dataset, List[Dataset]]] = None,
          valid_names: Optional[List[str]] = None,
          evals_result: Optional[Dict] = None,
          callbacks: Optional[List[Callable]] = None) -> Booster:
    """Train a booster.  With valid sets, every iteration evaluates their
    metrics; `evals_result` (when given) collects them as
    {set name: {metric: [value per iteration]}}.  Each callback is called
    with a CallbackEnv before the iteration when its `before_iteration`
    attribute is true, else after the iteration's evaluation, in the
    order of their `order` attribute."""
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
    cbs = sorted(callbacks or [], key=lambda cb: getattr(cb, "order", 0))
    cbs_before = [cb for cb in cbs if getattr(cb, "before_iteration", False)]
    cbs_after = [cb for cb in cbs
                 if not getattr(cb, "before_iteration", False)]
    for i in range(num_boost_round):
        env = CallbackEnv(model=booster, params=params, iteration=i,
                          begin_iteration=0, end_iteration=num_boost_round,
                          evaluation_result_list=None)
        for cb in cbs_before:
            cb(env)
        finished = booster.update()
        if finished:
            break
        res = booster.eval_valid() if booster._valid_names else []
        if evals_result is not None:
            for set_name, metric, value, _ in res:
                evals_result.setdefault(set_name, {}).setdefault(
                    metric, []).append(value)
        env = env._replace(evaluation_result_list=res)
        for cb in cbs_after:
            cb(env)
    booster.best_iteration = booster.current_iteration()
    return booster
