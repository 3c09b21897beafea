"""Training callbacks (LightGBM's python-package/lightgbm/callback.py).

A copy of lightgbm_tpu/callback.py (standard library only).
"""
from __future__ import annotations

import collections
from typing import Callable, Dict, List

CallbackEnv = collections.namedtuple(
    "CallbackEnv",
    ["model", "params", "iteration", "begin_iteration", "end_iteration",
     "evaluation_result_list"])


class EarlyStopException(Exception):
    def __init__(self, best_iteration: int, best_score=None):
        super().__init__()
        self.best_iteration = best_iteration
        self.best_score = best_score


def _format_eval_result(value, show_stdv: bool = True) -> str:
    if len(value) == 4:
        return f"{value[0]}'s {value[1]}: {value[2]:g}"
    if len(value) == 5:
        if show_stdv:
            return f"{value[0]}'s {value[1]}: {value[2]:g} + {value[4]:g}"
        return f"{value[0]}'s {value[1]}: {value[2]:g}"
    raise ValueError("Wrong metric value")


def print_evaluation(period: int = 1, show_stdv: bool = True) -> Callable:
    def callback(env: CallbackEnv) -> None:
        if (period > 0 and env.evaluation_result_list
                and (env.iteration + 1) % period == 0):
            result = "\t".join(_format_eval_result(x, show_stdv)
                               for x in env.evaluation_result_list)
            print(f"[{env.iteration + 1}]\t{result}")
    callback.order = 10
    return callback


def record_evaluation(eval_result: Dict) -> Callable:
    if not isinstance(eval_result, dict):
        raise TypeError("eval_result should be a dictionary")
    eval_result.clear()

    def init(env: CallbackEnv) -> None:
        for data_name, eval_name, _, _ in env.evaluation_result_list:
            eval_result.setdefault(data_name, collections.OrderedDict())
            eval_result[data_name].setdefault(eval_name, [])

    def callback(env: CallbackEnv) -> None:
        if not eval_result:
            init(env)
        for data_name, eval_name, result, _ in env.evaluation_result_list:
            eval_result.setdefault(data_name, collections.OrderedDict())
            eval_result[data_name].setdefault(eval_name, [])
            eval_result[data_name][eval_name].append(result)
    callback.order = 20
    return callback


def reset_parameter(**kwargs) -> Callable:
    """Reset parameters on a schedule: value is a list (per iteration) or a
    function iteration -> value (reference callback.py:117-155)."""
    def callback(env: CallbackEnv) -> None:
        new_parameters = {}
        for key, value in kwargs.items():
            if key in ("num_class", "boosting_type", "metric"):
                raise RuntimeError(f"cannot reset {key} during training")
            if isinstance(value, list):
                if len(value) != env.end_iteration - env.begin_iteration:
                    raise ValueError(f"Length of list {key} has to equal "
                                     "num_boost_round")
                new_parameters[key] = value[env.iteration - env.begin_iteration]
            elif callable(value):
                new_parameters[key] = value(env.iteration - env.begin_iteration)
        if new_parameters:
            env.model.reset_parameter(new_parameters)
            env.params.update(new_parameters)
    callback.before_iteration = True
    callback.order = 10
    return callback


def early_stopping(stopping_rounds: int, verbose: bool = True) -> Callable:
    """Client-side early stopping (reference callback.py:155-204 /
    engine.py:188-199)."""
    best_score: List[float] = []
    best_iter: List[int] = []
    best_score_list: List = []
    cmp_op: List[Callable] = []

    def init(env: CallbackEnv) -> None:
        if not env.evaluation_result_list:
            raise ValueError("For early stopping, at least one dataset and "
                             "eval metric is required for evaluation")
        if verbose:
            print(f"Training until validation scores don't improve for "
                  f"{stopping_rounds} rounds.")
        for _ in env.evaluation_result_list:
            best_iter.append(0)
            best_score_list.append(None)
            best_score.append(float("-inf"))
            cmp_op.append(lambda x, y: x > y)

    def callback(env: CallbackEnv) -> None:
        if not best_score:
            init(env)
        for i, (d_name, m_name, result, higher_better) in enumerate(
                env.evaluation_result_list):
            score = result if higher_better else -result
            if best_score_list[i] is None or score > best_score[i]:
                best_score[i] = score
                best_iter[i] = env.iteration
                best_score_list[i] = env.evaluation_result_list
            elif env.iteration - best_iter[i] >= stopping_rounds:
                if d_name == "training":
                    continue
                env.model.best_iteration = best_iter[i] + 1
                if verbose:
                    print(f"Early stopping, best iteration is:\n"
                          f"[{best_iter[i] + 1}]\t"
                          + "\t".join(_format_eval_result(x)
                                      for x in best_score_list[i]))
                raise EarlyStopException(best_iter[i], best_score_list[i])
    callback.order = 30
    return callback
