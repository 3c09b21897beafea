"""train() / cv(): the callback-driven training loop.

Port of lightgbm_tpu/engine.py (LightGBM's python-package engine.py):
`train` with custom objectives and metrics, continuation from an init
model, early stopping, evaluation records, printing and learning-rate
schedules through the callbacks of callback.py, and checkpoint/resume
through `checkpoint_path`/`checkpoint_interval`; `cv` with (stratified)
folds.  Two repairs of the port stand where the JAX loop differs: the
training set given among `valid_sets` (or `is_training_metric`) is
evaluated under the name "training" ahead of the valid sets, and the
iteration that finds no split is evaluated and reported to the callbacks
before training stops (ROADMAP.md §C faults 3 and 4).
"""
from __future__ import annotations

import collections
from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np

from . import callback as callback_mod
from . import log
from .basic import Booster, Dataset
from .boosting.gbdt import load_checkpoint
from .callback import CallbackEnv, EarlyStopException

_ROUND_ALIASES = ("num_iterations", "num_iteration", "num_trees",
                  "num_tree", "num_rounds", "num_round")


def _raw_features(train_set: Dataset):
    """The raw feature values of a constructed training set: its matrix,
    or its text file's as `Dataset.from_file` reads them."""
    if train_set._raw_X is not None:
        return train_set._raw_X
    if not isinstance(train_set.data, str):
        return train_set.data
    from .dataset import Dataset as _InnerDataset, read_text_file
    if _InnerDataset._is_binary_file(train_set.data):
        raise log.LightGBMError(
            f"init_model needs raw feature values; {train_set.data} is a "
            "binary dataset")
    return read_text_file(train_set.data, train_set._inner.config)[0]


def train(params: Dict[str, Any], train_set: Dataset,
          num_boost_round: int = 100,
          valid_sets: Optional[Union[Dataset, List[Dataset]]] = None,
          valid_names: Optional[List[str]] = None,
          fobj: Optional[Callable] = None, feval: Optional[Callable] = None,
          init_model: Optional[Union[str, Booster]] = None,
          feature_name="auto", categorical_feature="auto",
          early_stopping_rounds: Optional[int] = None,
          evals_result: Optional[Dict] = None,
          verbose_eval: Union[bool, int] = True,
          learning_rates: Optional[Union[List[float], Callable]] = None,
          callbacks: Optional[List[Callable]] = None) -> Booster:
    """Train a booster.  Each iteration evaluates the valid sets (and the
    training set, named "training", when it is among `valid_sets` or
    `is_training_metric` is set), then calls the callbacks: those with a
    true `before_iteration` attribute before the iteration, the others
    after it, each group in the order of their `order` attribute.
    `verbose_eval`, `early_stopping_rounds`, `evals_result` and
    `learning_rates` add the callback library's print_evaluation,
    early_stopping, record_evaluation and reset_parameter."""
    params = dict(params or {})
    for alias in _ROUND_ALIASES:
        if alias in params:
            num_boost_round = int(params.pop(alias))
            break
    if fobj is not None:
        params["objective"] = params.get("objective", "regression")
    if feature_name != "auto":
        train_set.feature_name = feature_name
    if categorical_feature != "auto":
        train_set.categorical_feature = categorical_feature

    init_booster = None
    if init_model is not None:
        # continuation: the init model's raw predictions on the training
        # rows become their init score (the reference's _InnerPredictor)
        init_booster = (Booster(model_file=init_model, params=params)
                        if isinstance(init_model, str) else init_model)
        train_set.construct(params)
        init_raw = init_booster.predict(_raw_features(train_set),
                                        raw_score=True)
        train_set.set_init_score(
            np.asarray(init_raw, np.float64).T.reshape(-1))
    booster = Booster(params=params, train_set=train_set)
    if init_booster is not None:
        g, ig = booster._gbdt, init_booster._gbdt
        g.models = list(ig.models) + g.models
        g._models_changed()
        g.num_init_iteration = ig.current_iteration()
        g.boost_from_average_used = ig.boost_from_average_used

    # checkpoint/resume: before add_valid, so that the restored model
    # replays onto the valid scores too
    cfg = booster._gbdt.config
    start_round = 0
    resumed_early_stop = False
    if cfg.checkpoint_path:
        state = load_checkpoint(cfg.checkpoint_path)
        if state is not None:
            g = booster._gbdt
            start_round = g.resume_from_checkpoint(state, g.train_set,
                                                   g.objective)
            resumed_early_stop = state.get("finished") == "early_stop"
            if resumed_early_stop:
                # the early-stopped run kept its best iteration; the loop
                # below is skipped
                booster.best_iteration = int(state.get("best_iteration", 0))
            elif 0 < start_round < num_boost_round and (
                    early_stopping_rounds or any(
                        getattr(cb, "order", None) == 30
                        for cb in (callbacks or []))):
                log.warning(
                    "checkpoint resume cannot restore the early-stopping "
                    "callback's best-score history; it restarts at the "
                    "resume point, so the stopping round may differ from "
                    "an uninterrupted run")

    eval_train = bool(cfg.is_training_metric)
    if valid_sets is not None:
        if isinstance(valid_sets, Dataset):
            valid_sets = [valid_sets]
        for i, vs in enumerate(valid_sets):
            if vs is train_set:
                eval_train = True
                continue
            name = (valid_names[i] if valid_names is not None
                    and i < len(valid_names) else f"valid_{i}")
            if vs.reference is None:
                vs.reference = train_set
            booster.add_valid(vs, name)

    cbs = list(dict.fromkeys(callbacks or []))
    if verbose_eval is True:
        cbs.append(callback_mod.print_evaluation())
    elif isinstance(verbose_eval, int) and verbose_eval:
        cbs.append(callback_mod.print_evaluation(verbose_eval))
    if early_stopping_rounds is not None and early_stopping_rounds > 0:
        cbs.append(callback_mod.early_stopping(
            early_stopping_rounds, verbose=bool(verbose_eval)))
    if evals_result is not None:
        cbs.append(callback_mod.record_evaluation(evals_result))
    if learning_rates is not None:
        cbs.append(callback_mod.reset_parameter(learning_rate=learning_rates))
    cbs.sort(key=lambda cb: getattr(cb, "order", 0))
    cbs_before = [cb for cb in cbs if getattr(cb, "before_iteration", False)]
    cbs_after = [cb for cb in cbs
                 if not getattr(cb, "before_iteration", False)]

    # a checkpointed run that already stopped early keeps its result: the
    # early-stopping callback's state is not in the checkpoint
    if resumed_early_stop:
        start_round = num_boost_round
    stopped_early = resumed_early_stop
    for i in range(start_round, num_boost_round):
        env = CallbackEnv(model=booster, params=params, iteration=i,
                          begin_iteration=0, end_iteration=num_boost_round,
                          evaluation_result_list=None)
        for cb in cbs_before:
            cb(env)
        finished = booster.update(fobj=fobj)
        if (cfg.checkpoint_path and cfg.checkpoint_interval > 0
                and (i + 1) % cfg.checkpoint_interval == 0):
            booster._gbdt.save_checkpoint(cfg.checkpoint_path)
        res = booster.eval_train(feval) if eval_train else []
        if booster._valid_names:
            res += booster.eval_valid(feval)
        env = env._replace(evaluation_result_list=res)
        try:
            for cb in cbs_after:
                cb(env)
        except EarlyStopException as e:
            booster.best_iteration = e.best_iteration + 1
            stopped_early = True
            break
        if finished:
            break
    if cfg.checkpoint_path and cfg.checkpoint_interval > 0:
        # the final snapshot: a rerun of this finished call resumes past
        # the loop instead of training the tail since the last one again
        booster._gbdt.save_checkpoint(cfg.checkpoint_path, extra={
            "finished": "early_stop" if stopped_early else "complete",
            "best_iteration": int(booster.best_iteration)})
    if booster.best_iteration <= 0:
        booster.best_iteration = booster.current_iteration()
    return booster


def _make_n_folds(full_data: Dataset, nfold: int, params, seed: int,
                  stratified: bool = False, shuffle: bool = True):
    full_data.construct(params)
    num_data = full_data.num_data()
    rng = np.random.RandomState(seed)
    if stratified:
        label = np.asarray(full_data.get_label())
        if shuffle:
            # a random order within each label class, then round-robin:
            # folds stay stratified, their members drawn at random
            order = np.lexsort((rng.permutation(num_data), label))
        else:
            order = np.argsort(label, kind="stable")
        folds_idx = [order[i::nfold] for i in range(nfold)]
    else:
        idx = np.arange(num_data)
        if shuffle:
            rng.shuffle(idx)
        folds_idx = np.array_split(idx, nfold)
    for k in range(nfold):
        test_idx = np.sort(np.asarray(folds_idx[k]))
        train_mask = np.ones(num_data, bool)
        train_mask[test_idx] = False
        train_idx = np.flatnonzero(train_mask)
        yield train_idx, test_idx


def cv(params: Dict[str, Any], train_set: Dataset, num_boost_round: int = 10,
       folds=None, nfold: int = 5, stratified: bool = False,
       shuffle: bool = True, metrics=None, fobj=None, feval=None,
       init_model=None, feature_name="auto", categorical_feature="auto",
       early_stopping_rounds=None, fpreproc=None, verbose_eval=None,
       show_stdv: bool = True, seed: int = 0,
       callbacks=None) -> Dict[str, List[float]]:
    """K-fold cross validation (LightGBM's engine.py:279+).  Returns
    {metric-mean: [...], metric-stdv: [...]}, one value an iteration; with
    early stopping, cut at the best iteration of the first metric whose
    window ran out."""
    params = dict(params or {})
    if metrics is not None:
        params["metric"] = metrics
    train_set.construct(params)
    if folds is None:
        folds = list(_make_n_folds(train_set, nfold, params, seed, stratified,
                                   shuffle))
    boosters = []
    for train_idx, test_idx in folds:
        tr = train_set.subset(train_idx, params)
        te = train_set.subset(test_idx, params)
        if fpreproc is not None:
            tr, te, params = fpreproc(tr, te, params.copy())
        bst = Booster(params=params, train_set=tr)
        bst.add_valid(te, "valid")
        boosters.append(bst)

    results = collections.defaultdict(list)
    best_score: Dict[str, float] = {}
    best_it: Dict[str, int] = {}
    for i in range(num_boost_round):
        agg = collections.defaultdict(list)
        for bst in boosters:
            bst.update(fobj=fobj)
            for _, name, val, hib in bst.eval_valid(feval):
                agg[(name, hib)].append(val)
        line = {}
        for (name, hib), vals in agg.items():
            mean, std = float(np.mean(vals)), float(np.std(vals))
            results[name + "-mean"].append(mean)
            results[name + "-stdv"].append(std)
            line[(name, hib)] = mean
        if verbose_eval:
            msg = "\t".join(f"cv_agg {n}-mean: {results[n + '-mean'][-1]:g}"
                            for n in set(k[0] for k in agg))
            print(f"[{i + 1}]\t{msg}")
        if early_stopping_rounds:
            # per-metric bests; the first metric in eval order whose
            # window without improvement runs out stops the run, and
            # every history is cut at that metric's best iteration
            stop_at = None
            for (name, hib), mean in line.items():
                score = mean if hib else -mean
                if name not in best_score or score > best_score[name]:
                    best_score[name] = score
                    best_it[name] = i
                elif i - best_it[name] >= early_stopping_rounds:
                    stop_at = best_it[name] + 1
                    break
            if stop_at is not None:
                for key in results:
                    del results[key][stop_at:]
                break
    return dict(results)
