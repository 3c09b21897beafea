"""Plotting utilities (the reference's python-package plotting.py):
feature importance, metric curves during training, tree structure.

A copy of lightgbm_tpu/plotting.py over the port's Booster.  matplotlib
is needed for plot_*, graphviz for create_tree_digraph/plot_tree; both
are imported when a function is called (a clear ImportError where one is
missing), never when this module is.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from .basic import Booster
from .sklearn import LGBMModel


def _check_matplotlib():
    try:
        import matplotlib.pyplot as plt  # noqa: F401
        return plt
    except ImportError as e:  # pragma: no cover
        raise ImportError("matplotlib is required for plotting") from e


def _to_booster(booster) -> Booster:
    if isinstance(booster, LGBMModel):
        return booster.booster_
    if isinstance(booster, Booster):
        return booster
    raise TypeError("booster must be a Booster or LGBMModel")


def plot_importance(booster, ax=None, height: float = 0.2,
                    xlim: Optional[Tuple] = None, ylim: Optional[Tuple] = None,
                    title: str = "Feature importance",
                    xlabel: str = "Feature importance",
                    ylabel: str = "Features", max_num_features: Optional[int] = None,
                    ignore_zero: bool = True, grid: bool = True, **kwargs):
    """Horizontal bar plot of split-count feature importance
    (reference plotting.py:22-106)."""
    plt = _check_matplotlib()
    bst = _to_booster(booster)
    importance = bst.feature_importance()
    names = bst.feature_name()
    tuples = sorted(zip(names, importance), key=lambda x: x[1])
    if ignore_zero:
        tuples = [t for t in tuples if t[1] > 0]
    if max_num_features is not None and max_num_features > 0:
        tuples = tuples[-max_num_features:]
    if not tuples:
        raise ValueError("cannot plot importance: no nonzero importances")
    labels, values = zip(*tuples)

    if ax is None:
        _, ax = plt.subplots(1, 1)
    ylocs = np.arange(len(values))
    ax.barh(ylocs, values, align="center", height=height, **kwargs)
    for x, y in zip(values, ylocs):
        ax.text(x + 1, y, str(int(x)), va="center")
    ax.set_yticks(ylocs)
    ax.set_yticklabels(labels)
    if xlim is not None:
        ax.set_xlim(xlim)
    if ylim is not None:
        ax.set_ylim(ylim)
    else:
        ax.set_ylim(-1, len(values))
    ax.set_title(title)
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    ax.grid(grid)
    return ax


def plot_metric(booster_or_evals_result, metric: Optional[str] = None,
                dataset_names: Optional[List[str]] = None, ax=None,
                xlim=None, ylim=None, title: str = "Metric during training",
                xlabel: str = "Iterations", ylabel: str = "auto",
                grid: bool = True):
    """Plot recorded eval results (reference plotting.py:109-200).  Accepts
    the dict produced by `evals_result`/`record_evaluation` or a fitted
    sklearn model with `evals_result_`."""
    plt = _check_matplotlib()
    if isinstance(booster_or_evals_result, LGBMModel):
        eval_results = booster_or_evals_result.evals_result_
    elif isinstance(booster_or_evals_result, dict):
        eval_results = booster_or_evals_result
    else:
        raise TypeError("plot_metric needs an evals_result dict or a "
                        "fitted sklearn model")
    if not eval_results:
        raise ValueError("eval results are empty")
    if ax is None:
        _, ax = plt.subplots(1, 1)
    names = dataset_names or list(eval_results.keys())
    if names[0] not in eval_results:
        raise ValueError(f"dataset {names[0]!r} not in eval results "
                         f"(have: {list(eval_results)})")
    msets = eval_results[names[0]]
    if metric is None:
        metric = next(iter(msets.keys()))
    for name in names:
        if metric in eval_results.get(name, {}):
            results = eval_results[name][metric]
            ax.plot(range(1, len(results) + 1), results, label=name)
    ax.legend(loc="best")
    if xlim is not None:
        ax.set_xlim(xlim)
    if ylim is not None:
        ax.set_ylim(ylim)
    ax.set_title(title)
    ax.set_xlabel(xlabel)
    ax.set_ylabel(metric if ylabel == "auto" else ylabel)
    ax.grid(grid)
    return ax


def create_tree_digraph(booster, tree_index: int = 0, show_info=None,
                        name=None, comment=None, **kwargs):
    """Graphviz digraph of one tree (reference plotting.py:203-300)."""
    try:
        from graphviz import Digraph
    except ImportError as e:
        raise ImportError("graphviz is required for tree plotting") from e
    bst = _to_booster(booster)
    model = bst.dump_model()
    if tree_index >= len(model["tree_info"]):
        raise IndexError(f"tree_index {tree_index} out of range")
    tree_info = model["tree_info"][tree_index]
    show_info = show_info or []
    graph = Digraph(name=name, comment=comment, **kwargs)

    def add(node, parent=None, decision=None):
        if "split_index" in node:
            nid = f"split{node['split_index']}"
            # dump_model carries the reference's JSON type names
            # ("no_greater"/"is", tree.cpp:347); plot the operator symbol
            op = {"no_greater": "<=", "is": "=="}.get(
                node.get("decision_type"), "<=")
            label = (f"feature {node['split_feature']}\n"
                     f"{op} {node['threshold']:g}")
            if "split_gain" in show_info:
                label += f"\ngain: {node['split_gain']:g}"
            if "internal_count" in show_info and "internal_count" in node:
                label += f"\ncount: {node['internal_count']}"
            graph.node(nid, label=label)
            add(node["left_child"], nid, "yes")
            add(node["right_child"], nid, "no")
        else:
            nid = f"leaf{node['leaf_index']}"
            label = f"leaf {node['leaf_index']}: {node['leaf_value']:g}"
            if "leaf_count" in show_info and "leaf_count" in node:
                label += f"\ncount: {node['leaf_count']}"
            graph.node(nid, label=label)
        if parent is not None:
            graph.edge(parent, nid, decision)

    add(tree_info["tree_structure"])
    return graph


def plot_tree(booster, tree_index: int = 0, ax=None, figsize=None,
              show_info=None, **kwargs):
    """Render one tree into a matplotlib axis via graphviz
    (reference plotting.py:303-427)."""
    plt = _check_matplotlib()
    graph = create_tree_digraph(booster, tree_index=tree_index,
                                show_info=show_info, **kwargs)
    import io
    try:
        s = graph.pipe(format="png")
    except Exception as e:  # pragma: no cover - graphviz binary missing
        raise RuntimeError("graphviz executable is required to render "
                           "trees") from e
    import matplotlib.image as mpimg
    if ax is None:
        _, ax = plt.subplots(1, 1, figsize=figsize)
    img = mpimg.imread(io.BytesIO(s))
    ax.imshow(img)
    ax.axis("off")
    return ax
