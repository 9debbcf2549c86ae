"""Plotting utilities (counterpart of lightgbm_tpu/plotting.py; reference:
python-package/lightgbm/plotting.py, with its public signatures).
matplotlib draws, graphviz is optional for tree digraphs; everything
here reads host data of the booster and nothing touches the card."""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from .basic import Booster


def _check_not_tuple_of_2_elements(obj, obj_name: str) -> None:
    if not isinstance(obj, tuple) or len(obj) != 2:
        raise TypeError(f"{obj_name} must be a tuple of 2 elements.")


def _to_booster(booster) -> Booster:
    from .sklearn import LGBMModel
    if isinstance(booster, LGBMModel):
        return booster.booster_
    if isinstance(booster, Booster):
        return booster
    raise TypeError("booster must be Booster or LGBMModel.")


def plot_importance(booster, ax=None, height: float = 0.2, xlim=None,
                    ylim=None, title="Feature importance",
                    xlabel="Feature importance", ylabel="Features",
                    importance_type="split", max_num_features=None,
                    ignore_zero=True, figsize=None, dpi=None, grid=True,
                    precision=3, **kwargs):
    """(reference: plotting.py:23-137 plot_importance)."""
    import matplotlib.pyplot as plt

    bst = _to_booster(booster)
    importance = np.asarray(bst.feature_importance(importance_type))
    names = bst.feature_name()
    if not len(importance):
        raise ValueError("Booster's feature_importance is empty.")

    tuples: List[Tuple[str, float]] = sorted(
        zip(names, importance), key=lambda x: x[1])
    if ignore_zero:
        tuples = [t for t in tuples if t[1] > 0]
    if max_num_features is not None and max_num_features > 0:
        tuples = tuples[-max_num_features:]
    if not tuples:
        raise ValueError("No features with non-zero importance.")
    labels, values = zip(*tuples)

    if ax is None:
        if figsize is not None:
            _check_not_tuple_of_2_elements(figsize, "figsize")
        _, ax = plt.subplots(1, 1, figsize=figsize, dpi=dpi)
    ylocs = np.arange(len(values))
    ax.barh(ylocs, values, align="center", height=height, **kwargs)
    for x, y in zip(values, ylocs):
        ax.text(x + 1, y,
                f"{x:.{precision}f}" if importance_type == "gain" else str(int(x)),
                va="center")
    ax.set_yticks(ylocs)
    ax.set_yticklabels(labels)
    if xlim is not None:
        _check_not_tuple_of_2_elements(xlim, "xlim")
    else:
        xlim = (0, max(values) * 1.1)
    ax.set_xlim(xlim)
    if ylim is not None:
        _check_not_tuple_of_2_elements(ylim, "ylim")
    else:
        ylim = (-1, len(values))
    ax.set_ylim(ylim)
    if title is not None:
        ax.set_title(title)
    if xlabel is not None:
        ax.set_xlabel(xlabel)
    if ylabel is not None:
        ax.set_ylabel(ylabel)
    ax.grid(grid)
    return ax


def plot_metric(booster, metric: Optional[str] = None,
                dataset_names: Optional[List[str]] = None, ax=None,
                xlim=None, ylim=None, title="Metric during training",
                xlabel="Iterations", ylabel="auto", figsize=None, dpi=None,
                grid=True):
    """(reference: plotting.py:140-260 plot_metric)."""
    import matplotlib.pyplot as plt

    if isinstance(booster, Booster):
        raise TypeError("booster must be dict or LGBMModel; pass "
                        "evals_result from train() or a fitted sklearn "
                        "estimator.")
    from .sklearn import LGBMModel
    if isinstance(booster, LGBMModel):
        eval_results = booster.evals_result_
    elif isinstance(booster, dict):
        eval_results = booster
    else:
        raise TypeError("booster must be dict or LGBMModel.")
    if not eval_results:
        raise ValueError("eval results cannot be empty.")

    if ax is None:
        if figsize is not None:
            _check_not_tuple_of_2_elements(figsize, "figsize")
        _, ax = plt.subplots(1, 1, figsize=figsize, dpi=dpi)

    names = dataset_names or list(eval_results.keys())
    first = eval_results[names[0]]
    if metric is None:
        metric = next(iter(first))
    num_iters = 0
    for name in names:
        if metric not in eval_results[name]:
            continue
        vals = eval_results[name][metric]
        num_iters = max(num_iters, len(vals))
        ax.plot(range(len(vals)), vals, label=name)
    ax.legend(loc="best")
    if xlim is not None:
        _check_not_tuple_of_2_elements(xlim, "xlim")
    else:
        xlim = (0, num_iters)
    ax.set_xlim(xlim)
    if ylim is not None:
        _check_not_tuple_of_2_elements(ylim, "ylim")
        ax.set_ylim(ylim)
    if ylabel == "auto":
        ylabel = metric
    if title is not None:
        ax.set_title(title)
    if xlabel is not None:
        ax.set_xlabel(xlabel)
    if ylabel is not None:
        ax.set_ylabel(ylabel)
    ax.grid(grid)
    return ax


def plot_split_value_histogram(booster, feature, bins=None, ax=None,
                               width_coef: float = 0.8, xlim=None, ylim=None,
                               title="Split value histogram for feature with "
                                     "@index/name@ @feature@",
                               xlabel="Feature split value", ylabel="Count",
                               figsize=None, dpi=None, grid=True, **kwargs):
    """(reference: plotting.py:263-366)."""
    import matplotlib.pyplot as plt

    bst = _to_booster(booster)
    if isinstance(feature, str) and feature not in bst.feature_name():
        raise ValueError(f"feature {feature!r} not found")
    hist, bin_edges = bst.get_split_value_histogram(
        feature, bins="auto" if bins is None else bins)
    if hist.sum() == 0:
        raise ValueError("Cannot plot split value histogram, the feature "
                         "was never used for splitting.")
    if ax is None:
        if figsize is not None:
            _check_not_tuple_of_2_elements(figsize, "figsize")
        _, ax = plt.subplots(1, 1, figsize=figsize, dpi=dpi)
    width = width_coef * (bin_edges[1] - bin_edges[0])
    centers = (bin_edges[:-1] + bin_edges[1:]) / 2.0
    ax.bar(centers, hist, width=width, **kwargs)
    if title is not None:
        title = title.replace("@index/name@",
                              "name" if isinstance(feature, str) else "index")
        title = title.replace("@feature@", str(feature))
        ax.set_title(title)
    if xlabel is not None:
        ax.set_xlabel(xlabel)
    if ylabel is not None:
        ax.set_ylabel(ylabel)
    ax.grid(grid)
    return ax


def _tree_to_digraph(tree, feature_names, precision: int = 3, **kwargs):
    import graphviz
    graph = graphviz.Digraph(**kwargs)

    def node_name(i, leaf):
        return f"leaf{i}" if leaf else f"split{i}"

    def add(i, leaf, parent=None, decision=None):
        if leaf:
            label = f"leaf {i}: {tree.leaf_value[i]:.{precision}f}"
            graph.node(node_name(i, True), label=label)
        else:
            f = int(tree.split_feature[i])
            fname = (feature_names[f] if feature_names
                     and f < len(feature_names) else f"Column_{f}")
            if tree.is_categorical(i):
                label = f"{fname} in categories"
            else:
                label = f"{fname} <= {tree.threshold[i]:.{precision}f}"
            graph.node(node_name(i, False), label=label, shape="rectangle")
            for child, dec in ((int(tree.left_child[i]), "yes"),
                               (int(tree.right_child[i]), "no")):
                if child >= 0:
                    add(child, False, node_name(i, False), dec)
                else:
                    add(~child, True, node_name(i, False), dec)
        if parent is not None:
            graph.edge(parent, node_name(i, leaf), decision)

    if tree.num_leaves <= 1:
        add(0, True)
    else:
        add(0, False)
    return graph


def create_tree_digraph(booster, tree_index: int = 0, show_info=None,
                        precision: int = 3, **kwargs):
    """(reference: plotting.py:473-540)."""
    bst = _to_booster(booster)
    models = list(bst._gbdt.models)
    if not 0 <= tree_index < len(models):
        raise IndexError("tree_index is out of range.")
    return _tree_to_digraph(models[tree_index], bst.feature_name(),
                            precision, **kwargs)


def plot_tree(booster, ax=None, tree_index: int = 0, figsize=None, dpi=None,
              show_info=None, precision: int = 3, **kwargs):
    """(reference: plotting.py:369-470) — renders the graphviz digraph into
    a matplotlib axes (needs the graphviz binary)."""
    import matplotlib.image as mpimg
    import matplotlib.pyplot as plt

    graph = create_tree_digraph(booster, tree_index=tree_index,
                                precision=precision, **kwargs)
    if ax is None:
        if figsize is not None:
            _check_not_tuple_of_2_elements(figsize, "figsize")
        _, ax = plt.subplots(1, 1, figsize=figsize, dpi=dpi)
    import io as _io
    s = _io.BytesIO(graph.pipe(format="png"))
    img = mpimg.imread(s)
    ax.imshow(img)
    ax.axis("off")
    return ax
