"""TreeSHAP feature contributions on the host (counterpart of
lightgbm_tpu/core/shap.py; reference: src/io/tree.cpp:609-716,
tree.h:331-358).

The f64 recursion over the value-space trees, row by row: the small-input
path of ``predict_contrib`` and the oracle of the batched device pass
(``explain/kernel.py``).  Returns ``[n, num_features + 1]`` (the last
column is the expected value), or ``[n, K * (num_features + 1)]`` for K
trees an iteration, like ``LGBM_BoosterPredictForMat`` with
``predict_contrib``.
"""
from __future__ import annotations

from typing import List

import numpy as np

from .tree import Tree


def _expected_value(tree: Tree) -> float:
    """(reference: Tree::ExpectedValue, tree.cpp:718-726)."""
    if tree.num_leaves == 1:
        return float(tree.leaf_value[0])
    total = float(tree.internal_count[0])
    if total <= 0:
        return 0.0
    return float(np.sum(tree.leaf_count[:tree.num_leaves]
                        * tree.leaf_value[:tree.num_leaves]) / total)


class _Path:
    __slots__ = ("feature_index", "zero_fraction", "one_fraction", "pweight")

    def __init__(self, f=-1, z=0.0, o=0.0, w=0.0):
        self.feature_index = f
        self.zero_fraction = z
        self.one_fraction = o
        self.pweight = w

    def copy(self):
        return _Path(self.feature_index, self.zero_fraction,
                     self.one_fraction, self.pweight)


def _extend(path: List[_Path], depth: int, zero: float, one: float, fi: int):
    path[depth].feature_index = fi
    path[depth].zero_fraction = zero
    path[depth].one_fraction = one
    path[depth].pweight = 1.0 if depth == 0 else 0.0
    for i in range(depth - 1, -1, -1):
        path[i + 1].pweight += one * path[i].pweight * (i + 1) / (depth + 1)
        path[i].pweight = zero * path[i].pweight * (depth - i) / (depth + 1)


def _unwind(path: List[_Path], depth: int, idx: int):
    one = path[idx].one_fraction
    zero = path[idx].zero_fraction
    nxt = path[depth].pweight
    for i in range(depth - 1, -1, -1):
        if one != 0:
            tmp = path[i].pweight
            path[i].pweight = nxt * (depth + 1) / ((i + 1) * one)
            nxt = tmp - path[i].pweight * zero * (depth - i) / (depth + 1)
        else:
            path[i].pweight = path[i].pweight * (depth + 1) / (zero * (depth - i))
    for i in range(idx, depth):
        path[i].feature_index = path[i + 1].feature_index
        path[i].zero_fraction = path[i + 1].zero_fraction
        path[i].one_fraction = path[i + 1].one_fraction


def _unwound_sum(path: List[_Path], depth: int, idx: int) -> float:
    one = path[idx].one_fraction
    zero = path[idx].zero_fraction
    nxt = path[depth].pweight
    total = 0.0
    for i in range(depth - 1, -1, -1):
        if one != 0:
            tmp = nxt * (depth + 1) / ((i + 1) * one)
            total += tmp
            nxt = path[i].pweight - tmp * zero * ((depth - i) / (depth + 1))
        else:
            total += (path[i].pweight / zero) / ((depth - i) / (depth + 1))
    return total


def _data_count(tree: Tree, node: int) -> float:
    return float(tree.leaf_count[~node] if node < 0
                 else tree.internal_count[node])


def _tree_shap(tree: Tree, x: np.ndarray, phi: np.ndarray, node: int,
               depth: int, parent_path: List[_Path], pzero: float,
               pone: float, pfi: int) -> None:
    path = [p.copy() for p in parent_path[:depth]]
    path += [_Path() for _ in range(depth + 1 - len(path))]
    _extend(path, depth, pzero, pone, pfi)

    if node < 0:
        for i in range(1, depth + 1):
            w = _unwound_sum(path, depth, i)
            el = path[i]
            phi[el.feature_index] += (w * (el.one_fraction - el.zero_fraction)
                                      * tree.leaf_value[~node])
        return

    fv = x[tree.split_feature[node]]
    go_left = bool(tree._decide(np.asarray([fv]), np.asarray([node]))[0])
    hot = int(tree.left_child[node] if go_left else tree.right_child[node])
    cold = int(tree.right_child[node] if go_left else tree.left_child[node])
    w = _data_count(tree, node)
    hot_zero = _data_count(tree, hot) / w
    cold_zero = _data_count(tree, cold) / w
    inc_zero, inc_one = 1.0, 1.0
    fi = int(tree.split_feature[node])
    path_index = next((i for i in range(depth + 1)
                       if path[i].feature_index == fi), depth + 1)
    if path_index != depth + 1:
        inc_zero = path[path_index].zero_fraction
        inc_one = path[path_index].one_fraction
        _unwind(path, depth, path_index)
        depth -= 1
    _tree_shap(tree, x, phi, hot, depth + 1, path, hot_zero * inc_zero,
               inc_one, fi)
    _tree_shap(tree, x, phi, cold, depth + 1, path, cold_zero * inc_zero,
               0.0, fi)


def predict_contrib(gbdt, X: np.ndarray, num_iteration=None,
                    start_iteration: int = 0) -> np.ndarray:
    """Per-row SHAP contributions (reference: GBDT::PredictContrib,
    gbdt_prediction.cpp + c_api predict_contrib path)."""
    X = np.ascontiguousarray(X, dtype=np.float64)
    n, f = X.shape
    K = gbdt.num_tpi
    n_iters = len(gbdt.models) // K
    stop = n_iters if num_iteration is None or num_iteration <= 0 \
        else min(start_iteration + num_iteration, n_iters)
    out = np.zeros((n, K, f + 1))
    for it in range(start_iteration, stop):
        for k in range(K):
            tree = gbdt.models[it * K + k]
            for r in range(n):
                out[r, k, f] += _expected_value(tree)
                if tree.num_leaves > 1:
                    _tree_shap(tree, X[r], out[r, k, :f], 0, 0, [], 1.0, 1.0, -1)
    return out.reshape(n, K * (f + 1)) if K > 1 else out[:, 0, :]
