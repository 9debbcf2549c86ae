"""A reader of LightGBM's model text (the ``Tree=`` blocks), written for the
benchmark's reference: it imports nothing of the program under test."""
from __future__ import annotations

import numpy as np

_INT_KEYS = ("split_feature", "decision_type", "left_child", "right_child",
             "leaf_count", "internal_count")
_FLOAT_KEYS = ("split_gain", "threshold", "leaf_value", "leaf_weight",
               "internal_value", "internal_weight")


def parse_trees(text: str) -> list:
    """One dict per tree: ``num_leaves``, ``shrinkage`` and each array of
    the block (int64 or float64), in the order of the text."""
    trees = []
    cur = None
    for line in text.splitlines():
        if line.startswith("Tree="):
            cur = {}
            trees.append(cur)
            continue
        if cur is None or "=" not in line:
            if line.startswith("end of trees"):
                break
            continue
        key, val = line.split("=", 1)
        if key == "num_leaves":
            cur["num_leaves"] = int(val)
        elif key == "shrinkage":
            cur["shrinkage"] = float(val)
        elif key in _INT_KEYS:
            cur[key] = np.array(val.split(), dtype=np.int64)
        elif key in _FLOAT_KEYS:
            cur[key] = np.array(val.split(), dtype=np.float64)
    return trees


def depth(tree: dict) -> int:
    """Edges on the longest path from the root to a leaf."""
    if tree["num_leaves"] <= 1:
        return 0
    best, stack = 0, [(0, 1)]
    while stack:
        node, d = stack.pop()
        best = max(best, d)
        for child in (tree["left_child"][node], tree["right_child"][node]):
            if child >= 0:
                stack.append((child, d + 1))
    return best


def parents(tree: dict):
    """(parent of each internal node, parent of each leaf); -1 at the root."""
    nn = tree["num_leaves"] - 1
    p_int = np.full(nn, -1, np.int64)
    p_leaf = np.full(tree["num_leaves"], -1, np.int64)
    for node in range(nn):
        for child in (tree["left_child"][node], tree["right_child"][node]):
            if child >= 0:
                p_int[child] = node
            else:
                p_leaf[~child] = node
    return p_int, p_leaf
