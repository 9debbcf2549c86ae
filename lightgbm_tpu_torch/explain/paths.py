"""Host-side path metadata for the device TreeSHAP pass (counterpart of
lightgbm_tpu/explain/paths.py).

TreeSHAP decomposes a tree into its root->leaf paths: every leaf
contributes to every row, weighted by how much of the training data
follows the path (the *zero fractions*, row-independent) and whether the
row itself follows it (the *one fractions*, row-dependent indicators).
Everything row-independent is precomputed here at pack time:

- the path node/direction list per leaf (fixed depth ``P``, padded);
- duplicate-feature merging: the recursion's UNWIND-then-EXTEND for a
  feature met twice on a path is equivalent to ONE merged path element
  whose zero fraction is the product of the occurrences' fractions and
  whose one fraction is the AND of their indicators (the reference does
  exactly this incrementally, tree.cpp:668-676).  Each path edge maps to
  a merged *slot*; unused slots carry the identity element ``(z=1, o=1)``
  — a null player that provably leaves every other feature's Shapley
  value unchanged, which is what makes a fixed-width slot array exact;
- per-slot merged zero fractions from ``internal_count``/``leaf_count``
  (reference: tree.cpp:646-650 hot/cold zero fractions);
- the per-tree expected value (reference: Tree::ExpectedValue,
  tree.cpp:718-726) for the ``F+1``-th output column.

The unit of work is the per-tree numpy dict ``stack_forest`` batches,
made with ``ServeBinSpace.tree_arrays_np(tree, with_counts=True)``;
``stack_explain`` returns torch tensors on the forest's device.
"""
from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch


class ExplainArrays(NamedTuple):
    """Stacked [T, ...] path metadata, one entry per forest tree.

    ``P`` is the forest-wide maximum path length (edges); a leaf's
    merged slots come first and the rest are identity pads, which the
    torch pass skips (``num_slots``)."""
    path_node: torch.Tensor     # i64 [T, L, P] internal node at depth p
    #                             (-1 pad)
    path_left: torch.Tensor     # bool [T, L, P] path takes the left child
    path_slot: torch.Tensor     # i64 [T, L, P] merged-slot index of the edge
    slot_feature: torch.Tensor  # i64 [T, L, P] contribution column (F for
    #                             pads)
    slot_zero: torch.Tensor     # f32 [T, L, P] merged zero fraction (1.0
    #                             pads)
    leaf_value: torch.Tensor    # f32 [T, L]
    expected: torch.Tensor      # f32 [T] per-tree expected value
    num_slots: torch.Tensor     # i64 [T, L] each leaf's merged slots
    max_slots: np.ndarray       # i64 [T], on the host: a tree's largest
    #                             num_slots (its loops' length)


def _node_count(t: dict, node: int) -> float:
    return float(t["leaf_count"][~node] if node < 0
                 else t["internal_count"][node])


def tree_path_arrays(t: dict, num_features: int) -> dict:
    """Per-leaf path metadata for ONE tree dict (with counts).

    Returns numpy arrays shaped [num_leaves, P_tree] (P_tree = this
    tree's longest path) plus the scalar expected value; ``stack_explain``
    pads across the forest.  ``num_features`` sizes the pad slots'
    contribution column (the expected-value column, where their exactly-
    zero contributions land harmlessly)."""
    nl = int(t["num_leaves"])
    nn = max(nl - 1, 0)
    if nl > 1 and _node_count(t, 0) <= 0:
        raise ValueError(
            "tree carries no internal_count/leaf_count cover counts — "
            "TreeSHAP needs them (a model file without leaf counts "
            "cannot be explained)")

    # root->leaf paths by explicit DFS (children < 0 encode leaves as
    # ~leaf_index, like TreeArrays)
    paths: List[list] = [[] for _ in range(max(nl, 1))]
    if nn:
        stack = [(0, [])]
        while stack:
            node, prefix = stack.pop()
            cnt = _node_count(t, node)
            feat = int(t["split_feature"][node])
            for child, left in ((int(t["left_child"][node]), True),
                                (int(t["right_child"][node]), False)):
                zero = _node_count(t, child) / cnt
                edge = (node, left, feat, zero)
                if child < 0:
                    paths[~child] = prefix + [edge]
                else:
                    stack.append((child, prefix + [edge]))

    P = max((len(p) for p in paths), default=0)
    L = max(nl, 1)
    path_node = np.full((L, max(P, 1)), -1, np.int32)
    path_left = np.zeros((L, max(P, 1)), bool)
    # pad edges map to their own slot, which stays the (z=1, o=1)
    # identity the kernel extends with
    path_slot = np.tile(np.arange(max(P, 1), dtype=np.int32), (L, 1))
    slot_feature = np.full((L, max(P, 1)), num_features, np.int32)
    slot_zero = np.ones((L, max(P, 1)), np.float32)
    for leaf, p in enumerate(paths):
        slots: dict = {}
        for d, (node, left, feat, zero) in enumerate(p):
            path_node[leaf, d] = node
            path_left[leaf, d] = left
            u = slots.setdefault(feat, len(slots))
            path_slot[leaf, d] = u
            slot_feature[leaf, u] = feat
            slot_zero[leaf, u] *= zero

    if nl <= 1:
        expected = float(t["leaf_value"][0])
    else:
        total = _node_count(t, 0)
        expected = float(np.dot(t["leaf_count"][:nl].astype(np.float64),
                                t["leaf_value"][:nl].astype(np.float64))
                         / total)
    return dict(path_node=path_node, path_left=path_left,
                path_slot=path_slot, slot_feature=slot_feature,
                slot_zero=slot_zero,
                leaf_value=np.asarray(t["leaf_value"][:nl], np.float32),
                expected=np.float32(expected))


def stack_explain(trees_np: list, num_features: int,
                  device="cpu") -> ExplainArrays:
    """Stack per-tree path metadata into one batch on ``device``, padded
    to the forest's widest tree / deepest path."""
    per_tree = [tree_path_arrays(t, num_features) for t in trees_np]
    T = len(per_tree)
    L = max(p["path_node"].shape[0] for p in per_tree)
    P = max(p["path_node"].shape[1] for p in per_tree)

    def batch(key, fill, dtype):
        out = np.full((T, L, P), fill, dtype=dtype)
        for i, p in enumerate(per_tree):
            a = p[key]
            out[i, :a.shape[0], :a.shape[1]] = a
        return out

    path_slot = batch("path_slot", 0, np.int32)
    for i, p in enumerate(per_tree):
        # re-pad the widened depth range with identity self-slots (the
        # per-tree arrays only covered their own P_tree)
        w = p["path_slot"].shape[1]
        path_slot[i, :, w:] = np.arange(w, P, dtype=np.int32)[None, :]
        path_slot[i, p["path_node"].shape[0]:, :w] = \
            np.arange(w, dtype=np.int32)[None, :]

    leaf_value = np.zeros((T, L), np.float32)
    for i, p in enumerate(per_tree):
        leaf_value[i, :len(p["leaf_value"])] = p["leaf_value"]

    # a leaf's merged slots are its first ones; the rest are pads
    slots = (batch("slot_feature", num_features, np.int32)
             < num_features).sum(axis=2)

    def t(a, dtype=None):
        a = np.asarray(a) if dtype is None else np.asarray(a, dtype)
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return ExplainArrays(
        path_node=t(batch("path_node", -1, np.int32), np.int64),
        path_left=t(batch("path_left", False, np.bool_)),
        path_slot=t(path_slot, np.int64),
        slot_feature=t(batch("slot_feature", num_features, np.int32),
                       np.int64),
        slot_zero=t(batch("slot_zero", 1.0, np.float32)),
        leaf_value=t(leaf_value),
        expected=t(np.asarray([p["expected"] for p in per_tree],
                              np.float32)),
        num_slots=t(slots, np.int64),
        max_slots=slots.max(axis=1, initial=0).astype(np.int64),
    )
