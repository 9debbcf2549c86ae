"""Device-side tree traversal over binned data (counterpart of
lightgbm_tpu/core/predict.py).

Every row walks every tree of a stacked batch at once, one level per
step, as eager torch ops on ``[T, N]`` node tensors (reference:
Tree::AddPredictionToScore's inner traversal, tree.h:101-114).  The number
of levels is each tree's depth, computed on the host where the trees are
stacked, so the walk reads nothing back from the device.  Categorical
nodes test the row's bin in the node's bin-space bitset (reference:
Tree::CategoricalDecisionInner, tree.h:265-303).  Bins of an EFB-bundled
dataset (``phys``) are read from each node's physical column and decoded
to the feature's bins first.
"""
from __future__ import annotations

import torch

from .grower import decode_feature_col
from .splitter import split_decision


def walk_leaves(split_feature, threshold_bin, default_left, left_child,
                right_child, num_leaves, cat_bitset, bins, meta,
                depth: int, has_cat: bool, phys: bool = False):
    """Leaf index ``[T, N]`` (int64) of every row in each of T trees.

    Node tables are ``[T, M]`` (``split_feature``/``left_child``/
    ``right_child`` int64, ``threshold_bin`` int32, ``default_left``
    bool), ``num_leaves`` ``[T]``, ``cat_bitset`` ``[T, M, W]`` int32
    words (read only when ``has_cat``); ``bins`` ``[N, F]`` row-major in
    the bin space of ``meta`` (``[N, F_phys]`` physical columns with
    ``phys``); ``depth`` the deepest tree's levels."""
    T, N = split_feature.shape[0], bins.shape[0]
    node = torch.where(num_leaves > 1, 0, -1).to(torch.int64)[:, None]
    node = node.expand(T, N).contiguous()
    if has_cat:
        W = cat_bitset.shape[2]
        words = cat_bitset.reshape(T, -1)
    for _ in range(depth):
        nd = node.clamp(min=0)
        f = torch.gather(split_feature, 1, nd).clamp(min=0)
        fcol = meta.feat2phys[f].long() if phys else f
        col = torch.gather(bins, 1, fcol.t()).t().long()
        if phys:
            col = decode_feature_col(col, meta.feat_offset[f],
                                     meta.num_bins[f], meta.default_bins[f])
        go = split_decision(col, torch.gather(threshold_bin, 1, nd),
                            torch.gather(default_left, 1, nd),
                            meta.missing_types[f], meta.num_bins[f],
                            meta.default_bins[f])
        if has_cat:
            w = torch.gather(words, 1,
                             nd * W + torch.clamp(col // 32, max=W - 1))
            cat_go = ((w >> (col % 32)) & 1) != 0
            go = torch.where(meta.is_categorical[f], cat_go, go)
        nxt = torch.where(go, torch.gather(left_child, 1, nd),
                          torch.gather(right_child, 1, nd))
        node = torch.where(node >= 0, nxt, node)
    return ~node


def predict_leaf_bins(arrs, bins, meta, depth: int, has_cat: bool = False,
                      phys: bool = False):
    """Leaf index ``[N]`` of every row of a row-major binned matrix for one
    grower tree (``TreeArrays`` on the device); ``depth`` is the tree's
    level count, known on the host; ``phys`` reads a bundled dataset's
    physical columns (reference package: predict.py ``predict_leaf_bins``)."""
    def row(x, dtype=None):
        x = x[None, :]
        return x if dtype is None else x.to(dtype)
    return walk_leaves(
        row(arrs.split_feature, torch.int64), row(arrs.threshold_bin),
        row(arrs.default_left), row(arrs.left_child, torch.int64),
        row(arrs.right_child, torch.int64), arrs.num_leaves.reshape(1),
        arrs.cat_bitset[None], bins, meta, depth, has_cat=has_cat,
        phys=phys)[0]
