"""Device batch prediction over a whole forest (counterpart of
lightgbm_tpu/core/forest.py: ``ForestArrays``, ``stack_forest``,
``forest_predict_fn``, ``arena_predict_fn``, ``forest_leaf_fn``).

The reference predicts row by row on the CPU, tree at a time (reference:
src/boosting/gbdt_prediction.cpp:1-91, tree.h:447-530); the JAX package
runs one jitted ``lax.scan`` over stacked trees.  Here the forest's
per-tree arrays are stacked into ``[T, ...]`` tensors once, and every tree
steps all rows level by level together (``core/predict.py``
``walk_leaves``): the launches grow with the deepest tree's level count,
not with the number of trees.  Rows are walked in chunks so the ``[T, n]``
node tensors stay within ``_CHUNK_ELEMS``.  The leaf values are then
added in tree order as a Kahan-compensated f32 sum of separate eager ops
(never ``torch.compile``d, which could fold the compensation away), with
the reference's margin early stop (prediction_early_stop.cpp:1-88) checked
every ``round_period * K`` trees.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .predict import walk_leaves
from .tree import tree_depth

# node-tensor elements ([T, n] int64) per row chunk: ~128 MB each
_CHUNK_ELEMS = 1 << 24

# device forest calls by kind; chip_smoke.py reads them to show that a
# predict went through the device path
calls = {"predict": 0, "leaf": 0}
# multi-tenant arena walks (serve/arena.py), counted apart
arena_calls = {"arena": 0}


class ForestArrays(NamedTuple):
    """Stacked bin-space forest on one device; node tables padded to the
    widest tree's M nodes.  ``class_id`` and ``depth`` stay on the host.
    ``internal_count``/``leaf_count`` (the cover counts TreeSHAP reads) are
    stacked only ``with_counts``; ``model_id`` is the multi-tenant arena's
    lane (``serve/arena.py``), None outside an arena pack."""
    split_feature: torch.Tensor   # i64 [T, M] (-1 = padding)
    threshold_bin: torch.Tensor   # i32 [T, M]
    default_left: torch.Tensor    # bool [T, M]
    left_child: torch.Tensor      # i64 [T, M]
    right_child: torch.Tensor     # i64 [T, M]
    leaf_value: torch.Tensor      # f32 [T, M + 1]
    num_leaves: torch.Tensor      # i32 [T]
    cat_bitset: torch.Tensor      # i32 [T, M, W] (uint32 words' bits)
    class_id: np.ndarray          # i32 [T]: tree t adds to score column
    depth: np.ndarray             # i32 [T]: levels of each tree's walk
    internal_count: Optional[torch.Tensor] = None   # i32 [T, M]
    leaf_count: Optional[torch.Tensor] = None       # i32 [T, M + 1]
    model_id: Optional[torch.Tensor] = None         # i32 [T]: tree t's tenant


def stack_forest(trees_np: list, class_ids: np.ndarray, device,
                 min_words: int = 0, with_counts: bool = False,
                 model_ids: Optional[np.ndarray] = None) -> ForestArrays:
    """Stack per-tree numpy dicts (``GBDT._tree_arrays_np`` /
    ``ServeBinSpace.tree_arrays_np``) into one device batch.  ``min_words``
    pads every category bitset with zero words, so an out-of-range
    sentinel bin (unseen or NaN categories at predict time) finds no bit
    and routes right.  ``with_counts`` also stacks the per-node cover
    counts (the dicts must carry them); ``model_ids`` ([T]) stamps the
    tenant lane ``arena_predict_fn`` masks on."""
    M = max(max(t["split_feature"].shape[0] for t in trees_np), 1)
    W = max(max(t["cat_bitset"].shape[1] for t in trees_np), min_words, 1)
    T = len(trees_np)

    def batch(key, shape, dtype, fill=0):
        out = np.full((T,) + shape, fill, dtype=dtype)
        for i, t in enumerate(trees_np):
            a = t[key]
            out[(i,) + tuple(slice(0, s) for s in a.shape)] = a
        return torch.from_numpy(out).to(device)

    depth = np.asarray([tree_depth(t["left_child"], t["right_child"],
                                   int(t["num_leaves"])) for t in trees_np],
                       np.int32)
    bits = np.zeros((T, M, W), np.uint32)
    for i, t in enumerate(trees_np):
        a = t["cat_bitset"]
        bits[i, :a.shape[0], :a.shape[1]] = a
    return ForestArrays(
        split_feature=batch("split_feature", (M,), np.int64, -1),
        threshold_bin=batch("threshold_bin", (M,), np.int32),
        default_left=batch("default_left", (M,), np.bool_),
        left_child=batch("left_child", (M,), np.int64),
        right_child=batch("right_child", (M,), np.int64),
        leaf_value=batch("leaf_value", (M + 1,), np.float32),
        num_leaves=torch.from_numpy(np.asarray(
            [t["num_leaves"] for t in trees_np], np.int32)).to(device),
        cat_bitset=torch.from_numpy(bits.view(np.int32)).to(device),
        class_id=np.asarray(class_ids, np.int32),
        depth=depth,
        internal_count=(batch("internal_count", (M,), np.int32)
                        if with_counts else None),
        leaf_count=(batch("leaf_count", (M + 1,), np.int32)
                    if with_counts else None),
        model_id=(torch.from_numpy(np.asarray(model_ids, np.int32)).to(device)
                  if model_ids is not None else None),
    )


def _leaves(forest: ForestArrays, bins, meta, has_cat: bool,
            phys: bool = False):
    """Leaf indices ``[T, n]`` of the rows of one chunk."""
    return walk_leaves(forest.split_feature, forest.threshold_bin,
                       forest.default_left, forest.left_child,
                       forest.right_child, forest.num_leaves,
                       forest.cat_bitset, bins, meta,
                       int(forest.depth.max(initial=0)), has_cat, phys)


def _row_spans(forest: ForestArrays, n: int):
    rows = max(1024, _CHUNK_ELEMS // max(len(forest.depth), 1))
    for lo in range(0, n, rows):
        yield lo, min(lo + rows, n)


def _chunks(forest: ForestArrays, bins):
    for lo, hi in _row_spans(forest, bins.shape[0]):
        yield bins[lo:hi]


def forest_predict_fn(meta, K: int, early_stop: Optional[dict] = None):
    """Build ``predict(forest, bins) -> [N, K] f32`` raw scores; ``bins``
    ``[N, F]`` on the forest's device.

    ``early_stop``: None, or {"kind": "binary"|"multiclass",
    "round_period": int, "margin_threshold": float}, the reference's
    CreatePredictionEarlyStopInstance contract
    (prediction_early_stop.cpp:54-88)."""
    has_cat = bool(meta.is_categorical.any())

    def predict(forest: ForestArrays, bins):
        calls["predict"] += 1
        return torch.cat([_sum_chunk(forest, chunk)
                          for chunk in _chunks(forest, bins)])

    def _sum_chunk(forest, bins):
        lv = torch.gather(forest.leaf_value, 1,
                          _leaves(forest, bins, meta, has_cat))    # [T, n]
        n = bins.shape[0]
        score = [torch.zeros(n, dtype=torch.float32, device=bins.device)
                 for _ in range(K)]
        comp = [torch.zeros_like(s) for s in score]
        active = None
        if early_stop is not None:
            period = int(early_stop.get("round_period", 0)) or 1
            thr = float(np.float32(early_stop["margin_threshold"]))
            active = torch.ones(n, dtype=torch.bool, device=bins.device)
        for t, k in enumerate(forest.class_id.tolist()):
            add = lv[t] if active is None else torch.where(active, lv[t], 0.0)
            # Kahan-compensated f32 accumulation in tree order: the host
            # walk sums in f64, and the parity bound (1e-6) needs the sum's
            # error held to ~1 ulp of the result, not growing with T
            y = add - comp[k]
            t_sum = score[k] + y
            comp[k] = (t_sum - score[k]) - y
            score[k] = t_sum
            if active is not None and (t + 1) % (period * K) == 0:
                if early_stop["kind"] == "binary":
                    margin = 2.0 * torch.abs(score[0])
                else:
                    top2 = torch.topk(torch.stack(score, 1), 2, dim=1).values
                    margin = top2[:, 0] - top2[:, 1]
                active = active & (margin < thr)
        return torch.stack(score, 1)

    return predict


def arena_predict_fn(meta, K: int):
    """Build ``predict(forest, bins, row_model) -> [N, K] f32`` for a
    multi-tenant arena pack (``serve/arena.py``): the stacked forest holds
    every resident tenant's trees with a per-tree ``model_id`` lane, and
    ``row_model`` ([N] int32 on the forest's device) names each row's
    tenant (-1 for pad rows, which match no tree).  The walk is
    ``forest_predict_fn``'s with one mask: tree t adds to a row only where
    ``row_model == model_id[t]``.  ``K`` is the widest tenant's trees an
    iteration.  No early stop: the margin test is per-model state.

    A miss freezes both ``score`` and ``comp``: an add masked to zero would
    still fold the residual compensation into the score.  So a row's
    (score, comp) sequence is exactly the one its own model's solo walk
    produces (same ops, same order, ``torch.where`` on both), and an arena
    answer is bit-identical to a solo session's."""
    has_cat = bool(meta.is_categorical.any())

    def predict(forest: ForestArrays, bins, row_model):
        arena_calls["arena"] += 1
        return torch.cat([_sum_chunk(forest, bins[lo:hi], row_model[lo:hi])
                          for lo, hi in _row_spans(forest, bins.shape[0])])

    def _sum_chunk(forest, bins, row_model):
        lv = torch.gather(forest.leaf_value, 1,
                          _leaves(forest, bins, meta, has_cat))    # [T, n]
        hit = forest.model_id[:, None] == row_model[None, :]       # [T, n]
        n = bins.shape[0]
        score = [torch.zeros(n, dtype=torch.float32, device=bins.device)
                 for _ in range(K)]
        comp = [torch.zeros_like(s) for s in score]
        for t, k in enumerate(forest.class_id.tolist()):
            y = lv[t] - comp[k]
            t_sum = score[k] + y
            comp[k] = torch.where(hit[t], (t_sum - score[k]) - y, comp[k])
            score[k] = torch.where(hit[t], t_sum, score[k])
        return torch.stack(score, 1)

    return predict


def forest_leaf_fn(meta, phys: bool = False):
    """Build ``leaves(forest, bins) -> [T, N] int64``, the device analog
    of per-tree ``Tree.predict_leaf`` (reference: the Predictor's
    leaf-index mode, src/application/predictor.hpp:110-125); ``phys``
    reads a bundled dataset's physical columns."""
    has_cat = bool(meta.is_categorical.any())

    def leaves(forest: ForestArrays, bins):
        calls["leaf"] += 1
        return torch.cat([_leaves(forest, chunk, meta, has_cat, phys)
                          for chunk in _chunks(forest, bins)], dim=1)

    return leaves
