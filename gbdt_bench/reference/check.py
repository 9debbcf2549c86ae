"""The comparison that decides ``correct``: the program's model text and
training scores held against a plain torch reference that reads only the
raw rows, the labels and the query sizes the harness made.

First the binning: the program's bin upper bounds of each feature are
held against the raw rows (how many bins, how many rows each holds), and
the reference bins the raw rows by them itself.  Then it follows the
program tree by tree from the program's own forest: the scores before a
checked tree are its own float64 walk of the earlier trees of the model
text over the raw rows, and from them it works out the gradients, the
partition of the checked tree (its splits applied to the raw values),
each node's row count and gradient and hessian sums, each leaf's value,
each split's gain and, from its own histograms of every node, the best
split over every feature and bin.  For GOSS it also works out the
sampled iteration's top rows from float32 scores and judges the
program's sample mask (the random rest is judged by its count).  At the
end it walks every tree over the raw rows and holds the program's
training scores against that walk.

Numbers (a cell compares those its ``limits/<workload>.json`` names):
  trees       |trees in the model - iterations run|                exact
  bin_count_gap  largest min(max_bin, distinct raw values) - the
              feature's bins
  bin_share   worst bin: its share of the raw rows over an even share
              of min(max_bin, distinct values), or over the largest
              share of one value where that is larger
  count_gap   largest |row count - reference| over checked nodes   exact
  value_gap   worst leaf: |value - reference| / max(|reference|,
              the tree's median |reference leaf value|)
  weight_gap  worst node: the same for the hessian sums
  gain_gap    worst split: the same for the split gains
  split_gap   worst split: (best gain over every feature and bin - the
              chosen split's gain) / max(best, the tree's median best)
  (these over the traffic's first checked trees; count_gap also over
  the window's last tree, which has its own two:)
  window_value_gap, window_split_gap   value_gap and split_gap there
  score_gap   worst row: |score - reference walk| / max(|reference|,
              median |reference score|)
  goss_top_missing  rows clearly in the top share that the mask lacks
  goss_rest_z       |z| of the sampled rest's count against its binomial
"""
from __future__ import annotations

import importlib

import numpy as np
import torch

from .model_text import parents
from .walk import leaves, raw_scores

# a row whose GOSS weight is this far above the threshold is top whatever
# the rounding
GOSS_CLEAR_MARGIN = 1e-4


def objective(name: str):
    return importlib.import_module(
        f"gbdt_bench.reference.objectives.{name}")


def _rel_gaps(prog: np.ndarray, ref: np.ndarray) -> np.ndarray:
    scale = np.maximum(np.abs(ref), np.median(np.abs(ref)))
    scale = np.where(scale > 0, scale, 1.0)
    return np.abs(prog - ref) / scale


def _rel_worst(prog: np.ndarray, ref: np.ndarray) -> float:
    if ref.size == 0:
        return 0.0
    return float(np.max(_rel_gaps(prog, ref)))


def worst_leaf(tree: dict, lsum, lr: float, init: float, l2: float) -> dict:
    """Where a tree's value gap comes from: its worst leaf's row count,
    sums and the two values, beside the tree's median leaf value."""
    ref = -lsum[:, 1] / (lsum[:, 2] + l2) * lr + init
    i = int(np.argmax(_rel_gaps(tree["leaf_value"], ref)))
    return {"leaf": i, "rows": float(lsum[i, 0]), "G": float(lsum[i, 1]),
            "H": float(lsum[i, 2]), "H_prog": float(tree["leaf_weight"][i]),
            "value": float(tree["leaf_value"][i]), "value_ref": float(ref[i]),
            "median_ref": float(np.median(np.abs(ref)))}


def node_sums(tree: dict, leaf: torch.Tensor, c: torch.Tensor,
              g: torch.Tensor, h: torch.Tensor):
    """float64 (count, G, H) of every leaf and every internal node; ``c``
    is 1 for a row in the iteration's sample, else 0."""
    nl = tree["num_leaves"]
    dev = g.device
    acc = torch.zeros(nl, 3, dtype=torch.float64, device=dev)
    acc.index_add_(0, leaf, torch.stack([c, g, h], 1))
    lsum = acc.cpu().numpy()
    isum = np.zeros((nl - 1, 3))
    p_int, p_leaf = parents(tree)
    for li in range(nl):
        node = p_leaf[li]
        while node >= 0:
            isum[node] += lsum[li]
            node = p_int[node]
    return lsum, isum


def check_tree(tree: dict, lsum, isum, lr: float, init: float, l2: float):
    """(count_gap, value_gap, weight_gap, gain_gap) of one tree and the
    reference's gain of each split the tree chose."""
    count = max(np.max(np.abs(tree["leaf_count"] - lsum[:, 0]), initial=0),
                np.max(np.abs(tree["internal_count"] - isum[:, 0]),
                       initial=0))
    ref_value = -lsum[:, 1] / (lsum[:, 2] + l2) * lr + init
    value = _rel_worst(tree["leaf_value"], ref_value)
    weight = max(_rel_worst(tree["leaf_weight"], lsum[:, 2]),
                 _rel_worst(tree["internal_weight"], isum[:, 2]))

    def part(node_sums_g, node_sums_h):
        return node_sums_g ** 2 / (node_sums_h + l2)

    nl = tree["num_leaves"]
    gain_ref = np.zeros(nl - 1)
    for node in range(nl - 1):
        kids = []
        for child in (tree["left_child"][node], tree["right_child"][node]):
            kids.append(isum[child] if child >= 0 else lsum[~child])
        gain_ref[node] = (part(kids[0][1], kids[0][2])
                          + part(kids[1][1], kids[1][2])
                          - part(isum[node][1], isum[node][2]))
    gain = _rel_worst(tree["split_gain"], gain_ref)
    return float(count), value, weight, gain, gain_ref


def bin_numbers(X: torch.Tensor, bounds, max_bin: int):
    """(bin_count_gap, bin_share, the raw rows binned [N, F] int16, each
    feature's bin count).  ``bounds``: the program's bin upper bounds of
    each feature, ascending, the last +inf; a raw value goes to the first
    bin whose bound is at least it (LightGBM's ValueToBin)."""
    N, F = X.shape
    Xb = torch.empty((N, F), dtype=torch.int16, device=X.device)
    count_gap, share = 0.0, 0.0
    nbins = []
    for f in range(F):
        ub = torch.as_tensor(np.asarray(bounds[f], np.float64),
                             device=X.device)
        if not bool(torch.isinf(ub[-1])) or bool(torch.isnan(ub).any()):
            raise ValueError("the reference bins numerical features with "
                             "no missing-value bin only")
        col = X[:, f].double().contiguous()
        b = torch.searchsorted(ub[:-1].contiguous(), col)
        Xb[:, f] = b.to(torch.int16)
        _, per_value = torch.unique(col, return_counts=True)
        want = min(int(max_bin), int(per_value.numel()))
        count_gap = max(count_gap, float(want - ub.numel()))
        rows = torch.bincount(b, minlength=ub.numel()).max()
        even = max(1.0 / want, float(per_value.max()) / N)
        share = max(share, float(rows) / N / even)
        nbins.append(int(ub.numel()))
    return count_gap, share, Xb, nbins


def best_gains(tree: dict, leaf: torch.Tensor, c, g, h, Xb: torch.Tensor,
               nbins, params: dict) -> np.ndarray:
    """The best split gain of every internal node over every feature and
    every bin threshold, from the reference's own (count, G, H)
    histograms, under LightGBM's rules: a numerical threshold t sends bins
    <= t left, both children need ``min_data_in_leaf`` rows and
    ``min_sum_hessian_in_leaf`` hessian; -inf where no split is valid."""
    if float(params.get("lambda_l1", 0.0)) != 0.0:
        raise ValueError("the reference scans splits without lambda_l1")
    l2 = float(params.get("lambda_l2", 0.0))
    min_data = float(params.get("min_data_in_leaf", 20))
    min_hess = float(params.get("min_sum_hessian_in_leaf", 1e-3))
    L = tree["num_leaves"]
    N, F = Xb.shape
    B = max(nbins)
    dev = Xb.device
    hist = torch.zeros(L * F * B, 3, dtype=torch.float64, device=dev)
    vals = torch.stack([c, g, h], 1)
    base = leaf * F
    for f in range(F):
        hist.index_add_(0, (base + f) * B + Xb[:, f].long(), vals)
    hist = hist.view(L, F, B, 3)
    # an internal node's histogram is its two children's, deepest first
    p_int, _ = parents(tree)
    level = np.zeros(L - 1, np.int64)
    for node in range(1, L - 1):
        up = p_int[node]
        while up >= 0:
            level[node] += 1
            up = p_int[up]
    inner = torch.zeros(L - 1, F, B, 3, dtype=torch.float64, device=dev)
    for node in np.argsort(-level, kind="stable"):
        for child in (tree["left_child"][node], tree["right_child"][node]):
            inner[node] += inner[child] if child >= 0 else hist[~child]
    left = torch.cumsum(inner, 2)
    total = left[:, :, -1:, :]
    right = total - left
    t = torch.arange(B, device=dev)[None, :]
    ok = t <= torch.as_tensor(nbins, device=dev)[:, None] - 2      # [F, B]
    ok = ok[None] & (left[..., 0] >= min_data) & (right[..., 0] >= min_data) \
        & (left[..., 2] >= min_hess) & (right[..., 2] >= min_hess)

    def part(s):
        return s[..., 1] ** 2 / (s[..., 2] + l2)
    gain = part(left) + part(right) - part(total)
    gain = torch.where(ok, gain, torch.full_like(gain, -np.inf))
    return gain.flatten(1).max(1).values.cpu().numpy()


def split_gap(best: np.ndarray, chosen: np.ndarray) -> float:
    """Worst internal node: how far the chosen split's gain falls short
    of the best, against max(best, the tree's median best)."""
    best = np.maximum(best, chosen)
    return _rel_worst(chosen, best)


def compare(trees, iterations, X, label, group, params, checked,
            final_score, bounds, goss=None, detail=None, window_tree=None):
    """The numbers of the comparison (dict name -> float).

    trees: the parsed model text; iterations: ``Booster.update`` calls
    run; X: raw rows [N, F] on the reference's device; label: float64
    [N]; group: query sizes or None; params: the parameters the
    configuration and the traffic state (never a planted override);
    checked: the first iterations to follow; window_tree: the index of
    the last tree the window grew, followed too; final_score: the program's
    training scores after the run; bounds: the program's bin upper bounds
    of each feature; goss: iteration -> (the program's float32 scores
    before it, or None for the reference's own, and its sample mask);
    detail: a list that takes each checked tree's ``worst_leaf``."""
    obj = objective(params["objective"])
    lr = float(params["learning_rate"])
    l2 = float(params.get("lambda_l2", 0.0))
    init = obj.init_score(label, group)
    out = {"trees": float(abs(len(trees) - iterations))}
    out["bin_count_gap"], out["bin_share"], Xb, nbins = bin_numbers(
        X, bounds, int(params.get("max_bin", 255)))
    out.update(count_gap=0.0, value_gap=0.0, weight_gap=0.0, gain_gap=0.0,
               split_gap=0.0, window_value_gap=0.0, window_split_gap=0.0)
    if goss is not None:
        out.update(goss_top_missing=0.0, goss_rest_z=0.0)
    score = torch.full((X.shape[0],), init, dtype=torch.float64,
                       device=X.device)
    done = 0
    late = [] if window_tree is None else [window_tree]
    for it in list(checked) + late:
        if it >= len(trees):
            out["trees"] = max(out["trees"], float(it + 1 - len(trees)))
            break
        score += raw_scores(trees[done:it], X) - (init if done == 0 < it
                                                  else 0.0)
        done = it
        g, h = obj.gradients(score, label, group)
        c = torch.ones_like(g)
        if goss is not None:
            score32, mask = goss[it]
            c, g, h, top_missing, rest_z = goss_sample(
                (score.float() if score32 is None else score32, mask),
                g, h, label, group, params, obj)
            out["goss_top_missing"] = max(out["goss_top_missing"],
                                          top_missing)
            out["goss_rest_z"] = max(out["goss_rest_z"], rest_z)
        tree = trees[it]
        if tree["num_leaves"] <= 1:
            out["count_gap"] = max(out["count_gap"], float(X.shape[0]))
            continue
        leaf = leaves(tree, X)
        lsum, isum = node_sums(tree, leaf, c, g, h)
        nums = check_tree(tree, lsum, isum, lr, init if it == 0 else 0.0,
                          l2)
        best = best_gains(tree, leaf, c, g, h, Xb, nbins, params)
        nums = nums[:-1] + (split_gap(best, nums[-1]),)
        if detail is not None:
            detail.append({"iteration": it, **worst_leaf(
                tree, lsum, lr, init if it == 0 else 0.0, l2)})
        if it in late:
            # the later trees' rounding reads near the control's, so only
            # the partition, the leaf values and the scan are held here
            keys = ("count_gap", "window_value_gap", None, None,
                    "window_split_gap")
        else:
            keys = ("count_gap", "value_gap", "weight_gap", "gain_gap",
                    "split_gap")
        for key, val in zip(keys, nums):
            if key is not None:
                out[key] = max(out[key], val)
    del Xb
    ref = raw_scores(trees[done:], X) + (score if done else 0.0)
    prog = torch.as_tensor(final_score, device=X.device).double()
    scale = torch.maximum(ref.abs(), ref.abs().median())
    scale = torch.where(scale > 0, scale, torch.ones_like(scale))
    out["score_gap"] = float(((prog - ref).abs() / scale).max())
    return out


def goss_sample(state, g, h, label, group, params, obj):
    """(sample indicator, g, h) with the rows out of the sample zeroed
    and the sampled rest amplified as GOSS amplifies it, the count of
    clearly-top rows missing from the program's mask, and |z| of the
    sampled rest's count."""
    score32, mask = state
    mask = torch.as_tensor(mask, device=g.device) > 0
    N = g.shape[0]
    top_k = max(1, int(N * float(params["top_rate"])))
    other_k = max(1, int(N * float(params["other_rate"])))
    w = obj.goss_weight(torch.as_tensor(score32, device=g.device), label,
                        group)
    thr = torch.topk(w, top_k, sorted=False).values.min()
    top = w >= thr
    clear = w.double() >= float(thr) * (1.0 + GOSS_CLEAR_MARGIN)
    top_missing = float((clear & ~mask).sum())
    rest = mask & ~top
    rest_k = max(1, int((~top).sum()))
    prob = min(1.0, other_k / rest_k)
    var = max(other_k * (1.0 - prob), 1.0)
    rest_z = abs(float(rest.sum()) - other_k) / var ** 0.5
    amp = torch.where(rest, (N - top_k) / other_k, 1.0).double()
    keep = mask.double()
    return keep, g * amp * keep, h * amp * keep, top_missing, rest_z
