"""Tree arrays shared by the growers and the serial grower (counterpart of
lightgbm_tpu/core/grower.py).

The reference's dynamic tree (reference: include/LightGBM/tree.h:360-445)
is a fixed-capacity structure of arrays: internal nodes 0..L-2 in split
order, children < 0 encoding leaves as ``~leaf_index``; the left child
keeps its parent's leaf index, the right child takes the next free one.
A categorical node keeps its left-going bin set as a bitset.

``build_grow_fn`` is the serial (one split at a time, best first) grower
(reference: src/treelearner/serial_tree_learner.cpp:173-237, :771-852).
The trainer takes it for forced splits, CEGB, by-node feature sampling
and datasets whose every physical column has more than 256 bins, as the
JAX package's ``_init_grower`` does.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..convert import tree_arrays_from_numpy
from ..io.binning import MISSING_NAN, MISSING_ZERO
from ..ops.hist_channels import hist_channels_fm
from ..utils.random import threefry2x32
from .histogram import expand_bundled, fix_default_bins, hist_fixed_point
from .meta import _padded_bin_width
from .splitter import (_split_gains, best_split, bitset_words, leaf_output,
                       leaf_split_gain, split_decision)

NEG_INF = np.float32(-np.inf)


class TreeArrays(NamedTuple):
    """Fixed-capacity SoA tree; fields are numpy arrays while a grower
    builds it and torch tensors once handed out (``convert.py``)."""
    split_feature: object    # i32 [L-1] inner feature (-1 = unused node)
    threshold_bin: object    # i32 [L-1]
    default_left: object     # bool [L-1]
    left_child: object       # i32 [L-1]
    right_child: object      # i32 [L-1]
    split_gain: object       # f32 [L-1]
    internal_value: object   # f32 [L-1] output the node had as a leaf
    internal_count: object   # i32 [L-1]
    internal_weight: object  # f32 [L-1] sum_hessian
    leaf_value: object       # f32 [L]
    leaf_count: object       # i32 [L]
    leaf_weight: object      # f32 [L] sum_hessian
    num_leaves: object       # i32 scalar
    cat_bitset: object       # i32 [L-1, W] left-going bin set of a
    #                          categorical node (uint32 words' bits)


def _empty_tree(L: int, W: int = 1) -> TreeArrays:
    """A one-leaf tree of capacity ``L`` (bitsets of ``W`` words) as numpy
    arrays."""
    n = max(L - 1, 1)
    return TreeArrays(
        split_feature=np.full((n,), -1, np.int32),
        threshold_bin=np.zeros((n,), np.int32),
        default_left=np.zeros((n,), bool),
        left_child=np.zeros((n,), np.int32),
        right_child=np.zeros((n,), np.int32),
        split_gain=np.zeros((n,), np.float32),
        internal_value=np.zeros((n,), np.float32),
        internal_count=np.zeros((n,), np.int32),
        internal_weight=np.zeros((n,), np.float32),
        leaf_value=np.zeros((L,), np.float32),
        leaf_count=np.zeros((L,), np.int32),
        leaf_weight=np.zeros((L,), np.float32),
        num_leaves=np.int32(1),
        cat_bitset=np.zeros((n, W), np.int32),
    )


def decode_feature_col(colp, off, num_bin, default_bin):
    """EFB decode: physical-column bins -> the bins of a feature at bin
    offset ``off`` (io/bundling.py layout); the identity for a feature
    alone in its column (offset 0).  All args broadcastable tensors."""
    inb = (colp >= off) & (colp < off + num_bin)
    return torch.where(inb, colp - off, default_bin)


def go_left_bins(col, threshold, default_left, missing_type, num_bin,
                 default_bin, is_cat=None, cat_word=None):
    """Bin-space split decision for every row (reference:
    src/io/dense_bin.hpp:152-231 Split).  ``col`` int tensor [N]."""
    return split_decision(col, threshold, default_left, missing_type,
                          num_bin, default_bin, is_cat, cat_word)


class CegbConfig(NamedTuple):
    """Static CEGB penalties (reference: config.h cegb_*): per-inner-feature
    coupled and lazy penalties, or None."""
    tradeoff: float = 1.0
    penalty_split: float = 0.0
    coupled: Optional[tuple] = None
    lazy: Optional[tuple] = None


def bynode_masks(tree_seed: int, count: int, F: int, keep: int) -> np.ndarray:
    """By-node feature masks of one tree, bool [count, F]: row d is the JAX
    package's ``r >= top_k(r, keep)[-1]`` with ``r = jax.random.uniform(
    fold_in(PRNGKey(tree_seed), d), (F,))``, so exactly ``keep`` features
    per row.  Threefry (``utils/random.py``) runs on numpy arrays here,
    every row at once: the draw is jax's bit for bit."""
    seed = int(tree_seed) & 0xFFFFFFFF
    d = np.arange(count, dtype=np.int64)
    k0, k1 = threefry2x32(0, seed, np.zeros_like(d), d)       # fold_in
    lo = np.arange(F, dtype=np.int64)[None, :]
    b0, b1 = threefry2x32(k0[:, None], k1[:, None], np.zeros_like(lo), lo)
    bits = (((b0 ^ b1) >> 9) | 0x3F800000).astype(np.uint32)
    r = bits.view(np.float32) - np.float32(1.0)
    th = -np.sort(-r, axis=1)[:, keep - 1:keep]
    return r >= th


def build_grow_fn(meta, cfg, B: int, phys_bins: np.ndarray,
                  B_phys: int = None, bundled: bool = False,
                  cegb: CegbConfig = None, forced=None, bynode: float = None):
    """The serial grower: ``grow(bins, g, h, sample_mask, feature_mask,
    cegb_state=None, tree_seed=None) -> (TreeArrays, leaf_id, (passes,
    rows))``, tensors on the bins' device, then the leaf histograms taken
    and the rows they read.

    The reference package grows the tree under one ``lax.fori_loop``; here
    it is a host loop over the ``num_leaves - 1`` split steps, in the style
    of the wave grower: the [L]-sized bookkeeping (leaf sums, monotone
    windows, cached best splits, the tree) is float32 numpy on the host,
    the [N]-sized and histogram work is on the device.  Each step takes
    the leaf of largest cached gain, records the split, partitions its
    rows, histograms the smaller child over its own rows (a compacted
    gather; the sibling is the parent minus that child) and scans both
    children's best splits in one batched ``best_split``, read back once.

    ``bins`` is the pair (uint8 [Fn, N], int32 [Fw, N]) of the physical
    columns of up to 256 bins and of more (``phys_bins`` [F_phys] says
    which; either may be None): the first go through K2
    (``hist_channels_fm``), the second through ``hist_fixed_point``, and
    both are merged in physical order.  With ``bundled`` the physical
    histogram is expanded to features and each member's default bin
    rebuilt from the leaf totals.

    ``forced``: ``io/forced_splits.py`` arrays; step ``k`` splits
    ``leaf[k]`` as prescribed when the split has positive gain on the live
    histograms (missing mass joins the left child, ``default_left`` is
    True); one rejected forced split aborts the rest (reference:
    serial_tree_learner.cpp:674-679 ``aborted_last_force_split``).

    ``cegb``: the reference's cost model (reference:
    cost_effective_gradient_boosting.hpp:21-117): ``cegb_state`` is the list
    [coupled f32 [F] (tradeoff x coupled penalty, zeroed once a feature is
    used anywhere), row_unused u8 [F, N] (1 where the row never passed a
    split on the feature; None without lazy penalties)], kept by the
    trainer across trees and updated in place.  The JAX package's
    documented deviation holds: when a coupled penalty is first paid,
    other leaves' cached best splits are not searched again.

    ``bynode``: ``feature_fraction_bynode`` < 1: each candidate node draws
    ``round(bynode * F)`` features (``bynode_masks``) from the tree's key
    ``PRNGKey(tree_seed)``: ``fold_in`` 2k and 2k + 1 for the children of
    step k, 2(L - 1) for the root (reference: col_sampler GetByNode,
    serial_tree_learner.cpp:404)."""
    L = cfg.num_leaves
    B_phys = B if B_phys is None else int(B_phys)
    W = bitset_words(B)
    meta_np = {k: v.detach().cpu().numpy() for k, v in meta._asdict().items()
               if v is not None}
    F = len(meta_np["num_bins"])
    has_cat = bool(meta_np["is_categorical"].any())
    phys_bins = np.asarray(phys_bins)
    wide = phys_bins > 256
    narrow_idx, wide_idx = np.flatnonzero(~wide), np.flatnonzero(wide)
    B_narrow = (_padded_bin_width(int(phys_bins[~wide].max()))
                if len(narrow_idx) else 0)
    pos = np.zeros(len(phys_bins), np.int64)
    pos[narrow_idx] = np.arange(len(narrow_idx))
    pos[wide_idx] = np.arange(len(wide_idx))
    mixed = len(narrow_idx) and len(wide_idx)
    inv_perm = np.argsort(np.concatenate([narrow_idx, wide_idx]))
    if forced is not None:
        FL, FF, FT = (np.asarray(a, np.int64) for a in forced)
    if bynode is not None:
        keep = max(1, int(round(float(bynode) * F)))
    lazy_on = cegb is not None and cegb.lazy is not None
    if cegb is not None:
        split_pen = float(cegb.tradeoff * cegb.penalty_split)
        lazy_vec = (np.asarray(cegb.lazy, np.float32) * cegb.tradeoff
                    if lazy_on else None)

    def phys_hist(bins, rows, gv, hv, mv):
        """f32 [F_phys, B_phys, 3] of the rows ``rows`` (None: all)."""
        if rows is not None:
            gv, hv, mv = gv[rows], hv[rows], mv[rows]
        parts = []
        for b, hist_fn, width in ((bins[0], hist_channels_fm, B_narrow),
                                  (bins[1], hist_fixed_point, B_phys)):
            if b is None:
                continue
            if rows is not None:
                b = b.index_select(1, rows)
            hp = hist_fn(b, gv, hv, mv, width)
            if width < B_phys:
                hp = torch.nn.functional.pad(hp, (0, 0, 0, B_phys - width))
            parts.append(hp)
        if not mixed:
            return parts[0]
        return torch.cat(parts, 0)[torch.as_tensor(inv_perm).to(
            parts[0].device)]

    def hist_leaf(bins, rows, gv, hv, mv, totals):
        hp = phys_hist(bins, rows, gv, hv, mv)
        if not bundled:
            return hp
        hp = expand_bundled(hp, meta, B)
        tg, th, tc = (torch.tensor(v, dtype=torch.float32, device=hp.device)
                      for v in totals)
        return fix_default_bins(hp, tg, th, tc, meta)

    def column(bins, f: int):
        """Feature ``f``'s bins over all rows, decoded from its column."""
        p = int(meta_np["feat2phys"][f]) if bundled else f
        col = bins[1 if wide[p] else 0][pos[p]].long()
        if bundled:
            off = int(meta_np["feat_offset"][f])
            nb = int(meta_np["num_bins"][f])
            inb = (col >= off) & (col < off + nb)
            col = torch.where(inb, col - off,
                              torch.full_like(col,
                                              int(meta_np["default_bins"][f])))
        return col

    def go_left(col, f: int, t: int, dl: bool, cb: np.ndarray):
        """Bin-space decision of one node (reference: dense_bin.hpp Split,
        tree.h CategoricalDecisionInner) over all rows."""
        if meta_np["is_categorical"][f]:
            words = torch.as_tensor(cb).to(col.device)
            word = words[torch.clamp(col // 32, max=W - 1)]
            return ((word >> (col % 32)) & 1) != 0
        mt = int(meta_np["missing_types"][f])
        go = col <= t
        if mt == MISSING_NAN:
            miss = col == int(meta_np["num_bins"][f]) - 1
        elif mt == MISSING_ZERO:
            miss = col == int(meta_np["default_bins"][f])
        else:
            return go
        return torch.where(miss, torch.full_like(go, bool(dl)), go)

    def forced_eval(st, hist, k: int):
        """Step k's prescription on the live histograms (reference:
        GatherInfoForThresholdNumerical, feature_histogram.hpp:292-365):
        (ok, gain, lg, lh, lc, out_l, out_r)."""
        leaf, f, t = int(FL[k]), int(FF[k]), int(FT[k])
        dev = hist.device
        hf = hist[leaf, f]                                     # [B, 3]
        br = torch.arange(hf.shape[0], device=dev)
        nb, db = int(meta_np["num_bins"][f]), int(meta_np["default_bins"][f])
        mt = int(meta_np["missing_types"][f])
        miss = (((mt == MISSING_NAN) & (br == nb - 1))
                | ((mt == MISSING_ZERO) & (br == db)))
        lmask = (torch.where(miss, torch.ones_like(miss), br <= t)
                 & (br < nb)).float()
        lg, lh, lc = (torch.sum(hf[:, i] * lmask) for i in range(3))

        def f32(v):
            return torch.tensor(v, dtype=torch.float32, device=dev)
        pg, ph, pc = f32(st["g"][leaf]), f32(st["h"][leaf]), f32(st["c"][leaf])
        rg, rh, rc = pg - lg, ph - lh, pc - lc
        min_c, max_c = f32(st["min_c"][leaf]), f32(st["max_c"][leaf])
        gain = (_split_gains(lg, lh, rg, rh, cfg, min_c, max_c,
                             torch.tensor(int(meta_np["monotone"][f]),
                                          device=dev))
                - leaf_split_gain(pg, ph, cfg) - cfg.min_gain_to_split)
        out_l = torch.minimum(torch.maximum(leaf_output(lg, lh, cfg), min_c),
                              max_c)
        out_r = torch.minimum(torch.maximum(leaf_output(rg, rh, cfg), min_c),
                              max_c)
        v = torch.stack([gain, lg, lh, lc, rc, out_l, out_r]).cpu().numpy()
        gain, lg, lh, lc, rc, out_l, out_r = v
        ok = bool(gain > 0) and bool(lc > 0) and bool(rc > 0)
        return ok, (gain, lg, lh, lc, out_l, out_r)

    def cegb_pen(cegb_state, counts, leaf_id, children, sample_mask):
        """DeltaGain [len(children), F] (reference:
        cost_effective_gradient_boosting.hpp:50-61): the split penalty times
        the child's rows, the pending coupled penalties and, lazily, each
        feature's penalty times the child's rows that never used it."""
        coupled, rows = cegb_state[0], cegb_state[1]
        dev = coupled.device
        sc = torch.as_tensor(np.asarray(counts, np.float32)).to(dev)
        pen = sc[:, None] * split_pen + coupled[None, :]
        if lazy_on:
            cnt = []
            for c in children:
                sel = (leaf_id == c) & (sample_mask > 0)
                cnt.append(torch.sum(rows & sel.to(torch.uint8)[None, :],
                                     1, dtype=torch.int64))
            pen = pen + torch.as_tensor(lazy_vec).to(dev)[None, :] * \
                torch.stack(cnt).float()
        return pen

    def scan(st, hist, leaves, depth, fmask, pen):
        """Best splits of ``leaves`` (whose histograms are ``hist``) into
        the host state, read back in one copy."""
        dev = hist.device

        def col(key):
            return torch.as_tensor(st[key][leaves]).to(dev)
        bs = best_split(hist, col("g"), col("h"), col("c"), meta, cfg,
                        col("min_c"), col("max_c"), feature_mask=fmask,
                        has_cat=has_cat, penalty_sub=pen)
        res = torch.cat([torch.stack(
            [bs.gain, bs.feature.float(), bs.threshold.float(),
             bs.default_left.float(), bs.left_g, bs.left_h, bs.left_c,
             bs.left_out, bs.right_out], 1).double(),
            bs.cat_bitset.double()], 1).cpu().numpy()
        depth_ok = cfg.max_depth <= 0 or depth < cfg.max_depth
        st["best_gain"][leaves] = res[:, 0] if depth_ok else NEG_INF
        st["best_feat"][leaves] = res[:, 1].astype(np.int32)
        st["best_thr"][leaves] = res[:, 2].astype(np.int32)
        st["best_dl"][leaves] = res[:, 3] > 0
        for i, key in enumerate(("best_lg", "best_lh", "best_lc",
                                 "best_lout", "best_rout")):
            st[key][leaves] = res[:, 4 + i]
        st["best_cb"][leaves] = res[:, 9:].astype(np.int64).astype(np.int32)

    def grow(bins, g, h, sample_mask, feature_mask, cegb_state=None,
             tree_seed=None):
        dev = g.device
        N = g.shape[0]
        gv, hv, mv = g.float(), h.float(), sample_mask.float()
        st = {k: np.zeros(L, np.float32) for k in
              ("g", "h", "c", "out", "best_lg", "best_lh", "best_lc",
               "best_lout", "best_rout")}
        st["min_c"] = np.full(L, -np.inf, np.float32)
        st["max_c"] = np.full(L, np.inf, np.float32)
        st["best_gain"] = np.full(L, -np.inf, np.float32)
        for key in ("best_feat", "best_thr", "depth"):
            st[key] = np.zeros(L, np.int32)
        st["best_dl"] = np.zeros(L, bool)
        st["best_cb"] = np.zeros((L, W), np.int32)
        st["parent"] = np.full(L, -1, np.int32)
        st["is_right"] = np.zeros(L, bool)
        tr = _empty_tree(L, W)

        fmasks = feature_mask[None, :]
        if bynode is not None:
            seed = 0 if tree_seed is None else int(tree_seed)
            fmasks = fmasks & torch.as_tensor(bynode_masks(
                seed, 2 * L - 1, F, keep)).to(dev)
        root = torch.stack([(gv * mv).sum(), (hv * mv).sum(), mv.sum()])
        root_out = leaf_output(root[0], root[1], cfg)
        sum_g, sum_h, cnt, out0 = torch.cat(
            [root, root_out[None]]).cpu().numpy()
        st["g"][0], st["h"][0], st["c"][0], st["out"][0] = \
            sum_g, sum_h, cnt, out0
        leaf_id = torch.zeros(N, dtype=torch.int32, device=dev)
        sampled = mv > 0
        all_rows = bool(sampled.all())
        rows0 = None if all_rows else torch.nonzero(sampled)[:, 0]
        h0 = hist_leaf(bins, rows0, gv, hv, mv, (sum_g, sum_h, cnt))
        hist = torch.zeros((L,) + tuple(h0.shape), dtype=torch.float32,
                           device=dev)
        hist[0] = h0
        passes, n_rows = 1, N if all_rows else int(rows0.numel())
        pen0 = (cegb_pen(cegb_state, [cnt], leaf_id, [0], mv)
                if cegb is not None else None)
        root_mask = fmasks[-1:] if bynode is not None else fmasks
        scan(st, h0[None], np.array([0]), 0, root_mask, pen0)

        alive = True
        for k in range(L - 1):
            fon, fst = False, None
            if forced is not None and FF[k] >= 0 and alive:
                ok, fst = forced_eval(st, hist, k)
                fon = ok
                alive = ok
            if not (st["best_gain"].max() > 0.0 or fon):
                break
            new = k + 1
            if fon:
                leaf = int(FL[k])
                f, t, dl = int(FF[k]), int(FT[k]), True
                cb = np.zeros(W, np.int32)
                gain_rec, lg, lh, lc, out_l, out_r = fst
            else:
                leaf = int(np.argmax(st["best_gain"]))
                f, t = int(st["best_feat"][leaf]), int(st["best_thr"][leaf])
                dl = bool(st["best_dl"][leaf])
                cb = st["best_cb"][leaf].copy()
                gain_rec = st["best_gain"][leaf]
                lg, lh, lc = (st["best_lg"][leaf], st["best_lh"][leaf],
                              st["best_lc"][leaf])
                out_l, out_r = st["best_lout"][leaf], st["best_rout"][leaf]
            lg, lh, lc, out_l, out_r, gain_rec = (
                np.float32(v) for v in (lg, lh, lc, out_l, out_r, gain_rec))
            pg, ph, pc = st["g"][leaf], st["h"][leaf], st["c"][leaf]
            rg, rh, rc = pg - lg, ph - lh, pc - lc
            min_c, max_c = st["min_c"][leaf], st["max_c"][leaf]
            mono = meta_np["monotone"][f]
            mid = (out_l + out_r) / np.float32(2.0)
            l_min, l_max = (mid if mono < 0 else min_c), \
                (mid if mono > 0 else max_c)
            r_min, r_max = (mid if mono > 0 else min_c), \
                (mid if mono < 0 else max_c)

            # ---- record the split ---------------------------------------
            pn = int(st["parent"][leaf])
            if pn >= 0:
                if st["is_right"][leaf]:
                    tr.right_child[pn] = k
                else:
                    tr.left_child[pn] = k
            tr.split_feature[k], tr.threshold_bin[k] = f, t
            tr.default_left[k] = dl
            tr.split_gain[k] = gain_rec
            tr.internal_value[k] = st["out"][leaf]
            tr.internal_count[k] = np.int32(pc)
            tr.internal_weight[k] = ph
            tr.left_child[k], tr.right_child[k] = ~leaf, ~new
            tr.cat_bitset[k] = cb
            tr = tr._replace(num_leaves=np.int32(new + 1))

            # ---- partition rows -----------------------------------------
            in_leaf = leaf_id == leaf
            go = go_left(column(bins, f), f, t, dl, cb)
            leaf_id = torch.where(in_leaf & ~go,
                                  torch.full_like(leaf_id, new), leaf_id)

            # ---- smaller child histogrammed, sibling by subtraction -----
            left_smaller = lc < rc
            small, large = (leaf, new) if left_smaller else (new, leaf)
            totals = ((lg, lh, lc) if left_smaller else (rg, rh, rc))
            rows = torch.nonzero((leaf_id == small) & sampled)[:, 0]
            parent_hist = hist[leaf].clone()
            hs = hist_leaf(bins, rows, gv, hv, mv, totals)
            hist[small] = hs
            hist[large] = parent_hist - hs
            passes += 1
            n_rows += int(rows.numel())

            d = int(st["depth"][leaf]) + 1
            for key, a, b in (("g", lg, rg), ("h", lh, rh), ("c", lc, rc),
                              ("min_c", l_min, r_min),
                              ("max_c", l_max, r_max),
                              ("out", out_l, out_r), ("depth", d, d),
                              ("parent", k, k), ("is_right", False, True)):
                st[key][leaf], st[key][new] = a, b

            # ---- the two children's best splits -------------------------
            pen = None
            if cegb is not None:
                cegb_state[0][f] = 0.0
                if lazy_on:
                    cegb_state[1][f].masked_fill_(in_leaf, 0)
                pen = cegb_pen(cegb_state, [lc, rc], leaf_id, [leaf, new],
                               mv)
            fm = fmasks[2 * k:2 * k + 2] if bynode is not None else fmasks
            scan(st, hist[[leaf, new]], np.array([leaf, new]), d, fm, pen)

        out = tr._replace(leaf_value=st["out"].copy(),
                          leaf_count=st["c"].astype(np.int32),
                          leaf_weight=st["h"].copy())
        return (tree_arrays_from_numpy(out._asdict(), dev), leaf_id,
                (passes, n_rows))

    return grow
