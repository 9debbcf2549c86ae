"""Vectorized best-split search over per-leaf histograms (counterpart of
lightgbm_tpu/core/splitter.py).

The reference scans each feature's histogram in both directions with
running sums, missing-value routing, min-data / min-hessian guards and
L1/L2-regularized gain (reference: src/treelearner/feature_histogram.hpp:
91-653).  Here both directions are masked prefix/suffix sums over the
padded ``[..., F, B, 3]`` histogram, evaluated for every feature and
threshold at once, then one argmax.  Categorical features take the
reference's category-set search instead (one-hot below
``max_cat_to_onehot`` bins, else the scan over bins sorted by g/h ratio,
``_categorical_best``), and their winning set is a bin-space bitset.
Leading dimensions batch leaves: the wave grower scans all children of a
wave in one call.  The arithmetic is the reference package's, op for op,
in float32.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..io.binning import MISSING_NAN, MISSING_NONE, MISSING_ZERO
from .meta import DeviceMeta, SplitConfig

K_EPSILON = 1e-15
NEG_INF = float("-inf")


def threshold_l1(s, l1):
    """Soft-threshold by the L1 penalty (reference: ThresholdL1,
    feature_histogram.hpp:446-449)."""
    if l1 <= 0.0:
        return s
    return torch.sign(s) * torch.clamp(torch.abs(s) - l1, min=0.0)


def bitset_words(B: int) -> int:
    """uint32 words of a bin-space bitset."""
    return max(1, (B + 31) // 32)


def leaf_output_l2(g, h, cfg: SplitConfig, l2):
    """Regularized leaf output with an explicit L2 (categorical splits add
    cat_l2; reference: CalculateSplittedLeafOutput,
    feature_histogram.hpp:450-457)."""
    ret = -threshold_l1(g, cfg.lambda_l1) / (h + l2)
    if cfg.max_delta_step > 0.0:
        ret = torch.clamp(ret, -cfg.max_delta_step, cfg.max_delta_step)
    return ret


def leaf_output(g, h, cfg: SplitConfig):
    """Regularized leaf output (reference: CalculateSplittedLeafOutput,
    feature_histogram.hpp:450-457)."""
    return leaf_output_l2(g, h, cfg, cfg.lambda_l2)


def _clip(x, lo, hi):
    return torch.minimum(torch.maximum(x, lo), hi)


def leaf_gain_given_output(g, h, out, cfg: SplitConfig, l2=None):
    """(reference: GetLeafSplitGainGivenOutput, feature_histogram.hpp:503-506)."""
    if l2 is None:
        l2 = cfg.lambda_l2
    sg = threshold_l1(g, cfg.lambda_l1)
    return -(2.0 * sg * out + (h + l2) * out * out)


def leaf_split_gain(g, h, cfg: SplitConfig):
    """Gain of keeping a leaf unsplit (reference: GetLeafSplitGain,
    feature_histogram.hpp:497-501)."""
    return leaf_gain_given_output(g, h, leaf_output(g, h, cfg), cfg)


def _split_gains(gl, hl, gr, hr, cfg: SplitConfig, min_c, max_c, monotone,
                 l2=None):
    """Pairwise split gain with monotone rejection (reference: GetSplitGains,
    feature_histogram.hpp:459-472).  All args broadcastable tensors."""
    if l2 is None:
        l2 = cfg.lambda_l2
    out_l = _clip(leaf_output_l2(gl, hl, cfg, l2), min_c, max_c)
    out_r = _clip(leaf_output_l2(gr, hr, cfg, l2), min_c, max_c)
    gain = (leaf_gain_given_output(gl, hl, out_l, cfg, l2)
            + leaf_gain_given_output(gr, hr, out_r, cfg, l2))
    violates = (((monotone > 0) & (out_l > out_r))
                | ((monotone < 0) & (out_l < out_r)))
    return torch.where(violates, torch.zeros_like(gain), gain)


class BestSplit(NamedTuple):
    """A leaf's best split (the SplitInfo analog, reference:
    src/treelearner/split_info.hpp:22); every field has the batch shape."""
    gain: torch.Tensor          # f32 — gain minus (parent gain + min_gain_to_split)
    feature: torch.Tensor       # i64 — inner feature index (-1 if none)
    threshold: torch.Tensor     # i64 — bin-space threshold
    default_left: torch.Tensor  # bool
    left_g: torch.Tensor        # f32 — left child sum of gradients
    left_h: torch.Tensor        # f32
    left_c: torch.Tensor        # f32 — left child row count
    left_out: torch.Tensor      # f32 — left child output
    right_out: torch.Tensor     # f32
    cat_bitset: torch.Tensor    # i32 [..., W] — left-going bin set of a
    #                             categorical split (uint32 words' bits)


def split_decision(col, threshold, default_left, missing_type, num_bin,
                   default_bin, is_cat=None, cat_word=None):
    """Bin-space go-left decision (reference: src/io/dense_bin.hpp:152-231,
    tree.h:221-303): the NaN bin (``num_bin - 1`` under MISSING_NAN) and
    the default bin (under MISSING_ZERO) take ``default_left``; everything
    else compares ``col <= threshold``.  Categorical nodes (``is_cat``)
    test bit ``col % 32`` of ``cat_word``, the node's bitset word already
    gathered for ``col`` (word ``col // 32``).  All args broadcastable
    tensors."""
    is_missing = (((missing_type == MISSING_NAN) & (col == num_bin - 1))
                  | ((missing_type == MISSING_ZERO) & (col == default_bin)))
    go = torch.where(is_missing, default_left, col <= threshold)
    if is_cat is None:
        return go
    cat_go = ((cat_word >> (col % 32)) & 1) != 0
    return torch.where(is_cat, cat_go, go)


def pack_bitset(member):
    """Pack a [..., B] bool membership into int32 words [..., W] (the bits
    of the reference's uint32 words; Common::ConstructBitset)."""
    B = member.shape[-1]
    W = bitset_words(B)
    m = member.to(torch.int64)
    if W * 32 > B:
        m = torch.nn.functional.pad(m, (0, W * 32 - B))
    weights = torch.ones((), dtype=torch.int64, device=m.device) << \
        torch.arange(32, device=m.device)
    words = (m.reshape(*m.shape[:-1], W, 32) * weights).sum(-1)
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(
        torch.int32)


def _take(a, idx):
    """a[..., idx] per batch row (take_along_axis on the last axis)."""
    return torch.gather(a, -1, idx)


def _categorical_best(g, h, c, sum_g, sum_h, cnt, meta: DeviceMeta,
                      cfg: SplitConfig, min_c, max_c, min_gain_shift):
    """Per-feature best categorical split of raw per-bin histograms
    (reference package: splitter.py ``_categorical_best``; reference:
    FindBestThresholdCategorical, feature_histogram.hpp:118-279).

    g/h/c: [..., F, B]; the leaf sums, window and gain shift [..., 1, 1].
    One-hot for features with num_bin <= max_cat_to_onehot, otherwise the
    two-direction scan over the bins sorted by g / (h + cat_smooth), with
    cat_l2 and the min_data_per_group batching.  Returns [..., F] results
    and what rebuilds the winning bin set."""
    B = g.shape[-1]
    dev = g.device
    bins = torch.arange(B, device=dev)
    nb = meta.num_bins.long()[:, None]                          # [F, 1]
    is_full = (meta.missing_types == MISSING_NONE).long()[:, None]
    in_range = bins < nb - 1 + is_full                          # [F, B]

    def feat(x, idx):                  # [..., F, B] at [..., F] -> [..., F]
        return _take(x, idx[..., None])[..., 0]

    sg_f, sh_f, cnt_f = sum_g[..., 0], sum_h[..., 0], cnt[..., 0]
    min_f, max_f = min_c[..., 0], max_c[..., 0]

    # ---- one-hot: left = the single category t (hpp:139-169) ----------
    h_e = h + K_EPSILON
    other_h = sum_h - h - K_EPSILON
    ok_oh = (in_range & (c >= cfg.min_data_in_leaf)
             & (h >= cfg.min_sum_hessian_in_leaf)
             & (cnt - c >= cfg.min_data_in_leaf)
             & (other_h >= cfg.min_sum_hessian_in_leaf))
    gain_oh = _split_gains(sum_g - g, other_h, g, h_e, cfg, min_c, max_c,
                           torch.zeros((), device=dev))
    gain_oh = torch.where(ok_oh & (gain_oh > min_gain_shift), gain_oh,
                          torch.full_like(gain_oh, NEG_INF))
    t_oh = torch.argmax(gain_oh, -1)                            # [..., F]
    best_oh = feat(gain_oh, t_oh)
    lg_oh, lh_oh, lc_oh = feat(g, t_oh), feat(h_e, t_oh), feat(c, t_oh)
    lout_oh = _clip(leaf_output(lg_oh, lh_oh, cfg), min_f, max_f)
    rout_oh = _clip(leaf_output(sg_f - lg_oh, sh_f - lh_oh, cfg),
                    min_f, max_f)

    # ---- sorted-ratio scan (hpp:170-239) ------------------------------
    l2s = cfg.lambda_l2 + cfg.cat_l2
    ok_bin = in_range & (c >= cfg.cat_smooth)
    ratio = torch.where(ok_bin, g / (h + cfg.cat_smooth),
                        torch.full_like(g, float("inf")))
    order = torch.sort(ratio, dim=-1, stable=True).indices      # [..., F, B]
    used = ok_bin.sum(-1)                                       # [..., F]
    max_num_cat = torch.clamp((used + 1) // 2, max=cfg.max_cat_threshold)
    sg1, sh1, sc1 = _take(g, order), _take(h, order), _take(c, order)
    # dir = -1 visits sorted positions used-1, used-2, ...
    idx2 = torch.clamp(used[..., None] - 1 - bins, 0, B - 1)
    sg2, sh2, sc2 = _take(sg1, idx2), _take(sh1, idx2), _take(sc1, idx2)
    valid_i = ((bins < used[..., None]) & (bins < max_num_cat[..., None]))

    def dir_arrays(sgs, shs, scs):
        lg = torch.cumsum(sgs, -1)
        lh = torch.cumsum(shs, -1) + K_EPSILON
        lc = torch.cumsum(scs, -1)
        rc, rh = cnt - lc, sum_h - lh
        left_ok = ((lc >= cfg.min_data_in_leaf)
                   & (lh >= cfg.min_sum_hessian_in_leaf))
        # a break guard fires only at a visited position that passes the
        # left "continue" guards (hpp:212-219); the breaking position is
        # not evaluated, so the exclusion is inclusive-cumulative
        brk = (((rc < cfg.min_data_in_leaf) | (rc < cfg.min_data_per_group)
                | (rh < cfg.min_sum_hessian_in_leaf)) & left_ok & valid_i)
        broken = torch.cumsum(brk.long(), -1) > 0
        eligible = valid_i & left_ok & ~broken
        gain = _split_gains(lg, lh, sum_g - lg, sum_h - lh, cfg, min_c,
                            max_c, torch.zeros((), device=dev), l2=l2s)
        return lg, lh, lc, eligible, gain

    lg1c, lh1c, lc1c, el1, gg1 = dir_arrays(sg1, sh1, sc1)
    lg2c, lh2c, lc2c, el2, gg2 = dir_arrays(sg2, sh2, sc2)

    # min_data_per_group batching: a candidate is evaluated (and the group
    # count reset) only once the group reaches the minimum (hpp:221-224),
    # a recurrence along the sorted positions.  No position at or past
    # max_cat_threshold is eligible, so the walk stops there.
    cc = torch.stack([sc1, sc2], -2)                            # [..., F, 2, B]
    el = torch.stack([el1, el2], -2)
    evs = torch.zeros_like(el)
    grp = torch.zeros_like(cc[..., 0])
    for i in range(min(B, cfg.max_cat_threshold)):
        grp = grp + cc[..., i]
        ev = el[..., i] & (grp >= cfg.min_data_per_group)
        evs[..., i] = ev
        grp = torch.where(ev, torch.zeros_like(grp), grp)

    gains_s = torch.stack([gg1, gg2], -2)
    gains_s = torch.where(evs & (gains_s > min_gain_shift[..., None]),
                          gains_s, torch.full_like(gains_s, NEG_INF))
    flat = gains_s.reshape(*gains_s.shape[:-2], 2 * B)          # dir-major
    w_s = torch.argmax(flat, -1)
    best_s = _take(flat, w_s[..., None])[..., 0]
    dir_s = w_s // B                                            # 0: +1
    i_s = w_s % B

    def pick_d(a1, a2):
        return torch.where(dir_s == 0, feat(a1, i_s), feat(a2, i_s))
    lg_s, lh_s, lc_s = pick_d(lg1c, lg2c), pick_d(lh1c, lh2c), \
        pick_d(lc1c, lc2c)
    lout_s = _clip(leaf_output_l2(lg_s, lh_s, cfg, l2s), min_f, max_f)
    rout_s = _clip(leaf_output_l2(sg_f - lg_s, sh_f - lh_s, cfg, l2s),
                   min_f, max_f)

    # ---- the two paths per feature --------------------------------------
    use_oh = meta.num_bins <= cfg.max_cat_to_onehot             # [F]

    def sel(a, b):
        return torch.where(use_oh, a, b)
    return dict(gain=sel(best_oh, best_s), left_g=sel(lg_oh, lg_s),
                left_h=sel(lh_oh, lh_s) - K_EPSILON,
                left_c=sel(lc_oh, lc_s), left_out=sel(lout_oh, lout_s),
                right_out=sel(rout_oh, rout_s), use_oh=use_oh, t_oh=t_oh,
                order=order, used=used, dir_s=dir_s, i_s=i_s)


def _cat_winner_bitset(cat: dict, f_best, B: int):
    """Left-going bin set of the winning categorical split of each batch
    row, packed ([..., W] int32)."""
    bins = torch.arange(B, device=f_best.device)
    fi = f_best[..., None]

    def at(x):                                     # [..., F] -> [..., 1]
        return _take(x, fi)
    orow = torch.gather(cat["order"], -2, fi[..., None].expand(
        *fi.shape[:-1], 1, B))[..., 0, :]                       # [..., B]
    u, i = at(cat["used"]), at(cat["i_s"])
    pos_member = torch.where(at(cat["dir_s"]) == 0, bins <= i,
                             (bins >= u - 1 - i) & (bins < u))
    member_sorted = torch.zeros_like(pos_member).scatter(-1, orow,
                                                         pos_member)
    member_oh = bins == at(cat["t_oh"])
    member = torch.where(cat["use_oh"][f_best][..., None], member_oh,
                         member_sorted)
    return pack_bitset(member)


def threshold_gains(hist, sum_g, sum_h, cnt, meta: DeviceMeta,
                    cfg: SplitConfig, min_constraint, max_constraint) -> dict:
    """Every numerical threshold's gain, shifted by the parent's gain and
    ``min_gain_to_split`` and scaled by the feature's penalty (-inf where
    a guard fails), in the reference's visiting order: ``stacked`` [...,
    F, 2B] holds at k < B dir = -1 at threshold B-1-k (high to low), at k
    >= B dir = +1 at threshold k-B; with the two directions' running sums
    and what ``best_split`` reads besides.  Arguments as ``best_split``'s."""
    F, B = hist.shape[-3], hist.shape[-2]
    dev = hist.device
    g, h, c = hist[..., 0], hist[..., 1], hist[..., 2]          # [..., F, B]
    bins = torch.arange(B, device=dev)[None, :]                 # [1, B]
    nb = meta.num_bins.long()[:, None]                          # [F, 1]
    missing = meta.missing_types[:, None]
    valid_bin = bins < nb

    use_both = (nb > 2) & (missing != MISSING_NONE)             # [F, 1]
    skip_zero = use_both & (missing == MISSING_ZERO) & (
        bins == meta.default_bins.long()[:, None])
    skip_nan = use_both & (missing == MISSING_NAN) & (bins == nb - 1)
    acc = (valid_bin & ~skip_zero & ~skip_nan).float()

    def bc(x):            # batch scalar -> broadcast over [F, B]
        return x[..., None, None]

    sg, sh, sc = bc(sum_g), bc(sum_h), bc(cnt)
    min_c, max_c = bc(min_constraint), bc(max_constraint)
    gm, hm, cm = g * acc, h * acc, c * acc
    total_h = sh + 2.0 * K_EPSILON
    parent_gain = leaf_split_gain(sg, total_h, cfg)
    min_gain_shift = parent_gain + cfg.min_gain_to_split

    # ---- dir = +1 (left-to-right; missing/defaults land right) ---------
    lg1 = torch.cumsum(gm, -1)
    lh1 = torch.cumsum(hm, -1) + K_EPSILON
    lc1 = torch.cumsum(cm, -1)
    rg1, rh1, rc1 = sg - lg1, total_h - lh1, sc - lc1
    t_ok1 = bins <= nb - 2

    # ---- dir = -1 (right-to-left; missing/defaults land left) ----------
    # the right side at threshold t accumulates bins t+1..B-1
    def suffix_after(x):
        s = torch.flip(torch.cumsum(torch.flip(x, [-1]), -1), [-1])
        return torch.cat([s[..., 1:], torch.zeros_like(s[..., :1])], -1)

    rg2 = suffix_after(gm)
    rh2 = suffix_after(hm) + K_EPSILON
    rc2 = suffix_after(cm)
    lg2, lh2, lc2 = sg - rg2, total_h - rh2, sc - rc2
    na_excl = (use_both & (missing == MISSING_NAN)).long()
    t_ok2 = bins <= nb - 2 - na_excl

    monotone = meta.monotone[:, None]
    penalties = meta.penalties[:, None]

    def gains(lg, lh, lc, rg, rh, rc, t_ok):
        data_ok = ((lc >= cfg.min_data_in_leaf) & (rc >= cfg.min_data_in_leaf)
                   & (lh >= cfg.min_sum_hessian_in_leaf)
                   & (rh >= cfg.min_sum_hessian_in_leaf))
        gain = _split_gains(lg, lh, rg, rh, cfg, min_c, max_c, monotone)
        ok = t_ok & data_ok & (gain > min_gain_shift)
        # reported gain is shifted then penalty-scaled (reference:
        # FindBestThresholdNumerical tail + FindBestThreshold penalty)
        return torch.where(ok, (gain - min_gain_shift) * penalties,
                           torch.full_like(gain, NEG_INF))

    gains1 = gains(lg1, lh1, lc1, rg1, rh1, rc1, t_ok1)
    gains2 = gains(lg2, lh2, lc2, rg2, rh2, rc2, t_ok2)
    # features with a single scan use dir=-1 only (reference:
    # feature_histogram.hpp:104-111)
    gains1 = torch.where(use_both, gains1, torch.full_like(gains1, NEG_INF))
    stacked = torch.cat([torch.flip(gains2, [-1]), gains1], -1)  # [..., F, 2B]
    return dict(stacked=stacked, lg1=lg1, lh1=lh1, lc1=lc1, lg2=lg2,
                lh2=lh2, lc2=lc2, g=g, h=h, c=c, sg=sg, sh=sh, sc=sc,
                min_c=min_c, max_c=max_c, min_gain_shift=min_gain_shift)


def best_split(hist, sum_g, sum_h, cnt, meta: DeviceMeta, cfg: SplitConfig,
               min_constraint, max_constraint, feature_mask=None,
               has_cat=None, penalty_sub=None) -> BestSplit:
    """Best (feature, threshold or category set) split of each leaf.

    hist: f32 [..., F, B, 3]; sum_g/sum_h/cnt and the monotone window
    min/max_constraint: f32 tensors of the batch shape ``[...]``.
    feature_mask: optional bool [F] or [..., F] (feature_fraction and
    by-node sampling).  penalty_sub: optional f32 [..., F] gain penalty
    per feature, subtracted after the scan (CEGB's DeltaGain, reference:
    cost_effective_gradient_boosting.hpp:50-61).
    has_cat: whether any feature is categorical (None reads it from
    ``meta``, a device read; the grower knows it on the host)."""
    if has_cat is None:
        has_cat = bool(meta.is_categorical.any())
    F, B = hist.shape[-3], hist.shape[-2]
    dev = hist.device
    tg = threshold_gains(hist, sum_g, sum_h, cnt, meta, cfg, min_constraint,
                         max_constraint)
    stacked = tg["stacked"]
    lg1, lh1, lc1, lg2, lh2, lc2 = (tg[k] for k in ("lg1", "lh1", "lc1",
                                                    "lg2", "lh2", "lc2"))

    # ---- per-feature best with the reference's tie order ---------------
    # per feature the reference tries dir=-1 first (high t to low), then
    # dir=+1 (low t to high), keeping the FIRST strict max; across
    # features the lower index wins.  Both argmaxes return the first max.
    within_f = torch.argmax(stacked, -1)                         # [..., F]
    feat_gain = torch.gather(stacked, -1, within_f[..., None])[..., 0]
    if has_cat:
        min_gain_shift = tg["min_gain_shift"]
        cat = _categorical_best(tg["g"], tg["h"], tg["c"], tg["sg"],
                                tg["sh"], tg["sc"], meta, cfg, tg["min_c"],
                                tg["max_c"], min_gain_shift)
        cat_gain = torch.where(
            cat["gain"] > NEG_INF,
            (cat["gain"] - min_gain_shift[..., 0]) * meta.penalties,
            torch.full_like(cat["gain"], NEG_INF))
        feat_gain = torch.where(meta.is_categorical, cat_gain, feat_gain)
    if feature_mask is not None:
        feat_gain = torch.where(feature_mask, feat_gain,
                                torch.full_like(feat_gain, NEG_INF))
    if penalty_sub is not None:
        feat_gain = torch.where(feat_gain > NEG_INF, feat_gain - penalty_sub,
                                torch.full_like(feat_gain, NEG_INF))

    f_best = torch.argmax(feat_gain, -1)                         # [...]
    best_gain = torch.gather(feat_gain, -1, f_best[..., None])[..., 0]

    # ---- numerical payload at the winner --------------------------------
    within = torch.gather(within_f, -1, f_best[..., None])[..., 0]
    is_dir2 = within < B
    t_best = torch.where(is_dir2, B - 1 - within, within - B)
    feat_missing = meta.missing_types[f_best]
    feat_use_both = (meta.num_bins[f_best] > 2) & (feat_missing != MISSING_NONE)
    default_left = torch.where(feat_use_both, is_dir2,
                               feat_missing != MISSING_NAN)

    flat_idx = (f_best * B + t_best)[..., None]

    def pick(a1, a2):
        a1 = a1.expand(hist.shape[:-1]).reshape(*hist.shape[:-3], F * B)
        a2 = a2.expand(hist.shape[:-1]).reshape(*hist.shape[:-3], F * B)
        return torch.where(is_dir2, torch.gather(a2, -1, flat_idx)[..., 0],
                           torch.gather(a1, -1, flat_idx)[..., 0])

    left_g = pick(lg1, lg2)
    left_h = pick(lh1, lh2) - K_EPSILON
    left_c = pick(lc1, lc2)
    left_out = _clip(leaf_output(left_g, left_h, cfg), min_constraint,
                     max_constraint)
    right_out = _clip(leaf_output(sum_g - left_g, sum_h - left_h, cfg),
                      min_constraint, max_constraint)
    cat_bitset = torch.zeros((*best_gain.shape, bitset_words(B)),
                             dtype=torch.int32, device=dev)
    if has_cat:
        # the categorical payload where a categorical feature won
        win_cat = meta.is_categorical[f_best]

        def sel(key, num):
            return torch.where(win_cat, torch.gather(
                cat[key], -1, f_best[..., None])[..., 0], num)
        t_best = torch.where(win_cat, 0, t_best)
        default_left = default_left & ~win_cat
        left_g, left_h, left_c = (sel("left_g", left_g),
                                  sel("left_h", left_h),
                                  sel("left_c", left_c))
        left_out = sel("left_out", left_out)
        right_out = sel("right_out", right_out)
        cat_bitset = torch.where(win_cat[..., None],
                                 _cat_winner_bitset(cat, f_best, B),
                                 cat_bitset)
    found = best_gain > NEG_INF
    return BestSplit(
        gain=best_gain,
        feature=torch.where(found, f_best, -1),
        threshold=torch.where(found, t_best, 0),
        default_left=default_left,
        left_g=left_g, left_h=left_h, left_c=left_c,
        left_out=left_out, right_out=right_out, cat_bitset=cat_bitset,
    )


def partition_cost(N: int, splits: int = 1, batched: bool = True,
                   waves: int = 1):
    """(operations, bytes) of applying ``splits`` committed splits to the
    int32 [N] leaf ids (counterpart of the JAX package's
    ``core/splitter.py partition_cost``, with the port's own counts).  A
    pass reads each row's u8 bin of its leaf's split feature and reads and
    writes its leaf id: 9 bytes and two operations (the decision, the
    select) a row.  The one-pass apply (``core/wave_grower.py``) walks the
    rows once a wave, the sequential oracle (``build_split_once_fn``) once
    a split.  ``obs/ranks.py Reconciler`` and ``obs/xprof.py`` hold
    measured times against it."""
    passes = float(max(int(waves if batched else splits), 1))
    return 2.0 * N * passes, 9.0 * N * passes
