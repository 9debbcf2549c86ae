"""The split scan's check cases (``ops/split_scan.py``): seeded inputs of one
wave's scan and the comparison of the kernel's results with the plain
version's, shared by ``tests/test_torch_split_scan.py`` (the plain path on
the CPU, the kernel on a card) and ``chip_smoke.py`` (the kernel at the
main path's shapes).

Each leaf's histogram is built from rows of its own, so every feature of a
leaf sums to the leaf's totals.  Gradients and hessians are multiples of
1/64 (integers in the quantized case) with sums below 2^24 units, so every
running sum is exact in f32 and in f64: the kernel and the plain version
see the same sums and differ only in the gains' arithmetic.  Ties are
exact: feature 1 repeats feature 0, and empty bins repeat a running sum.
In ``ties`` the repeated pair carries the strongest signal and no feature
has missing values (one scan direction), so most leaves' best split is an
exact tie, in f32 and in f64 alike, that the tie order must settle.
"""
from __future__ import annotations

import numpy as np
import torch

from ..convert import meta_from_numpy
from ..core.meta import SplitConfig
from ..io.binning import MISSING_NAN, MISSING_NONE, MISSING_ZERO
from ..core.splitter import threshold_gains
from ..ops.split_scan import RESULT_COLS, pack_block, split_scan_plain

CASES = ("plain", "missing_zero", "missing_nan", "monotone", "regularized",
         "min_data_edge", "min_hess_edge", "feature_mask", "cegb",
         "quantized", "max_depth", "ties")
_QUANT_SCALES = (0.0123, 0.00391)    # s_g, s_h of the quantized case
_ROWS = (50, 400)                    # rows a leaf: fewest, most


def make_case(name: str, n: int = 10, F: int = 20, B: int = 64,
              seed: int = 0, device="cpu", rows=_ROWS) -> dict:
    """One scan's inputs for case ``name`` (``CASES``): ``n`` candidate
    leaves of ``n + 6``, ``F`` features of at most ``B`` bins, leaves of
    ``rows`` = (fewest, most) rows.  Returns hist [n + 6, F, B, 3], the
    host state the grower packs (``state``: g, h, c, min_c, max_c, depth),
    the candidates, ``blk`` (``pack_block``, host), meta, cfg and the
    keyword arguments of ``split_scan`` (``kw``)."""
    if name not in CASES:
        raise ValueError(f"unknown split-scan case {name!r}")
    rng = np.random.default_rng([seed, CASES.index(name)])
    L1 = n + 6
    nb = rng.integers(2, B + 1, F).astype(np.int32)
    nb[:4] = [B, B, 2, 3][:min(F, 4)]
    missing = {"missing_zero": np.full(F, MISSING_ZERO),
               "missing_nan": np.full(F, MISSING_NAN),
               "plain": np.full(F, MISSING_NONE),
               "ties": np.full(F, MISSING_NONE)}.get(
        name, rng.choice([MISSING_NONE, MISSING_ZERO, MISSING_NAN], F))
    meta_np = dict(
        num_bins=nb, default_bins=(rng.random(F) * nb).astype(np.int32),
        missing_types=missing.astype(np.int32),
        monotone=(rng.choice([-1, 0, 1], F) if name == "monotone"
                  else np.zeros(F)).astype(np.int32),
        penalties=(rng.choice([0.5, 1.0, 2.0], F) if name == "regularized"
                   else np.ones(F)).astype(np.float32))
    if F > 1:                    # feature 1 repeats feature 0: exact ties
        for v in meta_np.values():
            v[1] = v[0]
    quant = name == "quantized"
    hist = np.zeros((L1, F, B, 3), np.float64)
    sums = np.zeros((L1, 3), np.float64)
    for leaf in range(L1):
        R = int(rng.integers(rows[0], rows[1] + 1))
        # bins by a skewed draw, a tenth of each feature's bins left empty
        u = rng.random((R, F)) ** 1.5
        bins = np.minimum((u * nb).astype(np.int64), nb - 1)
        holes = rng.random((F, B)) < 0.1
        bins = np.where(holes[np.arange(F), bins], 0, bins)
        if F > 1:
            bins[:, 1] = bins[:, 0]
        # the gradients follow features 4-7 (0, 5-7 in ``ties``); out of
        # ``ties`` the duplicated pair carries no signal, so an exact tie
        # seldom decides a leaf's best split
        sig = [0, 5, 6, 7] if name == "ties" else [4, 5, 6, 7]
        signal = ((bins[:, sig] / nb[sig] - 0.5) @ np.array(
            [1.5, 1.0, -1.0, 0.5]) if F >= 8 else 0.0)
        if quant:
            g = np.clip(np.round(40 * (rng.normal(size=R) + signal)),
                        -127, 127)
            h = rng.integers(1, 128, R).astype(np.float64)
        else:
            g = np.round(64 * (rng.normal(size=R) + signal)) / 64
            h = np.round(64 * rng.uniform(0.05, 0.25, R)) / 64
        idx = np.arange(F)[None, :] * B + bins
        for k, v in enumerate((g, h, np.ones(R))):
            hist[leaf, :, :, k] = np.bincount(
                idx.ravel(), np.repeat(v, F), F * B).reshape(F, B)
            sums[leaf, k] = v.sum()
    hist = hist.astype(np.float32)
    scales = None
    if quant:
        s = np.array([*_QUANT_SCALES, 1.0], np.float32)
        scales = torch.as_tensor(s, device=device)
        sums = (sums.astype(np.float32) * s).astype(np.float64)
    g, h, c = (sums[:, k].astype(np.float32) for k in range(3))
    out0 = -g / h
    lo = np.full(L1, -np.inf, np.float32)
    hi = np.full(L1, np.inf, np.float32)
    if name == "monotone":       # finite windows about the leaf's output
        half = rng.random(L1) < 0.5
        lo[half] = (out0 - 0.5 * np.abs(out0) - 0.01)[half]
        hi[half] = (out0 + 0.3 * np.abs(out0) + 0.01)[half]
    depth = rng.integers(0, 6, L1).astype(np.int32)
    cand = rng.permutation(L1)[:n].astype(np.int32)
    cfg = dict(num_leaves=max(L1 - 1, 2), min_data_in_leaf=5,
               min_sum_hessian_in_leaf=1e-3)
    if name == "regularized":
        cfg.update(lambda_l1=0.5, lambda_l2=2.0, max_delta_step=0.3,
                   min_gain_to_split=0.5)
    if name == "max_depth":
        cfg.update(max_depth=3)
    kw = dict(scales=scales)
    if name == "feature_mask":
        mask = rng.random(F) < 0.6
        mask[int(rng.integers(F))] = True
        kw["feature_mask"] = torch.as_tensor(mask, device=device)
    if name == "cegb":
        kw["coupled"] = torch.as_tensor(
            rng.uniform(0.0, 0.5, F).astype(np.float32), device=device)
        kw["split_pen"] = 0.01
    meta = meta_from_numpy(meta_np, device)
    state = (g, h, c, lo, hi, depth)
    hist_t = torch.as_tensor(hist, device=device)
    edge = {"min_data_edge": "min_data_in_leaf",
            "min_hess_edge": "min_sum_hessian_in_leaf"}.get(name)
    if edge is not None:
        # the guard at the first candidate's best split without it: still
        # admitted at equality, so the same split must win
        base = split_scan_plain(hist_t, torch.as_tensor(
            pack_block(cand, *state), device=device), meta,
            SplitConfig(**{**cfg, edge: 0}), **kw)
        row = base[0].cpu().numpy()
        i = cand[0]
        if name == "min_data_edge":
            cfg["min_data_in_leaf"] = int(min(row[6], c[i] - row[6]))
        else:
            cfg["min_sum_hessian_in_leaf"] = float(min(row[5],
                                                       h[i] - row[5]))
    return dict(hist=hist_t, state=state, cand=cand,
                blk=pack_block(cand, *state), meta=meta,
                cfg=SplitConfig(**cfg), kw=kw)


def plain_lead(hist, blk, meta, cfg: SplitConfig, scales=None,
               feature_mask=None, coupled=None, split_pen: float = 0.0,
               distinct: bool = False):
    """The plain scan's relative lead of each candidate's best split over
    its runner-up, f64 [n]: (best - second) / |best| over every (feature,
    threshold, direction) after the feature mask and CEGB's penalty; inf
    with one valid split, NaN with none.  ``distinct``: the runner-up is
    the best value below the best, so an exact tie leads by its margin
    over the rest (for inputs whose ties are exact in f64 too)."""
    ids = blk[0].view(torch.int32).long()
    hist_c = hist[ids]
    if scales is not None:
        hist_c = hist_c * scales
    st = threshold_gains(hist_c, blk[1], blk[2], blk[3], meta, cfg, blk[4],
                         blk[5])["stacked"].double()       # [n, F, 2B]
    neg = torch.full_like(st, float("-inf"))
    if feature_mask is not None:
        st = torch.where(feature_mask[None, :, None], st, neg)
    if coupled is not None:
        pen = (blk[3][:, None] * split_pen + coupled[None, :]).double()
        st = torch.where(st > neg, st - pen[..., None], neg)
    st = st.reshape(st.shape[0], -1)
    best = st.max(-1).values
    if distinct:
        second = torch.where(st < best[:, None], st, -torch.inf).max(-1).values
    else:
        second = torch.topk(st, 2, -1).values[:, 1]
    return (best - second) / best.abs()


def compare_to_plain(res, plain, lead, rel: float = 1e-5,
                     atol: float = 1e-6) -> dict:
    """The kernel's result rows ``res`` against the plain version's on the
    same inputs (both f64 [n, 9 + W] on the host, ``lead`` from
    ``plain_lead``).  Feature, threshold and default_left must be equal
    where the plain best leads its runner-up by more than ``rel``; gains
    of found splits, and the sums and outputs of equal splits, within
    ``rel`` relative plus ``atol``; a split found by one side only must
    have a gain within ``atol`` of zero; the bitset words are zero.
    Returns the counts and the worst errors, with ``bad`` listing each
    failing row."""
    res, plain = np.asarray(res), np.asarray(plain)
    lead = np.asarray(lead)
    found_k, found_p = res[:, 0] > -np.inf, plain[:, 0] > -np.inf
    same = (res[:, 1:4] == plain[:, 1:4]).all(1)
    decided = found_p & (lead > rel)

    def err(a, b):
        return np.abs(a - b) / (rel * np.abs(b) + atol)
    bad = []
    for i in np.flatnonzero(decided & ~same):
        bad.append((int(i), "split", res[i, 1:4].tolist(),
                    plain[i, 1:4].tolist(), float(lead[i])))
    for i in np.flatnonzero(found_k != found_p):
        g = res[i, 0] if found_k[i] else plain[i, 0]
        if abs(g) > atol:
            bad.append((int(i), "found", float(res[i, 0]),
                        float(plain[i, 0])))
    both = found_k & found_p
    gain_err = err(res[both, 0], plain[both, 0])
    for i in np.flatnonzero(both)[gain_err > 1]:
        bad.append((int(i), "gain", float(res[i, 0]), float(plain[i, 0])))
    eq = both & same
    pay_err = err(res[eq, 4:9], plain[eq, 4:9]).max(1) if eq.any() else \
        np.zeros(0)
    for i in np.flatnonzero(eq)[pay_err > 1]:
        bad.append((int(i), "payload", res[i, 4:9].tolist(),
                    plain[i, 4:9].tolist()))
    if (res[:, RESULT_COLS:] != 0).any():
        bad.append((-1, "bitset words not zero"))
    return {"rows": int(len(res)), "found": int(found_p.sum()),
            "decided": int(decided.sum()), "same_split": int(eq.sum()),
            "gain_err": float(gain_err.max(initial=0.0)),
            "payload_err": float(pay_err.max(initial=0.0)), "bad": bad}
