"""Wave-scheduled leaf-wise tree growth (counterpart of
lightgbm_tpu/core/wave_grower.py: packed or triple layout, fused or
unfused sibling, float or quantized histograms, the eager or the deferred
(overlap) schedule, batched or sequential split apply, EFB bundles,
mixed-width columns, categorical splits).

Growth alternates two phases until no ready leaf has positive gain and
nothing is pending:

  split phase: best-first commit of every histogram-ready leaf whose gain
      passes the gain gate, up to the wave capacity P — the reference
      package's commit order exactly (argmax over the updated gains each
      step, gate against the phase's best ready gain);
  wave phase:  ONE K1 launch (``ops/hist_wave.py``) histograms the smaller
      child of every split just made and, fused, each sibling as parent
      minus child; then all children's best splits are scanned in one
      launch of the split-scan kernel (``ops/split_scan.py``), or, for a
      dataset with a categorical feature, one batched ``best_split``
      call.

The reference runs the whole loop inside one ``lax.while_loop`` on the
device.  Here the loop is a host loop that evaluates ``loop_cond`` once
per body.  The [L]-sized bookkeeping (leaf sums, monotone windows, tree
arrays, pending queues) lives on the host in float32 numpy, where the
commit phase's scalar steps cost nothing; the [N]-sized and histogram
work stays on the device: the partition, the row compaction, K1 and the
split scan.  Each wave copies the children's split results to the host
once.

Each step is a phase (``obs/core.py phase``: a ``torch.profiler`` range
``lgbm/<name>`` while a profiler records, seconds in the telemetry's
``phase_s`` while tracing is on): ``grow.commit`` (a split phase's host
loop), ``grow.partition``, ``grow.compact`` (the active-row compaction),
``grow.hist`` (two a wave: K1's slot table and parents before the
compaction, then K1 and the layouts and stores) and ``grow.scan``;
``wait`` marks each point where the host blocks on the device: each read
of a result (the root sums, the compaction's count, the scan's results)
and each host array's copy to the device (``convert.to_device``: PyTorch
copies pageable memory only once the stream has drained; the scan's one
block goes through page-locked memory, ``convert.to_device_async``, and
does not wait).  A wave waits 7 times (4 in ``grow.hist``, 2 in
``grow.compact``, 1 in ``grow.scan``: its results' read), a batched
partition 10 times (the sequential oracle 8 a split) and a tree
16 times more: the root read, its 14 arrays and, in the trainer, its
``num_leaves``.

Bundles (``bundled``): K1 histograms the physical columns (``B_phys``
bins), ``expand_bundled`` maps them to features and ``fix_default_bins``
rebuilds each member's default bin from the leaf totals, so the sibling
is a separate subtraction (no fused sibling).  Mixed width (``mixed``):
columns of up to 256 bins stay on K1 in the triple layout, the wider ones
take the side-pass ``core/histogram.py hist_wave_side``, and the two are
merged into one physical histogram before the split scan; ``bins_fm`` is
then the pair (uint8 narrow [Fn, N], int32 wide [Fw, N]).  Categorical
features split on bin sets, kept per node as bitsets.

Quantized modes (``int16``/``int8``): per tree, g and h are scaled by
``s = max|x| / QMAX`` over the bag-masked rows and stochastic-rounded to
integers (``ops/quant.py``).  Histograms stay in integer units through
K1, the sibling subtraction and the per-leaf store; they are dequantized
only at split-scan time, ``hist * [s_g, s_h, 1]``, as in the reference
(an in-kernel dequant would let a compiler fuse ``parent - child*s``
and break the bit-identity of the fused and unfused siblings).  They
need the pure-kernel, unbundled path (the trainer falls back to 2xbf16
otherwise, as the reference does).

CEGB (``cegb``, split and coupled penalties; the lazy ones need per-row
state and take the serial grower): each scan subtracts ``tradeoff x
penalty_split x leaf count`` plus the pending coupled penalties from a
feature's gain, and a commit zeroes its feature's coupled penalty, so the
children scanned after a phase see every feature the phase used; leaves
scanned earlier keep their cached splits, as in the reference package.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..convert import to_device, to_device_async, tree_arrays_from_numpy
from ..obs import profile as obs_profile
from ..obs.core import phase
from ..ops.hist_wave import (C_MAX, hist_wave, hist_wave_call_cost,
                             resolve_mode, wave_capacity_max)
from ..ops.quant import QUANT_MODES, QUANT_QMAX, SEED_H_XOR, stochastic_round
from ..ops.split_scan import (pack_block, split_scan, split_scan_call_cost,
                              split_scan_plain)
from .grower import CegbConfig, _empty_tree, decode_feature_col, go_left_bins
from .histogram import (expand_bundled, fix_default_bins, hist_subtract,
                        hist_wave_side)
from .meta import DeviceMeta, SplitConfig
from .splitter import bitset_words, leaf_output

NEG_INF = np.float32(-np.inf)


class WaveStats(tuple):
    """A grown tree's ``(waves, rows)``: its K1 launches and the rows they
    histogrammed, the pair ``GBDT.wave_stats`` keeps a tree; ``scans``
    counts its waves scanned by ``ops/split_scan.py split_scan`` (the
    kernel on the card), which is every wave of a dataset without a
    categorical feature."""

    def __new__(cls, waves: int, rows: int, scans: int = 0):
        self = super().__new__(cls, (waves, rows))
        self.scans = scans
        return self


class MixedWidth(NamedTuple):
    """The physical-column split of the mixed-width wave path (reference
    package: wave_grower.py ``MixedWidth``): K1 takes at most 256 bins a
    column, so the columns wider than that take the side-pass.
    narrow_idx / wide_idx: int32 physical-column indices; B_narrow: the
    narrow group's padded bin width (<= 256)."""
    narrow_idx: np.ndarray
    wide_idx: np.ndarray
    B_narrow: int


def effective_pipeline(wave_capacity: int, packed: bool = True,
                       fused_sibling: bool = True, mixed: bool = False,
                       bundled: bool = False, data_parallel: bool = False):
    """The (packed, capacity, fused) triple ``build_wave_grow_fn`` runs —
    the reference's gate: packed is off under ``mixed`` (the side-pass
    speaks the triple layout), fusion needs an unmixed, unbundled wave on
    one rank (bundles rebuild default bins before the subtraction, and
    across ranks the sibling is parent minus the GLOBAL child, taken
    after the reduction).  Capacity 63 packed, 42 triple."""
    packed = bool(packed) and not mixed
    fused = (bool(fused_sibling) and not mixed and not bundled
             and not data_parallel)
    return packed, max(1, min(int(wave_capacity),
                              wave_capacity_max(packed))), fused


def _mixed_positions(mixed: MixedWidth):
    """(position in its group, is wide) of every physical column."""
    Fn, Fw = len(mixed.narrow_idx), len(mixed.wide_idx)
    pos = np.zeros(Fn + Fw, np.int64)
    pos[mixed.narrow_idx] = np.arange(Fn)
    pos[mixed.wide_idx] = np.arange(Fw)
    is_wide = np.zeros(Fn + Fw, bool)
    is_wide[mixed.wide_idx] = True
    return pos, is_wide


def build_split_apply_fn(meta_np: dict, L: int, bundled: bool = False,
                         mixed: MixedWidth = None):
    """One-pass wave-split application: ``apply(leaf_id, bins_rm, splits)
    -> leaf_id`` re-partitions all N rows for every split the phase
    committed.  Each row looks up its leaf's pending split in a slot table,
    reads its own bin from the row-major bins (the physical column of a
    bundled feature, decoded; the narrow or the wide group under
    ``mixed``, whose ``bins_rm`` is the (narrow, wide) pair), and routes
    itself through the shared split decision (category bitsets included).
    ``splits``: list of committed (leaf, new, feature, threshold,
    default_left, bitset words) on the host."""
    if mixed is not None:
        pos, is_wide = _mixed_positions(mixed)

    def apply(leaf_id, bins_rm, splits):
        n = len(splits)
        if n == 0:
            return leaf_id
        dev = leaf_id.device
        leaf, new, f, t, dl = (np.asarray(c) for c in list(zip(*splits))[:5])
        words = np.stack([sp[5] for sp in splits])              # [n, W]
        # leaf -> slot table; rows whose leaf has no pending split map to
        # the pad slot n
        tbl = np.full(L + 2, n, np.int64)
        tbl[leaf] = np.arange(n)

        def slot_arr(a, fill):
            return to_device(np.append(a, fill), dev)[srow]
        srow = to_device(tbl, dev)[leaf_id.clamp(0, L + 1).long()]
        phys = (meta_np["feat2phys"][f] if bundled else f).astype(np.int64)
        if mixed is None:
            col = torch.gather(bins_rm, 1, slot_arr(phys, 0)[:, None])
        else:
            rm_n, rm_w = bins_rm
            p = slot_arr(pos[phys], 0)[:, None]
            coln = torch.gather(rm_n, 1, p.clamp(max=rm_n.shape[1] - 1))
            colw = torch.gather(rm_w, 1, p.clamp(max=rm_w.shape[1] - 1))
            col = torch.where(slot_arr(is_wide[phys], False)[:, None],
                              colw.long(), coln.long())
        col = col[:, 0].long()
        nb = slot_arr(meta_np["num_bins"][f], 0)
        db = slot_arr(meta_np["default_bins"][f], 0)
        if bundled:
            col = decode_feature_col(
                col, slot_arr(meta_np["feat_offset"][f], 0), nb, db)
        W = words.shape[1]
        flat = to_device(np.concatenate(
            [words, np.zeros((1, W), np.int32)]).reshape(-1), dev)
        word = flat[srow * W + torch.clamp(col // 32, max=W - 1)]
        go = go_left_bins(col, slot_arr(t.astype(np.int32), 0),
                          slot_arr(dl.astype(bool), False),
                          slot_arr(meta_np["missing_types"][f], 0), nb, db,
                          slot_arr(meta_np["is_categorical"][f], False), word)
        new_row = slot_arr(new.astype(np.int32), 0)
        return torch.where((srow < n) & ~go, new_row, leaf_id)

    return apply


def build_split_once_fn(meta_np: dict, bundled: bool = False,
                        mixed: MixedWidth = None):
    """The sequential oracle of ``build_split_apply_fn`` (reference
    package: wave_grower.py ``_split_once``): ``apply(leaf_id, bins_fm,
    split) -> leaf_id`` walks all N rows for ONE committed split, reading
    its feature's (physical) row of the feature-major bins, as the
    reference partitions one split at a time.  Same leaf ids, O(splits x
    N) row reads a wave instead of O(N)."""
    if mixed is not None:
        pos, is_wide = _mixed_positions(mixed)

    def apply(leaf_id, bins_fm, split):
        leaf, new, f, t, dl, words = split
        dev = leaf_id.device
        phys = int(meta_np["feat2phys"][f]) if bundled else f
        if mixed is None:
            col = bins_fm[phys]
        else:
            col = bins_fm[1 if is_wide[phys] else 0][int(pos[phys])]
        col = col.long()

        def c(v):
            return to_device(np.asarray(v), dev)
        nb, db = c(meta_np["num_bins"][f]), c(meta_np["default_bins"][f])
        if bundled:
            col = decode_feature_col(col, c(meta_np["feat_offset"][f]), nb,
                                     db)
        word = c(np.asarray(words, np.int32))[
            torch.clamp(col // 32, max=len(words) - 1)]
        go = go_left_bins(col, c(np.int32(t)), c(bool(dl)),
                          c(meta_np["missing_types"][f]), nb, db,
                          c(bool(meta_np["is_categorical"][f])), word)
        return torch.where((leaf_id == leaf) & ~go,
                           to_device(new, dev, leaf_id.dtype), leaf_id)

    return apply


class _LeafState:
    """The [L+1]-sized per-leaf state of one tree (slot L is scratch)."""

    def __init__(self, L: int, P: int, W: int):
        f32 = lambda v=0.0: np.full(L + 1, v, np.float32)   # noqa: E731
        i32 = lambda v=0: np.full(L + 1, v, np.int32)       # noqa: E731
        self.g, self.h, self.c = f32(), f32(), f32()
        self.depth = i32()
        self.min_c, self.max_c = f32(-np.inf), f32(np.inf)
        self.out = f32()
        self.ready = np.zeros(L + 1, bool)
        self.best_gain = f32(-np.inf)
        self.best_feat, self.best_thr = i32(), i32()
        self.best_dl = np.zeros(L + 1, bool)
        self.best_lg, self.best_lh, self.best_lc = f32(), f32(), f32()
        self.best_lout, self.best_rout = f32(), f32()
        self.best_cb = np.zeros((L + 1, W), np.int32)
        self.parent = i32(-1)
        self.is_right = np.zeros(L + 1, bool)
        self.pend_small = np.full(P, -1, np.int32)
        self.pend_large = np.full(P, -1, np.int32)
        self.pend_cnt = 0
        self.scans = 0          # waves scanned by ops/split_scan.py
        self.tree = _empty_tree(L, W)

    def ready_gains(self, L: int):
        return np.where(self.ready[:L], self.best_gain[:L], NEG_INF)


def build_wave_grow_fn(meta: DeviceMeta, cfg: SplitConfig, B: int,
                       wave_capacity: int = 63, highest="highest",
                       gain_gate: float = 0.0,
                       fused_sibling: bool = True, packed: bool = True,
                       quant_seed: int = 0, B_phys: int = None,
                       bundled: bool = False, mixed: MixedWidth = None,
                       cegb: CegbConfig = None, batched_apply: bool = True,
                       overlap: str = "off", reduce_fn=None,
                       reduce_max_fn=None):
    """``grow(bins_fm, g, h, sample_mask, feature_mask, cegb_state=None)``
    with K1 on the bins' device.  Returns ``(TreeArrays, leaf_id,
    WaveStats)``: tensors on that device, then the K1 launches taken, the
    rows they histogrammed and the scans through the split-scan kernel.
    With ``cegb``, ``cegb_state[0]`` is the f32 [F] tensor of pending
    coupled penalties (tradeoff x penalty), kept by the trainer across
    trees and zeroed in place as features are used.

    ``gain_gate`` commits only leaves whose gain is at least ``gain_gate``
    times the phase's best ready gain (0 = split everything positive, 1 =
    strict best-of-phase); ``highest`` is the histogram rounding mode;
    ``fused_sibling`` takes the siblings from K1's launch instead of a
    separate subtraction (the histograms are the same either way);
    ``packed`` picks K1's lane-pair layout (63 leaves a wave) or the
    triple one (42).  In the int16/int8 modes ``quant_seed`` seeds the
    gradients' stochastic rounding (the hessians' seed is ``quant_seed ^
    0x9E3779B9``).  ``B`` is the features' padded bin width, ``B_phys``
    the physical columns' (``bundled``: ``bins_fm`` holds EFB columns);
    with ``mixed`` set ``bins_fm`` is the (narrow, wide) pair.

    The two oracles of the reference package: ``batched_apply=False``
    partitions the rows one committed split at a time
    (``build_split_once_fn``) instead of once a phase, with the same
    trees; ``overlap`` ("off", "on", "serial") is the double-buffered
    schedule (``tpu_wave_overlap``): each wave's children are scanned one
    loop body later, so a phase commits on gains one wave old.  "on"
    scans them after the next wave's K1 launch is queued, "serial"
    before it; both grow the same trees (different from "off").  The
    scan waits for the launch on the card's one stream either way.

    ``reduce_fn`` (``parallel/mesh.py``: a sum across ranks) makes the
    grower row-shard aware: the root sums and every wave's K1 histograms
    are reduced, so every rank takes the same split decisions while K1
    reads its own rows; K1 then runs unfused and the sibling is taken
    after the reduction.  In the int modes K1 hands over its exact int64
    sums, reduced as integers and rounded to f32 once, and the scales
    come from the global maxima (``reduce_max_fn``), so the trees are the
    single-process ones bit for bit."""
    L = cfg.num_leaves
    packed, P, fused = effective_pipeline(wave_capacity, packed,
                                          fused_sibling, mixed is not None,
                                          bundled,
                                          data_parallel=reduce_fn is not None)
    mode = resolve_mode(highest)
    quant = mode in QUANT_MODES
    if reduce_fn is not None and mixed is not None:
        raise ValueError("the learners across ranks shard one bins array; "
                         "mixed width grows on the serial grower there")
    if quant and reduce_fn is not None and reduce_max_fn is None:
        raise ValueError("data-parallel quantized growth needs "
                         "reduce_max_fn: every rank must quantize in the "
                         "same units")
    if quant and (bundled or mixed is not None):
        raise ValueError("quantized histogram modes need the pure-kernel "
                         "unbundled wave path; the trainer falls back to "
                         "2xbf16")
    if quant and L + 2 >= 32768:
        raise ValueError("quantized K1 carries leaf ids as int16: "
                         "num_leaves must be <= 32000")
    if mixed is not None and not (len(mixed.narrow_idx)
                                  and len(mixed.wide_idx)):
        raise ValueError("mixed needs both narrow and wide columns")
    if cegb is not None and cegb.lazy is not None:
        raise ValueError("cegb_penalty_feature_lazy needs per-row state the "
                         "wave path does not carry; use the serial grower")
    split_pen = float(cegb.tradeoff * cegb.penalty_split) if cegb else 0.0
    B_phys = B if B_phys is None else int(B_phys)
    B_kern = int(mixed.B_narrow) if mixed is not None else B_phys
    lanes = 2 if packed else 3
    W = bitset_words(B)
    gain_gate = np.float32(min(max(float(gain_gate), 0.0), 1.0))
    meta_np = {k: v.detach().cpu().numpy() for k, v in meta._asdict().items()
               if v is not None}
    has_cat = bool(meta_np["is_categorical"].any())
    monotone = meta_np["monotone"]
    apply_splits = build_split_apply_fn(meta_np, L, bundled, mixed)
    split_once = build_split_once_fn(meta_np, bundled, mixed)
    if overlap not in ("off", "on", "serial"):
        raise ValueError(f"overlap must be off, on or serial: {overlap!r}")
    if mixed is not None:
        inv_perm = np.argsort(np.concatenate([mixed.narrow_idx,
                                              mixed.wide_idx]))

    def pick_split(st: _LeafState, phase_max):
        gains = st.ready_gains(L)
        leaf = int(np.argmax(gains))
        ok = (gains[leaf] > 0.0 and gains[leaf] >= gain_gate * phase_max
              and int(st.tree.num_leaves) < L and st.pend_cnt < P)
        return leaf, ok

    def commit(st: _LeafState, leaf: int, coupled):
        """Commit ``leaf``'s cached best split into the host state (and
        zero its feature's pending coupled penalty); returns its (leaf,
        new, feature, threshold, default_left, bitset)."""
        tr = st.tree
        new = int(tr.num_leaves)
        k = new - 1
        f, t, dl = int(st.best_feat[leaf]), int(st.best_thr[leaf]), \
            bool(st.best_dl[leaf])
        cb = st.best_cb[leaf].copy()
        if coupled is not None:
            coupled[f] = 0.0
        lg, lh, lc = st.best_lg[leaf], st.best_lh[leaf], st.best_lc[leaf]
        pg, ph, pc = st.g[leaf], st.h[leaf], st.c[leaf]
        rg, rh, rc = pg - lg, ph - lh, pc - lc
        min_c, max_c = st.min_c[leaf], st.max_c[leaf]
        out_l, out_r = st.best_lout[leaf], st.best_rout[leaf]
        mono = monotone[f]
        mid = (out_l + out_r) / np.float32(2.0)
        l_min, l_max = (mid if mono < 0 else min_c), (mid if mono > 0 else max_c)
        r_min, r_max = (mid if mono > 0 else min_c), (mid if mono < 0 else max_c)

        pn = max(int(st.parent[leaf]), 0)
        if st.parent[leaf] >= 0:
            if st.is_right[leaf]:
                tr.right_child[pn] = k
            else:
                tr.left_child[pn] = k
        tr.split_feature[k] = f
        tr.threshold_bin[k] = t
        tr.default_left[k] = dl
        tr.split_gain[k] = st.best_gain[leaf]
        tr.internal_value[k] = st.out[leaf]
        tr.internal_count[k] = np.int32(pc)
        tr.internal_weight[k] = ph
        tr.left_child[k] = ~leaf
        tr.right_child[k] = ~new
        tr.cat_bitset[k] = cb
        st.tree = tr._replace(num_leaves=np.int32(new + 1))

        small, large = (leaf, new) if lc < rc else (new, leaf)
        for arr, v1, v2 in ((st.g, lg, rg), (st.h, lh, rh), (st.c, lc, rc),
                            (st.min_c, l_min, r_min),
                            (st.max_c, l_max, r_max),
                            (st.out, out_l, out_r)):
            arr[leaf], arr[new] = v1, v2
        st.depth[leaf] = st.depth[new] = st.depth[leaf] + 1
        st.ready[leaf] = st.ready[new] = False
        st.best_gain[leaf] = st.best_gain[new] = NEG_INF
        st.parent[leaf] = st.parent[new] = k
        st.is_right[leaf], st.is_right[new] = False, True
        st.pend_small[st.pend_cnt] = small
        st.pend_large[st.pend_cnt] = large
        st.pend_cnt += 1
        return leaf, new, f, t, dl, cb

    def scan_children(st, hist, cand, feature_mask, scales, coupled):
        """Best splits of one wave's children, copied to the host state in
        one read (the ``grow.scan`` range, its read a ``wait``): one
        split-scan launch fed by one block of the children's state, or
        ``best_split`` where a feature is categorical; ``scales`` ([s_g,
        s_h, 1]) dequantizes integer-unit histograms; ``coupled`` (CEGB)
        is the pending coupled penalties."""
        with phase("grow.scan"):
            blk = to_device_async(pack_block(cand, st.g, st.h, st.c,
                                             st.min_c, st.max_c, st.depth),
                                  hist.device)
            kw = dict(scales=scales, feature_mask=feature_mask,
                      coupled=coupled, split_pen=split_pen)
            if has_cat:
                res = split_scan_plain(hist, blk, meta, cfg, has_cat=True,
                                       **kw)
            else:
                scan = obs_profile.wrap("split_scan", split_scan,
                                        cost=split_scan_call_cost)
                res = scan(hist, blk, meta, cfg, **kw)
                st.scans += 1
            with phase("wait"):
                res = res.cpu().numpy()
            st.ready[cand] = True
            st.best_gain[cand] = res[:, 0]
            st.best_feat[cand] = res[:, 1].astype(np.int32)
            st.best_thr[cand] = res[:, 2].astype(np.int32)
            st.best_dl[cand] = res[:, 3] > 0
            st.best_lg[cand], st.best_lh[cand], st.best_lc[cand] = \
                res[:, 4], res[:, 5], res[:, 6]
            st.best_lout[cand], st.best_rout[cand] = res[:, 7], res[:, 8]
            st.best_cb[cand] = res[:, 9:].astype(np.int64).astype(np.int32)

    def to_leaf_major(h, n, F):
        """K1's channel layout -> per-leaf [n, F, B, 3]."""
        if packed:
            hg, hc = h
            gh = hg[:, :, :2 * n].reshape(F, B, n, 2)
            return torch.cat([gh, hc[:, :, :n, None]], -1).permute(2, 0, 1, 3)
        return h[:, :, :3 * n].reshape(F, B, n, 3).permute(2, 0, 1, 3)

    def to_channels(par, n, F):
        """Per-leaf [n, F, B, 3] -> K1's channel layout (the parents)."""
        dev = par.device
        if not packed:
            out = torch.zeros((F, B, C_MAX), dtype=torch.float32, device=dev)
            out[:, :, :3 * n] = par.permute(1, 2, 0, 3).reshape(F, B, 3 * n)
            return out
        par_gh = torch.zeros((F, B, C_MAX), dtype=torch.float32, device=dev)
        par_ct = torch.zeros_like(par_gh)
        par_gh[:, :, :2 * n] = par[..., :2].permute(1, 2, 0, 3).reshape(
            F, B, 2 * n)
        par_ct[:, :, :n] = par[..., 2].permute(1, 2, 0)
        return par_gh, par_ct

    def wave_hist(bins_n, wide_rm, gv, hv, cv, leaf, slot_t, n,
                  kern_parent):
        """One wave's physical histograms in K1's channel layout: K1 over
        the (narrow) columns, plus the side-pass over the wide ones under
        ``mixed``, merged in physical-column order."""
        kern = obs_profile.wrap("hist_wave", hist_wave,
                                cost=hist_wave_call_cost)
        exact = quant and reduce_fn is not None
        hw = kern(bins_n, gv, hv, cv, leaf, slot_t, B_kern,
                  highest=mode, packed=packed, parent=kern_parent,
                  num_slots=n, exact=exact)
        if reduce_fn is not None:
            # the global histograms: every rank now scans the same wave
            hw = (tuple(reduce_fn(x) for x in hw) if packed
                  else reduce_fn(hw))
            if exact:
                hw = (tuple(x.float() for x in hw) if packed
                      else hw.float())
        if mixed is None:
            return hw
        hw_w = hist_wave_side(wide_rm, gv, hv, cv, leaf, slot_t, B_phys,
                              lanes=lanes * n)
        if B_phys > B_kern:
            hw = torch.nn.functional.pad(hw, (0, 0, 0, B_phys - B_kern))
        return torch.cat([hw, hw_w], 0)[to_device(inv_perm, hw.device)]

    def wave(st, hist, bins_fm, bins_rm, leaf_id, gv, hv, cv, feature_mask,
             scales, coupled):
        """One K1 launch over the pending leaves, and their children's
        scans unless the schedule defers them.  Returns the rows
        histogrammed and the children (the deferred scan's queue)."""
        dev = hist.device
        n = st.pend_cnt
        smalls = st.pend_small[:n].copy()
        larges = st.pend_large[:n].copy()
        # K1's slot table and parents go to the card before the
        # compaction: its gathers then run while the host queues K1 behind
        # them (a table copy after the gathers would wait for them)
        with phase("grow.hist"):
            parents = np.minimum(smalls, larges)  # the left child kept its id
            slot_leaf = np.full(C_MAX, -1, np.int32)
            slot_leaf[:lanes * n] = np.repeat(smalls, lanes)
            slot_t = to_device(slot_leaf, dev)
            par_t = to_device(parents, dev, torch.int64)
            F = hist.shape[1]
            kern_parent = to_channels(hist[par_t], n, F) if fused else None
        if mixed is not None:
            bins_n, (rm_n, rm_w) = bins_fm[0], bins_rm
        else:
            bins_n, rm_n, rm_w = bins_fm, bins_rm, None

        # ---- active-row compaction ------------------------------------
        # Only rows in a pending-small leaf that carry weight contribute.
        # The reference gathers them into the smallest of a few static
        # size tiers (a TPU grid must be static); here torch.nonzero sizes
        # the gather exactly.  Inactive rows add zero either way.
        with phase("grow.compact"):
            pend_tbl = np.zeros(st.tree.leaf_value.shape[0] + 2, bool)
            pend_tbl[smalls] = True
            active = (to_device(pend_tbl, dev)[leaf_id.long()]
                      & ((gv != 0) | (hv != 0) | (cv != 0)))
            with phase("wait"):
                # nonzero sizes its result on the host: the count's wait
                idx = torch.nonzero(active)[:, 0]
                n_rows = int(idx.numel())
            if n_rows == leaf_id.numel():
                args = (bins_n, rm_w, gv, hv, cv, leaf_id)
            else:
                args = (rm_n.index_select(0, idx).t().contiguous(),
                        None if rm_w is None else rm_w.index_select(0, idx),
                        gv[idx], hv[idx], cv[idx], leaf_id[idx])

        with phase("grow.hist"):
            hw = wave_hist(*args, slot_t, n, kern_parent)
            sib = None
            if fused:
                hw, hw_sib = hw
                sib = to_leaf_major(hw_sib, n, F)
            if bundled:
                # physical columns -> per-feature histograms; each member's
                # default bin is rebuilt from the leaf totals below
                hw = (tuple(expand_bundled(x, meta, B) for x in hw)
                      if packed else expand_bundled(hw, meta, B))
            child = to_leaf_major(hw, n, F)
            if bundled:
                def leaf_col(a):
                    return to_device(a[smalls], dev)
                child = fix_default_bins(child, leaf_col(st.g),
                                         leaf_col(st.h), leaf_col(st.c),
                                         meta)
            if sib is None:
                sib = hist_subtract(hist[par_t], child)
            hist[to_device(smalls, dev, torch.int64)] = child
            hist[to_device(larges, dev, torch.int64)] = sib
        st.pend_small[:] = -1
        st.pend_large[:] = -1
        st.pend_cnt = 0
        cand = np.concatenate([smalls, larges])
        if overlap == "off":
            scan_children(st, hist, cand, feature_mask, scales, coupled)
        return n_rows, cand

    def grow(bins_fm, g, h, sample_mask, feature_mask, cegb_state=None):
        dev = g.device
        coupled = None
        if cegb is not None:
            if cegb_state is None:
                cegb_state = [torch.zeros(int(meta.num_bins.shape[0]),
                                          dtype=torch.float32, device=dev)]
            coupled = cegb_state[0]
        N = g.shape[0]
        F = int(meta.num_bins.shape[0])
        gv = (g * sample_mask).float()
        hv = (h * sample_mask).float()
        cv = sample_mask.float()
        scales = None
        if quant:
            # per-tree symmetric scales over the bag-masked rows, then
            # value-hash stochastic rounding; masked rows are exact zeros
            # and stay zeros.  Root sums are integer totals times the scale.
            qmax = to_device(QUANT_QMAX[mode], dev)
            tiny = to_device(1e-30, dev)
            amax = torch.stack([gv.abs().amax(), hv.abs().amax()]) if N \
                else torch.zeros(2, dtype=torch.float32, device=dev)
            if reduce_max_fn is not None:
                amax = reduce_max_fn(amax)
            s_g = torch.maximum(amax[0], tiny) / qmax
            s_h = torch.maximum(amax[1], tiny) / qmax
            gv = stochastic_round(gv / s_g, quant_seed)
            hv = stochastic_round(hv / s_h, quant_seed ^ SEED_H_XOR)
            scales = torch.stack([s_g, s_h, torch.ones_like(s_g)])
            if reduce_fn is None:
                root = torch.stack([gv.double().sum().float() * s_g,
                                    hv.double().sum().float() * s_h,
                                    cv.sum()])
            else:
                # integer totals, exact in f64, summed across ranks before
                # their one rounding
                tot = reduce_fn(torch.stack([gv.double().sum(),
                                             hv.double().sum(),
                                             cv.double().sum()]))
                root = torch.stack([tot[0].float() * s_g,
                                    tot[1].float() * s_h, tot[2].float()])
        else:
            root = torch.stack([gv.sum(), hv.sum(), cv.sum()])
            if reduce_fn is not None:
                root = reduce_fn(root)
        root_out = leaf_output(root[0], root[1], cfg)
        root = torch.cat([root, root_out[None]])
        with phase("wait"):
            sum_g, sum_h, cnt, out0 = root.cpu().numpy()

        st = _LeafState(L, P, W)
        st.g[0], st.h[0], st.c[0], st.out[0] = sum_g, sum_h, cnt, out0
        st.pend_small[0] = 0
        st.pend_cnt = 1
        leaf_id = torch.zeros(N, dtype=torch.int32, device=dev)
        hist = torch.zeros((L + 1, F, B, 3), dtype=torch.float32, device=dev)
        # row-major twin of the feature-major bins, once per tree: every
        # compaction gather reads one contiguous row, and the split apply
        # reads each row's bin with one gather
        bins_rm = (tuple(b.t().contiguous() for b in bins_fm)
                   if mixed is not None else bins_fm.t().contiguous())
        n_waves = n_rows = 0
        queue = None            # children whose scan is deferred
        while True:
            with phase("grow.commit"):
                ready = st.ready_gains(L)
                phase_max = ready.max()
                can_split = phase_max > 0.0 and int(st.tree.num_leaves) < L
                if not (st.pend_cnt > 0 or can_split or queue is not None):
                    break
                deferred, queue = queue, None
                splits = []
                for _ in range(P):
                    leaf, ok = pick_split(st, phase_max)
                    if not ok:
                        break   # the state is unchanged: no later step can
                    splits.append(commit(st, leaf, coupled))
            with phase("grow.partition"):
                if batched_apply:
                    leaf_id = apply_splits(leaf_id, bins_rm, splits)
                else:
                    # the oracle walks the rows once a split, in commit
                    # order (a commit reads the host state alone)
                    for sp in splits:
                        leaf_id = split_once(leaf_id, bins_fm, sp)
            if overlap == "serial" and deferred is not None:
                scan_children(st, hist, deferred, feature_mask, scales,
                              coupled)
            if st.pend_cnt > 0:
                rows, cand = wave(st, hist, bins_fm, bins_rm, leaf_id, gv,
                                  hv, cv, feature_mask, scales, coupled)
                n_rows += rows
                n_waves += 1
                if overlap != "off":
                    queue = cand
            if overlap == "on" and deferred is not None:
                scan_children(st, hist, deferred, feature_mask, scales,
                              coupled)

        tr = st.tree._replace(
            leaf_value=st.out[:L].copy(),
            leaf_count=st.c[:L].astype(np.int32),
            leaf_weight=st.h[:L].copy(),
        )
        return (tree_arrays_from_numpy(tr._asdict(), dev), leaf_id,
                WaveStats(n_waves, n_rows, st.scans))

    return grow
