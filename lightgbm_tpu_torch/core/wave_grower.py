"""Wave-scheduled leaf-wise tree growth (counterpart of
lightgbm_tpu/core/wave_grower.py: packed or triple layout, fused or
unfused sibling, float or quantized histograms, eager schedule, batched
split apply).

Growth alternates two phases until no ready leaf has positive gain and
nothing is pending:

  split phase: best-first commit of every histogram-ready leaf whose gain
      passes the gain gate, up to the wave capacity P — the reference
      package's commit order exactly (argmax over the updated gains each
      step, gate against the phase's best ready gain);
  wave phase:  ONE K1 launch (``ops/hist_wave.py``) histograms the smaller
      child of every split just made and, fused, each sibling as parent
      minus child; then all children's best splits are scanned in one
      batched ``best_split`` call.

The reference runs the whole loop inside one ``lax.while_loop`` on the
device.  Here the loop is a host loop that evaluates ``loop_cond`` once
per body.  The [L]-sized bookkeeping (leaf sums, monotone windows, tree
arrays, pending queues) lives on the host in float32 numpy, where the
commit phase's scalar steps cost nothing; the [N]-sized and histogram
work stays on the device: the partition, the row compaction, K1 and the
split scan.  Each wave copies the children's split results to the host
once.

Quantized modes (``int16``/``int8``): per tree, g and h are scaled by
``s = max|x| / QMAX`` over the bag-masked rows and stochastic-rounded to
integers (``ops/quant.py``).  Histograms stay in integer units through
K1, the sibling subtraction and the per-leaf store; they are dequantized
only at split-scan time, ``hist * [s_g, s_h, 1]``, as in the reference
(an in-kernel dequant would let a compiler fuse ``parent - child*s``
and break the bit-identity of the fused and unfused siblings).
"""
from __future__ import annotations

import numpy as np
import torch

from ..convert import tree_arrays_from_numpy
from ..ops.hist_wave import C_MAX, resolve_mode, hist_wave, \
    wave_capacity_max
from ..ops.quant import QUANT_MODES, QUANT_QMAX, SEED_H_XOR, stochastic_round
from .grower import _empty_tree, go_left_bins
from .histogram import hist_subtract
from .meta import DeviceMeta, SplitConfig
from .splitter import best_split, leaf_output

NEG_INF = np.float32(-np.inf)


def effective_pipeline(wave_capacity: int, packed: bool = True,
                       fused_sibling: bool = True):
    """The (packed, capacity, fused) triple ``build_wave_grow_fn`` runs —
    the reference's gate with the mixed-width, bundled and data-parallel
    cases (not in the port yet) always off: capacity 63 packed, 42
    triple."""
    packed = bool(packed)
    return packed, max(1, min(int(wave_capacity),
                              wave_capacity_max(packed))), \
        bool(fused_sibling)


def build_split_apply_fn(meta_np: dict, L: int):
    """One-pass wave-split application: ``apply(leaf_id, bins_rm, splits)
    -> leaf_id`` re-partitions all N rows for every split the phase
    committed.  Each row looks up its leaf's pending split in a slot table,
    reads its own bin from the row-major bins, and routes itself through
    the shared split decision.  ``splits``: list of committed (leaf, new,
    feature, threshold, default_left) on the host."""
    def apply(leaf_id, bins_rm, splits):
        n = len(splits)
        if n == 0:
            return leaf_id
        dev = leaf_id.device
        leaf, new, f, t, dl = (np.asarray(c) for c in zip(*splits))
        # leaf -> slot table; rows whose leaf has no pending split map to
        # the pad slot n
        tbl = np.full(L + 2, n, np.int64)
        tbl[leaf] = np.arange(n)

        def slot_arr(a, fill):
            return torch.as_tensor(np.append(a, fill)).to(dev)
        f_s = slot_arr(f.astype(np.int64), 0)
        srow = torch.as_tensor(tbl).to(dev)[leaf_id.clamp(0, L + 1).long()]
        col = torch.gather(bins_rm, 1, f_s[srow][:, None])[:, 0].int()
        go = go_left_bins(col, slot_arr(t.astype(np.int32), 0)[srow],
                          slot_arr(dl.astype(bool), False)[srow],
                          slot_arr(meta_np["missing_types"][f], 0)[srow],
                          slot_arr(meta_np["num_bins"][f], 0)[srow],
                          slot_arr(meta_np["default_bins"][f], 0)[srow])
        new_row = slot_arr(new.astype(np.int32), 0)[srow]
        return torch.where((srow < n) & ~go, new_row, leaf_id)

    return apply


class _LeafState:
    """The [L+1]-sized per-leaf state of one tree (slot L is scratch)."""

    def __init__(self, L: int, P: int):
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
        self.parent = i32(-1)
        self.is_right = np.zeros(L + 1, bool)
        self.pend_small = np.full(P, -1, np.int32)
        self.pend_large = np.full(P, -1, np.int32)
        self.pend_cnt = 0
        self.tree = _empty_tree(L)

    def ready_gains(self, L: int):
        return np.where(self.ready[:L], self.best_gain[:L], NEG_INF)


def build_wave_grow_fn(meta: DeviceMeta, cfg: SplitConfig, B: int,
                       wave_capacity: int = 63, highest="highest",
                       gain_gate: float = 0.0,
                       fused_sibling: bool = True, packed: bool = True,
                       quant_seed: int = 0):
    """``grow(bins_fm, g, h, sample_mask, feature_mask)`` with K1 on the
    bins' device.  Returns ``(TreeArrays, leaf_id, (waves, rows))``:
    tensors on that device, then the K1 launches taken and the rows they
    histogrammed.

    ``gain_gate`` commits only leaves whose gain is at least ``gain_gate``
    times the phase's best ready gain (0 = split everything positive, 1 =
    strict best-of-phase); ``highest`` is the histogram rounding mode;
    ``fused_sibling`` takes the siblings from K1's launch instead of a
    separate subtraction (the histograms are the same either way);
    ``packed`` picks K1's lane-pair layout (63 leaves a wave) or the
    triple one (42).  In the int16/int8 modes ``quant_seed`` seeds the
    gradients' stochastic rounding (the hessians' seed is ``quant_seed ^
    0x9E3779B9``)."""
    L = cfg.num_leaves
    packed, P, fused = effective_pipeline(wave_capacity, packed,
                                          fused_sibling)
    mode = resolve_mode(highest)
    quant = mode in QUANT_MODES
    if quant and L + 2 >= 32768:
        raise ValueError("quantized K1 carries leaf ids as int16: "
                         "num_leaves must be <= 32000")
    lanes = 2 if packed else 3
    gain_gate = np.float32(min(max(float(gain_gate), 0.0), 1.0))
    meta_np = {k: v.detach().cpu().numpy() for k, v in meta._asdict().items()}
    monotone = meta_np["monotone"]
    apply_splits = build_split_apply_fn(meta_np, L)

    def pick_split(st: _LeafState, phase_max):
        gains = st.ready_gains(L)
        leaf = int(np.argmax(gains))
        ok = (gains[leaf] > 0.0 and gains[leaf] >= gain_gate * phase_max
              and int(st.tree.num_leaves) < L and st.pend_cnt < P)
        return leaf, ok

    def commit(st: _LeafState, leaf: int):
        """Commit ``leaf``'s cached best split into the host state; returns
        its (leaf, new, feature, threshold, default_left)."""
        tr = st.tree
        new = int(tr.num_leaves)
        k = new - 1
        f, t, dl = int(st.best_feat[leaf]), int(st.best_thr[leaf]), \
            bool(st.best_dl[leaf])
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
        return leaf, new, f, t, dl

    def scan_children(st, hist, cand, feature_mask, scales):
        """Best splits of one wave's children, copied to the host state;
        ``scales`` ([s_g, s_h, 1]) dequantizes integer-unit histograms."""
        dev = hist.device
        cand_t = torch.as_tensor(cand, dtype=torch.int64).to(dev)

        def col(a):
            return torch.as_tensor(a[cand]).to(dev)
        hist_c = hist[cand_t]
        if scales is not None:
            hist_c = hist_c * scales
        bs = best_split(hist_c, col(st.g), col(st.h), col(st.c), meta,
                        cfg, col(st.min_c), col(st.max_c),
                        feature_mask=feature_mask)
        gain = bs.gain
        if cfg.max_depth > 0:
            gain = torch.where(col(st.depth) < cfg.max_depth, gain,
                               torch.full_like(gain, float("-inf")))
        res = torch.stack([gain, bs.feature.float(), bs.threshold.float(),
                           bs.default_left.float(), bs.left_g, bs.left_h,
                           bs.left_c, bs.left_out, bs.right_out]).cpu().numpy()
        st.ready[cand] = True
        st.best_gain[cand] = res[0]
        st.best_feat[cand] = res[1].astype(np.int32)
        st.best_thr[cand] = res[2].astype(np.int32)
        st.best_dl[cand] = res[3] > 0
        st.best_lg[cand], st.best_lh[cand], st.best_lc[cand] = res[4:7]
        st.best_lout[cand], st.best_rout[cand] = res[7], res[8]

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

    def wave(st, hist, bins_fm, bins_rm, leaf_id, gv, hv, cv, feature_mask,
             scales):
        """One K1 launch over the pending leaves + their children's scans.
        Returns the number of rows histogrammed."""
        dev = hist.device
        n = st.pend_cnt
        smalls = st.pend_small[:n].copy()
        larges = st.pend_large[:n].copy()
        parents = np.minimum(smalls, larges)   # the left child kept its id
        slot_leaf = np.full(C_MAX, -1, np.int32)
        slot_leaf[:lanes * n] = np.repeat(smalls, lanes)
        slot_t = torch.as_tensor(slot_leaf).to(dev)
        par_t = torch.as_tensor(parents, dtype=torch.int64).to(dev)
        F = hist.shape[1]
        kern_parent = to_channels(hist[par_t], n, F) if fused else None

        # ---- active-row compaction ------------------------------------
        # Only rows in a pending-small leaf that carry weight contribute.
        # The reference gathers them into the smallest of a few static
        # size tiers (a TPU grid must be static); here torch.nonzero sizes
        # the gather exactly.  Inactive rows add zero either way.
        pend_tbl = np.zeros(st.tree.leaf_value.shape[0] + 2, bool)
        pend_tbl[smalls] = True
        active = (torch.as_tensor(pend_tbl).to(dev)[leaf_id.long()]
                  & ((gv != 0) | (hv != 0) | (cv != 0)))
        idx = torch.nonzero(active)[:, 0]
        n_rows = int(idx.numel())
        if n_rows == leaf_id.numel():
            args = (bins_fm, gv, hv, cv, leaf_id)
        else:
            args = (bins_rm.index_select(0, idx).t().contiguous(),
                    gv[idx], hv[idx], cv[idx], leaf_id[idx])
        hw = hist_wave(*args, slot_t, B, highest=mode, packed=packed,
                       parent=kern_parent, num_slots=n)
        if fused:
            child, sib = to_leaf_major(hw[0], n, F), to_leaf_major(hw[1], n, F)
        else:
            child = to_leaf_major(hw, n, F)
            sib = hist_subtract(hist[par_t], child)
        hist[torch.as_tensor(smalls, dtype=torch.int64).to(dev)] = child
        hist[torch.as_tensor(larges, dtype=torch.int64).to(dev)] = sib
        st.pend_small[:] = -1
        st.pend_large[:] = -1
        st.pend_cnt = 0
        scan_children(st, hist, np.concatenate([smalls, larges]),
                      feature_mask, scales)
        return n_rows

    def grow(bins_fm, g, h, sample_mask, feature_mask):
        dev = bins_fm.device
        F, N = bins_fm.shape
        gv = (g * sample_mask).float()
        hv = (h * sample_mask).float()
        cv = sample_mask.float()
        scales = None
        if quant:
            # per-tree symmetric scales over the bag-masked rows, then
            # value-hash stochastic rounding; masked rows are exact zeros
            # and stay zeros.  Root sums are integer totals times the scale.
            qmax = torch.tensor(QUANT_QMAX[mode], device=dev)
            tiny = torch.tensor(1e-30, device=dev)
            s_g = torch.maximum(gv.abs().amax(), tiny) / qmax
            s_h = torch.maximum(hv.abs().amax(), tiny) / qmax
            gv = stochastic_round(gv / s_g, quant_seed)
            hv = stochastic_round(hv / s_h, quant_seed ^ SEED_H_XOR)
            scales = torch.stack([s_g, s_h, torch.ones_like(s_g)])
            root = torch.stack([gv.double().sum().float() * s_g,
                                hv.double().sum().float() * s_h, cv.sum()])
        else:
            root = torch.stack([gv.sum(), hv.sum(), cv.sum()])
        root_out = leaf_output(root[0], root[1], cfg)
        sum_g, sum_h, cnt, out0 = torch.cat(
            [root, root_out[None]]).cpu().numpy()

        st = _LeafState(L, P)
        st.g[0], st.h[0], st.c[0], st.out[0] = sum_g, sum_h, cnt, out0
        st.pend_small[0] = 0
        st.pend_cnt = 1
        leaf_id = torch.zeros(N, dtype=torch.int32, device=dev)
        hist = torch.zeros((L + 1, F, B, 3), dtype=torch.float32, device=dev)
        # row-major twin of the feature-major bins, once per tree: every
        # compaction gather reads one contiguous F-byte row, and the split
        # apply reads each row's bin with one gather
        bins_rm = bins_fm.t().contiguous()
        n_waves = n_rows = 0
        while True:
            ready = st.ready_gains(L)
            phase_max = ready.max()
            can_split = phase_max > 0.0 and int(st.tree.num_leaves) < L
            if not (st.pend_cnt > 0 or can_split):
                break
            splits = []
            for _ in range(P):
                leaf, ok = pick_split(st, phase_max)
                if not ok:
                    break       # the state is unchanged: no later step can
                splits.append(commit(st, leaf))
            leaf_id = apply_splits(leaf_id, bins_rm, splits)
            if st.pend_cnt > 0:
                n_rows += wave(st, hist, bins_fm, bins_rm, leaf_id, gv, hv,
                               cv, feature_mask, scales)
                n_waves += 1

        tr = st.tree._replace(
            leaf_value=st.out[:L].copy(),
            leaf_count=st.c[:L].astype(np.int32),
            leaf_weight=st.h[:L].copy(),
        )
        return (tree_arrays_from_numpy(tr._asdict(), dev), leaf_id,
                (n_waves, n_rows))

    return grow
