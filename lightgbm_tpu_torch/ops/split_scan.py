"""The wave's split scan: the CUDA kernel's wrapper and its plain PyTorch
version.  It replaces no Pallas kernel: the JAX package's scan is XLA
(lightgbm_tpu/core/splitter.py ``best_split``).  It was added because
the eager scan is launch-bound: some hundred small launches a wave over
[n, F, B] tensors, a few microseconds of device work each behind tens of
microseconds of host dispatch, and seven host-to-device copies.  Its
bound is the candidate histograms' bytes read once (``split_scan_cost``).

One wave's best numerical split of each candidate leaf, as
``core/splitter.py best_split`` (no categorical feature) followed by the
wave grower's ``max_depth`` mask computes it, in the [n, 9 + W] f64 block
the grower reads in one copy: gain, feature, threshold, default_left,
left g / h / count, left and right outputs, then W bitset words (zero: a
numerical split has no category set).  Its inputs are the whole
per-leaf histogram ``hist`` [L + 1, F, B, 3] (read in place at the
candidates' rows), the per-wave block of ``pack_block`` (candidate ids
and their sums, monotone windows and depths, one host-to-device copy),
the [s_g, s_h, 1] scales that dequantize integer-unit histograms, the
feature mask and CEGB's pending coupled penalties (``coupled`` [F];
each feature's gain loses ``count x split_pen + coupled[f]``).

On Hopper (``csrc/split_scan.cu``) one launch scans the wave: a block a
candidate leaf, warps striding over the features, the running sums by
warp-shuffle scans in f64 (LightGBM's FindBestThresholdSequence sums in
double), the reference's tie order (dir -1 from high thresholds to low,
then dir +1 from low to high, the first strict maximum; across features
the lower index).  The plain version sums in f32 (``best_split``), so the
two agree to f32 rounding and may part on near ties.

``split_scan`` takes the plain version only for tensors on the CPU; for
CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.meta import DeviceMeta, SplitConfig
from ..core.splitter import best_split, bitset_words
from . import build as _build

BLOCK_ROWS = 7       # pack_block's rows: id, g, h, count, min_c, max_c, depth
RESULT_COLS = 9      # the result row's fields before the bitset words
# operations of one threshold in one direction: two leaf outputs (a
# divide, the L1 soft threshold, the clips) and their gains, the guards
# and the comparison; the scan adds three running sums a bin besides
_OPS_A_THRESHOLD = 24


def pack_block(cand, g, h, c, min_c, max_c, depth) -> np.ndarray:
    """The per-wave input of the scan, f32 [7, n]: the candidate leaf ids,
    their g, h and count sums, monotone window and depth (rows 0 and 6
    hold int32 bits), taken from the grower's [L + 1] host state.  Ids
    are resolved as numpy indexes them: the root wave's sibling, -1 (the
    root has none), is the scratch slot L, where the kernel reads it."""
    blk = np.empty((BLOCK_ROWS, len(cand)), np.float32)
    ints = blk.view(np.int32)
    ints[0] = np.arange(len(g), dtype=np.int32)[cand]
    for r, a in enumerate((g, h, c, min_c, max_c), 1):
        blk[r] = a[cand]
    ints[6] = depth[cand]
    return blk


def split_scan_cost(n: int, F: int, B: int):
    """(operations, bytes) of one scan of n candidate leaves: bytes, the
    candidates' [F, B, 3] f32 histograms read once and their result rows
    (9 + W f64) written once; operations, the running sums' three adds a
    bin and both directions' gain at every threshold.  ``chip_smoke.py``
    states the kernel's bound from it, and profile mode
    (``obs/profile.py``) holds each launch against it."""
    n_bytes = 12 * n * F * B + 8 * n * (RESULT_COLS + bitset_words(B))
    n_ops = n * F * B * (3 + 2 * _OPS_A_THRESHOLD)
    return float(n_ops), float(n_bytes)


def split_scan_call_cost(hist, blk, meta, cfg, scales=None,
                         feature_mask=None, coupled=None, split_pen=0.0):
    """``split_scan_cost`` of a call with ``split_scan``'s arguments."""
    return split_scan_cost(blk.shape[1], hist.shape[1], hist.shape[2])


def split_scan_plain(hist, blk, meta: DeviceMeta, cfg: SplitConfig,
                     scales=None, feature_mask=None, coupled=None,
                     split_pen: float = 0.0, has_cat: bool = False):
    """The scan in plain PyTorch: ``best_split`` on the candidates'
    histograms, then the ``max_depth`` mask.  ``has_cat`` scans the
    categorical features too (their bin sets fill the bitset words); the
    wave grower takes this form for a dataset with one."""
    ids = blk[0].view(torch.int32).long()
    sum_g, sum_h, cnt, min_c, max_c = blk[1:6]
    hist_c = hist[ids]
    if scales is not None:
        hist_c = hist_c * scales
    pen = (cnt[:, None] * split_pen + coupled[None, :]
           if coupled is not None else None)
    bs = best_split(hist_c, sum_g, sum_h, cnt, meta, cfg, min_c, max_c,
                    feature_mask=feature_mask, has_cat=has_cat,
                    penalty_sub=pen)
    gain = bs.gain
    if cfg.max_depth > 0:
        gain = torch.where(blk[6].view(torch.int32) < cfg.max_depth, gain,
                           torch.full_like(gain, float("-inf")))
    # one f64 block: the f32 results and the int32 bitset words both
    # convert exactly
    return torch.cat([torch.stack(
        [gain, bs.feature.float(), bs.threshold.float(),
         bs.default_left.float(), bs.left_g, bs.left_h, bs.left_c,
         bs.left_out, bs.right_out], 1).double(),
        bs.cat_bitset.double()], 1)


def _check(name, t, dtype, shape, device):
    if t.dtype != dtype:
        raise TypeError(f"split_scan: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"split_scan: {name} must have shape "
                         f"{tuple(shape)}, got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"split_scan: {name} is on {t.device}, "
                         f"expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"split_scan: {name} must be contiguous")


def split_scan(hist, blk, meta: DeviceMeta, cfg: SplitConfig, scales=None,
               feature_mask=None, coupled=None, split_pen: float = 0.0):
    """The scan on the tensors' device: the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors.  hist: f32 [L + 1, F, B, 3]; blk:
    ``pack_block``'s f32 [7, n] on the same device; scales: f32 [3] or
    None; feature_mask: bool [F] or None; coupled: f32 [F] or None.
    Returns f64 [n, 9 + W].  No feature may be categorical (the kernel
    scans thresholds only; the wave grower knows this on the host)."""
    if hist.device.type == "cpu":
        split_scan.plain_calls += 1
        return split_scan_plain(hist, blk, meta, cfg, scales=scales,
                                feature_mask=feature_mask, coupled=coupled,
                                split_pen=split_pen)
    if not hist.is_cuda:
        raise ValueError(f"split_scan: no kernel for device {hist.device}")
    dev = hist.device
    if hist.dim() != 4 or hist.shape[3] != 3:
        raise ValueError(f"split_scan: hist must be [L + 1, F, B, 3], got "
                         f"{tuple(hist.shape)}")
    _, F, B, _ = hist.shape
    n = blk.shape[1] if blk.dim() == 2 else -1
    _check("hist", hist, torch.float32, hist.shape, dev)
    _check("blk", blk, torch.float32, (BLOCK_ROWS, n), dev)
    for name in ("num_bins", "default_bins", "missing_types", "monotone"):
        _check(f"meta.{name}", getattr(meta, name), torch.int32, (F,), dev)
    _check("meta.penalties", meta.penalties, torch.float32, (F,), dev)
    if scales is not None:
        _check("scales", scales, torch.float32, (3,), dev)
    if feature_mask is not None:
        _check("feature_mask", feature_mask, torch.bool, (F,), dev)
    if coupled is not None:
        _check("coupled", coupled, torch.float32, (F,), dev)
    W = bitset_words(B)
    out = torch.empty((n, RESULT_COLS + W), dtype=torch.float64, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = _build.load().lgbm_split_scan(
        ptr(hist), ptr(blk), ptr(scales), ptr(meta.num_bins),
        ptr(meta.default_bins), ptr(meta.missing_types), ptr(meta.monotone),
        ptr(meta.penalties), ptr(feature_mask), ptr(coupled),
        hist.shape[0], n, F, B, W,
        int(cfg.max_depth), float(split_pen), float(cfg.lambda_l1),
        float(cfg.lambda_l2), float(cfg.min_data_in_leaf),
        float(cfg.min_sum_hessian_in_leaf), float(cfg.min_gain_to_split),
        float(cfg.max_delta_step), ptr(out),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch("split_scan", err)
    split_scan.launches += 1
    return out


split_scan.launches = 0              # kernel launches
split_scan.plain_calls = 0           # calls answered by the plain version
