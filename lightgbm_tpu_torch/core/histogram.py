"""Histogram construction outside the wave kernel (counterpart of
lightgbm_tpu/core/histogram.py).

``hist_scatter`` is the general single-leaf oracle: a scatter-add over
``(feature, bin)`` cells, the formulation the reference's own GPU path
uses (reference: src/treelearner/ocl/histogram256.cl:350 workgroup
atomics).  The wave grower's histograms come from ``ops/hist_wave.py``
(K1), and, for columns wider than K1's 256 bins, from ``hist_wave_side``,
the wide-column side-pass.  The serial grower's leaf histograms come
from K2 (``ops/hist_channels.py hist_channels_fm``) for columns of up to
256 bins and from ``hist_fixed_point`` above that.  Under EFB,
``expand_bundled`` and ``fix_default_bins`` turn physical-column
histograms into per-feature ones; both are sized by the histogram, not by
the data.
"""
from __future__ import annotations

import contextlib

import torch

# one-hot elements per chunk of the side-pass (256 MB of f32)
_SIDE_CHUNK_ELEMS = 1 << 26


def hist_scatter(bins, g, h, mask, B: int):
    """Dense histogram of one row set.

    bins: uint8/int [N, F] per-row bin indices; g, h, mask: f32 [N]
    (mask = 1.0 for rows to accumulate).  Returns f32 [F, B, 3] =
    (sum_grad, sum_hess, count) per feature x bin."""
    N, F = bins.shape
    ghc = torch.stack([g, h, torch.ones_like(g)], -1) * mask[:, None]  # [N, 3]
    flat = bins.long() + (torch.arange(F, device=bins.device) * B)[None, :]
    out = torch.zeros((F * B, 3), dtype=torch.float32, device=bins.device)
    out.index_add_(0, flat.reshape(-1),
                   ghc[:, None, :].expand(N, F, 3).reshape(-1, 3))
    return out.reshape(F, B, 3)


_FIXED_BITS = 61     # n values of up to 2 * amax sum below 2^62


def hist_fixed_point(bins_fm, g, h, mask, B: int):
    """Single-leaf histogram of wide columns (more than 256 bins, beyond
    K2), repeatable on the card: f32 [F, B, 3] of (sum g*mask, sum h*mask,
    sum mask) for int bins [F, N] (feature major).

    The JAX package computes this histogram in XLA (``hist_scatter``).  A
    float ``index_add_`` on a CUDA tensor adds by atomics in no fixed
    order, so here g and h are fixed point, as K1's float sums are
    (``csrc/hist_wave.cu``): a power-of-two scale 2^k a channel from max
    |g*mask| and |h*mask| over the rows, with k chosen so that N values of
    up to twice that maximum sum below 2^62; each value is rounded once to
    the nearest int64, the sums are integer adds (order-free), and the
    count is an integer sum.  Each sum goes back through f64 (times 2^-k,
    rounded to f32 once)."""
    hist_fixed_point.calls += 1
    F, N = bins_fm.shape
    dev = bins_fm.device
    gh = torch.stack([g * mask, h * mask], 1).float()            # [N, 2]
    amax = (gh.abs().amax(0) if N else
            torch.zeros(2, dtype=torch.float32, device=dev))
    lg = 0 if N <= 1 else (N - 1).bit_length()                  # ceil log2
    k = (_FIXED_BITS - lg - torch.frexp(amax).exponent).double()  # [2]
    src = torch.cat([torch.round(torch.ldexp(gh.double(), k)).long(),
                     mask.long()[:, None]], 1)                   # [N, 3]
    acc = torch.zeros((F, B, 3), dtype=torch.int64, device=dev)
    for f in range(F):
        acc[f].index_add_(0, bins_fm[f].long(), src)
    return torch.cat([torch.ldexp(acc[..., :2].double(), -k),
                      acc[..., 2:].double()], -1).float()


hist_fixed_point.calls = 0        # leaf histograms taken (any device)


def hist_subtract(parent, child):
    """Sibling histogram by subtraction (reference:
    src/treelearner/feature_histogram.hpp:75-81, serial_tree_learner.cpp:567)."""
    return parent - child


@contextlib.contextmanager
def _full_f32_matmul():
    """f32 products in full f32 (no TF32) on the card, whatever the
    process-wide setting; restored after."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def hist_wave_side(bins_rm, gv, hv, cv, leaf_id, slot_leaf, B: int,
                   lanes: int = 128):
    """The wide-column side-pass of the mixed-width wave (counterpart of
    lightgbm_tpu/core/histogram.py ``hist_wave_xla``): K1's triple-layout
    histograms of columns with more than 256 bins.

    bins_rm: ROW-major [N, Fw] bins; gv/hv/cv: f32 [N] (bag-masked g, h,
    count weights); leaf_id: int [N]; slot_leaf: int32 [128] lane -> leaf
    (lanes cycle g, h, count; -1 unused).  Returns f32 [Fw, B, 128] with
    ``out[f, b, c] = sum over rows r with leaf_id[r] == slot_leaf[c] and
    bins[r, f] == b of the lane's value``; only the first ``lanes`` lanes
    are computed (the rest are zero: the wave grower passes 3 x its
    slots).

    The reference's own form: a chunked one-hot contraction, a plain f32
    matrix product ([Fw*B, chunk] x [chunk, lanes]) that the JAX package
    leaves to XLA outside any Pallas kernel.  On the card it runs in full
    f32 (TF32 off) through the library's product, whose sums for one
    shape are the same from call to call, and the chunks add in order, so
    the side-pass is repeatable (scatter adds on CUDA floats are not)."""
    hist_wave_side.calls += 1
    N, Fw = bins_rm.shape
    dev = bins_rm.device
    C = max(1, min(int(lanes), slot_leaf.shape[0]))
    slot = slot_leaf[:C].long()
    kind = torch.arange(C, device=dev) % 3
    vals = torch.stack([gv, hv, cv], 1).float()                  # [N, 3]
    out = torch.zeros((Fw * B, C), dtype=torch.float32, device=dev)
    chunk = max(128, _SIDE_CHUNK_ELEMS // max(Fw * B, 1))
    offs = (torch.arange(Fw, device=dev) * B)[None, :]
    with _full_f32_matmul():
        for r0 in range(0, N, chunk):
            b = bins_rm[r0:r0 + chunk].long()
            n = b.shape[0]
            m = (leaf_id[r0:r0 + chunk].long()[:, None] == slot[None, :]) \
                & (slot >= 0)[None, :]
            gh = torch.where(m, vals[r0:r0 + chunk][:, kind],
                             torch.zeros((), device=dev))         # [n, C]
            oh = torch.zeros((n, Fw * B), dtype=torch.float32, device=dev)
            oh.scatter_(1, b + offs, 1.0)
            out += oh.t() @ gh
    res = torch.zeros((Fw, B, 128), dtype=torch.float32, device=dev)
    res[:, :, :C] = out.reshape(Fw, B, C)
    return res


hist_wave_side.calls = 0          # side-passes run (any device)


def expand_bundled(hist_phys, meta, B_out: int):
    """EFB expansion: physical-column histograms -> per-feature ones
    (io/bundling.py layout).  hist_phys: f32 [F_phys, B_phys, C]; returns
    [F, B_out, C] with ``out[f, b] = hist_phys[feat2phys[f], feat_offset[f]
    + b]`` for b within feature f's bins, zero elsewhere."""
    Fp, Bp, C = hist_phys.shape
    b = torch.arange(B_out, device=hist_phys.device)
    off = meta.feat_offset.long()[:, None]
    idx = meta.feat2phys.long()[:, None] * Bp + off + b[None, :]
    valid = (b[None, :] < meta.num_bins.long()[:, None]) & (off + b < Bp)
    out = hist_phys.reshape(Fp * Bp, C)[torch.where(valid, idx, 0)]
    return out * valid[..., None]


def fix_default_bins(hist, tg, th, tc, meta, alive=None):
    """Rebuild each bundled member's elided default-bin mass from the leaf
    totals (reference: Dataset::FixHistogram, src/io/dataset.cpp:1044-1063):
    ``hist[..., f, default_bin_f] += total - sum_b hist[..., f, b]``.
    hist: f32 [..., F, B, 3]; tg/th/tc: the leaf totals, [...].
    ``alive`` (bool [F_phys]) marks the physical columns that survived
    the voting learner's gate: members of a gated-off column stay zero
    (a fix would put the whole leaf at their default bin)."""
    sums = hist.sum(-2)                                          # [..., F, 3]
    totals = torch.stack([tg, th, tc], -1).to(hist.dtype)[..., None, :]
    fix = meta.needs_fix
    if alive is not None:
        fix = fix & alive[meta.feat2phys.long()]
    resid = torch.where(fix[:, None], totals - sums,
                        torch.zeros((), dtype=hist.dtype,
                                    device=hist.device))
    F = hist.shape[-3]
    out = hist.clone()
    out[..., torch.arange(F, device=hist.device),
        meta.default_bins.long(), :] += resid
    return out
