"""Wave histogram K1: the CUDA kernel's wrapper and its plain PyTorch
version (counterpart of lightgbm_tpu/ops/pallas_hist.py
``hist_pallas_wave`` / ``_hist_wave_kernel``).

One wave's per-leaf histograms: the sums over rows r with ``leaf_id[r] ==
slot_leaf[c]`` and ``bins[f, r] == b`` of lane c's value, in one of two
channel layouts, each f32 [F, B, 128]:

* packed (``packed=True``, 63 leaves): lane pairs (g, h) in ``gh`` and the
  count weight of pair s in lane s of ``cnt``; returns ``(gh, cnt)``;
* triple (``packed=False``, 42 leaves): lanes 3s, 3s+1, 3s+2 hold g, h and
  the count; returns one array.

With ``parent`` (in the same layout) the call also returns ``sibling =
parent - child`` from the same launch.

Modes.  Float modes round g/h before the f32 accumulation, as the Pallas
kernel's MXU passes do: ``highest`` keeps f32, ``bf16`` rounds once,
``2xbf16`` adds the bf16 hi part and the bf16 rounding of the remainder
(16 mantissa bits).  The packed count goes through bf16 in every mode
(exact for 0/1); the triple count lane is rounded like g and h.  The
quantized modes ``int16``/``int8`` take integer-valued g/h
(``ops/quant.stochastic_round`` output), cast to int16 as the reference's
cast does (``_int_stream``); the sums are exact integers and the outputs
hold them in f32 ("integer units"; the wave grower dequantizes at
split-scan time).

On Hopper (``csrc/hist_wave.cu``) the function's byte bound is the
``F*N`` bin read, the row-vector read (16 bytes a row) and the [F, B, 128]
histogram traffic per launch.  Every mode takes one pass over the rows:
one thread a row, the row's values and slot found once, features in an
inner loop, the lanes of a warp that hit the same cell summed first.  The
sums go into an accumulator [F, B, S, ...] in device memory (L2-resident,
zeroed here with each launch), or, in a wave whose whole histogram fits in
shared memory (at 28 features x 256 bins: the root wave, and in the int
modes the next two), into a per-block copy there that is added into the
accumulator once; an epilogue writes the layout and the sibling.

* float modes: a fixed-point int64 (g, h) accumulator beside an f32 count
  one; two 64-bit reductions and one f32 reduction a group; the
  shared-memory copy (one slot at 28 x 256) is written by one warp a
  feature without atomics;
* int modes: a packed int64 accumulator, each cell's three sums in one
  64-bit word that one atomic adds (with corrections for the fields that
  wrap), so the sums are exact at any number of rows; the shared-memory
  copy is int32 with native shared atomics, at most 65,535 rows a block,
  and also takes larger waves in tiles of two features or more (up to 33
  slots at 28 x 256) when a block's rows outnumber a feature's cells.

The source's header says more.  In the float modes the kernel sums g and
h in fixed point (int64, a power-of-two scale per launch from the
stream's max |g| and |h|), so its sums do not depend on the order of the
adds: two launches on the same inputs are bit-equal.  They agree with
``hist_wave_plain``'s f32 sums to f32 rounding (within 1e-5 of each
cell's sum of magnitudes in a cell of up to 1,000 rows, sqrt(n / 1000)
times that in a cell of n rows more: the rounding of the plain f32 sum
grows as sqrt(n)), counts exactly (the count weights are 0 or 1).  The
int modes add integers and equal the plain version bit for bit.

``hist_wave`` takes the plain version only for tensors on the CPU; for
CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import torch

from ..obs.core import phase
from ..utils import log
from . import build as _build
from .quant import QUANT_MODES

C_MAX = 128                      # lanes of one output
P_MAX_PACKED = C_MAX // 2 - 1    # 63 leaves per wave
P_MAX_TRIPLE = C_MAX // 3        # 42 leaves per wave
_MODES = {"highest": 0, "2xbf16": 1, "bf16": 2, "int16": 3, "int8": 4}
_INT16_MIN, _INT16_MAX = -32768, 32767


def wave_capacity_max(packed: bool) -> int:
    """Leaves one launch can histogram under the given layout."""
    return P_MAX_PACKED if packed else P_MAX_TRIPLE


def hist_wave_cost(N: int, F: int, B: int, rows: int, packed: bool = True,
                   fused: bool = False, quant: bool = False):
    """(operations, bytes) of one K1 launch over N rows of F features, of
    which ``rows`` are in a pending slot: bytes, the ``F*N`` bin read, the
    row vectors (16 bytes a row, 8 in the int modes), the slot map, and
    each [F, B, 128] f32 output written once and, fused, the parents read
    and the siblings written; operations, the g, h and count adds of every
    (feature, slotted row) and, fused, the sibling subtraction per cell.
    ``chip_smoke.py`` states K1's bound from it, and profile mode
    (``obs/profile.py``) holds each launch against it."""
    hist_bytes = F * B * C_MAX * 4
    n_hist = (2 if packed else 1) * (3 if fused else 1)
    n_bytes = F * N + (8 if quant else 16) * N + C_MAX * 4 + n_hist * hist_bytes
    n_ops = 3 * F * rows + (n_hist // 3 * F * B * C_MAX if fused else 0)
    return float(n_ops), float(n_bytes)


def hist_wave_call_cost(bins_fm, gv, hv, cv, leaf_id, slot_leaf, B: int,
                        highest="bf16", packed: bool = True, parent=None,
                        num_slots=None, exact: bool = False):
    """``hist_wave_cost`` of a call with ``hist_wave``'s arguments; every
    row counts as slotted, as the wave grower hands K1 only the rows of
    its pending leaves."""
    F, N = bins_fm.shape
    return hist_wave_cost(N, F, B, N, packed=packed,
                          fused=parent is not None,
                          quant=resolve_mode(highest) in QUANT_MODES)


def resolve_mode(highest) -> str:
    """True -> "highest", False -> "bf16"; strings pass through."""
    if isinstance(highest, str):
        if highest not in _MODES:
            log.fatal(f"hist_wave mode {highest!r}: the modes are "
                      f"{', '.join(_MODES)}")
        return highest
    return "highest" if highest else "bf16"


def round_values(x, mode: str):
    """Float-mode g/h as the kernel accumulates them (module docstring)."""
    if mode == "highest":
        return x
    hi = x.to(torch.bfloat16).float()
    if mode == "bf16":
        return hi
    return hi + (x - hi).to(torch.bfloat16).float()


def _int_stream(gv, hv, cv, leaf_id):
    """The quantized row vectors [N, 4] int16 (g, h, count weight, leaf),
    converted as the reference's f32 -> int16 cast does: saturating to
    [-32768, 32767], NaN to 0.  The stochastic rounding can lift a
    maximum of 32767 to 32768, which saturates back; leaf ids stay below
    32768 because the config caps ``num_leaves`` at 32000."""
    vecs = torch.stack([gv.float(), hv.float(), cv.float(),
                        leaf_id.float()], 1)
    return vecs.nan_to_num(0.0).clamp(_INT16_MIN, _INT16_MAX).to(torch.int16)


def hist_wave_plain(bins_fm, gv, hv, cv, leaf_id, slot_leaf, B: int,
                    highest="bf16", packed: bool = True, parent=None,
                    exact: bool = False):
    """Plain PyTorch K1 with ``hist_pallas_wave``'s data arguments and
    outputs (its TPU tiling knobs have no counterpart).

    bins_fm: uint8 [F, N]; gv/hv/cv: f32 [N] (bag-masked g, h and count
    weights; integer-valued in the int modes); leaf_id: int [N];
    slot_leaf: int32 [128] lane -> leaf (-1 unused).  Returns the layout's
    output (module docstring); with ``parent`` ``(child, sibling)``.
    ``exact`` (int modes, no ``parent``): the int64 sums themselves,
    before their one rounding to f32."""
    mode = resolve_mode(highest)
    F, N = bins_fm.shape
    dev = bins_fm.device
    if mode in QUANT_MODES:
        q = _int_stream(gv, hv, cv, leaf_id).long()
        vals = (q[:, 0], q[:, 1], q[:, 2])
        leaf = q[:, 3]
        acc_dtype = torch.int64
    else:
        count_mode = mode if not packed else "bf16"
        vals = (round_values(gv.float(), mode), round_values(hv.float(), mode),
                round_values(cv.float(), count_mode))
        leaf = leaf_id.long()
        acc_dtype = torch.float32
    slot = slot_leaf.long()
    lanes = torch.arange(C_MAX, device=dev)
    if packed:
        # (output, value, lanes read for the leaf, lanes written)
        even, odd = lanes[0::2], lanes[1::2]
        passes = ((0, vals[0], even, even), (0, vals[1], odd, odd),
                  (1, vals[2], even, lanes[:C_MAX // 2]))
    else:
        kind = lanes % 3
        passes = tuple((0, vals[k], lanes[kind == k], lanes[kind == k])
                       for k in range(3))
    n_out = 2 if packed else 1
    outs = [torch.zeros(F * B * C_MAX, dtype=acc_dtype, device=dev)
            for _ in range(n_out)]
    fb = torch.arange(F, device=dev)[:, None] * B
    for o, val, read, write in passes:
        want = slot[read]
        r, s = torch.nonzero((leaf[:, None] == want[None]) & (want >= 0)[None],
                             as_tuple=True)
        b = bins_fm[:, r].long()                            # [F, K]
        keep = b < B
        idx = (fb + b) * C_MAX + write[s][None, :]
        outs[o].index_add_(0, idx[keep],
                           val[r][None, :].expand(F, -1)[keep].to(acc_dtype))
    outs = [(o if exact and acc_dtype == torch.int64 else o.float())
            .reshape(F, B, C_MAX) for o in outs]
    child = tuple(outs) if packed else outs[0]
    if parent is None:
        return child
    if packed:
        return child, (parent[0] - child[0], parent[1] - child[1])
    return child, parent - child


def _check(name, t, dtype, shape=None, device=None):
    if t.dtype != dtype:
        raise TypeError(f"hist_wave: {name} must be {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"hist_wave: {name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if device is not None and t.device != device:
        raise ValueError(f"hist_wave: {name} is on {t.device}, "
                         f"expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"hist_wave: {name} must be contiguous")


def hist_wave(bins_fm, gv, hv, cv, leaf_id, slot_leaf, B: int,
              highest="bf16", packed: bool = True, parent=None,
              num_slots: int = None, exact: bool = False):
    """K1 on the tensors' device: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors.  Same arguments and results as
    ``hist_wave_plain``; ``num_slots`` (default: the layout's capacity)
    tells the kernel how many leading slots are in use, which sizes its
    accumulator.  ``exact`` (int modes, no ``parent``) returns the int64
    sums in the layout, read from the kernel's packed accumulator
    (``decode_packed``): a sum of them across ranks, rounded to f32 once,
    is the single-process histogram bit for bit.

    Kernel preconditions (the wave grower meets them): the lanes of each
    slot s < ``num_slots`` map to one leaf, lanes past them are -1, no
    leaf in two slots, ``B <= 256``."""
    if exact and (parent is not None
                  or resolve_mode(highest) not in QUANT_MODES):
        raise ValueError("hist_wave: exact sums are the int modes' and "
                         "unfused")
    if bins_fm.device.type == "cpu":
        hist_wave.plain_calls += 1
        # the range a CPU profiler window holds against K1's cost (on the
        # card K1 is found by its CUDA symbol)
        with phase("hist_wave"):
            return hist_wave_plain(bins_fm, gv, hv, cv, leaf_id, slot_leaf,
                                   B, highest=highest, packed=packed,
                                   parent=parent, exact=exact)
    if not bins_fm.is_cuda:
        raise ValueError(f"hist_wave: no kernel for device {bins_fm.device}")
    mode = resolve_mode(highest)
    quant = mode in QUANT_MODES
    dev = bins_fm.device
    F, N = bins_fm.shape
    cap = wave_capacity_max(packed)
    S = cap if num_slots is None else int(num_slots)
    if not (0 <= S <= cap):
        raise ValueError(f"hist_wave: num_slots must be in [0, {cap}], "
                         f"got {S}")
    if not (1 <= B <= 256):
        raise ValueError(f"hist_wave: B must be in [1, 256], got {B}")
    _check("bins_fm", bins_fm, torch.uint8)
    for name, t in (("gv", gv), ("hv", hv), ("cv", cv)):
        _check(name, t, torch.float32, (N,), dev)
    if leaf_id.dtype not in (torch.int32, torch.int64):
        raise TypeError("hist_wave: leaf_id must be int32 or int64")
    _check("leaf_id", leaf_id, leaf_id.dtype, (N,), dev)
    _check("slot_leaf", slot_leaf, torch.int32, (C_MAX,), dev)
    hist_shape = (F, B, C_MAX)
    n_out = 2 if packed else 1
    pars = [None, None]
    if parent is not None:
        pars = list(parent) if packed else [parent, None]
        for i in range(n_out):
            _check(f"parent[{i}]", pars[i], torch.float32, hist_shape, dev)

    lib = _build.load()
    if quant:
        # the kernel casts g, h and the count weights to int16 as
        # _int_stream does; leaf ids saturate the same way
        leaf = (leaf_id if leaf_id.dtype == torch.int32 else
                leaf_id.clamp(_INT16_MIN, _INT16_MAX).int())
        # the packed int64 accumulator [F, B, S, 4] (csrc/hist_wave.cu)
        acc = torch.zeros(F * B * S * 4, dtype=torch.int64, device=dev)
    else:
        # leaf ids ride the f32 vector stream like the Pallas kernel's
        # (exact below 2^24)
        vecs = torch.stack([gv, hv, cv, leaf_id.float()], 1)
        # max |g| and |h| of the stream set the launch's fixed-point
        # scales; one reduction on the device, never read on the host
        amax = (vecs[:, :2].abs().amax(0) if N else
                torch.zeros(2, dtype=torch.float32, device=dev))
        # the fixed-point g/h accumulator [F, B, S, 2] and the f32 count
        # one [F, B, S] the row pass reduces into
        acc = torch.zeros(F * B * S * 2, dtype=torch.int64, device=dev)
        acc_c = torch.zeros(F * B * S, dtype=torch.float32, device=dev)
    outs = [torch.empty(hist_shape, dtype=torch.float32, device=dev)
            for _ in range(n_out)] + [None] * (2 - n_out)
    sibs = [None, None]
    if parent is not None:
        sibs = [torch.empty(hist_shape, dtype=torch.float32, device=dev)
                for _ in range(n_out)] + [None] * (2 - n_out)

    def ptr(t):
        return None if t is None else t.data_ptr()

    tail = (ptr(pars[0]), ptr(pars[1]), ptr(outs[0]), ptr(outs[1]),
            ptr(sibs[0]), ptr(sibs[1]),
            torch.cuda.current_stream(dev).cuda_stream)
    stride = 2 if packed else 3
    if quant:
        err = lib.lgbm_hist_wave_int(ptr(bins_fm), ptr(gv), ptr(hv), ptr(cv),
                                     ptr(leaf), ptr(slot_leaf), F, N, B, S,
                                     stride, ptr(acc), *tail)
    else:
        err = lib.lgbm_hist_wave(ptr(bins_fm), ptr(vecs), ptr(amax),
                                 ptr(slot_leaf), F, N, B, S, stride,
                                 _MODES[mode], ptr(acc), ptr(acc_c), *tail)
    _build.check_launch("hist_wave", err)
    hist_wave.launches += 1
    hist_wave.layout_launches["packed" if packed else "triple"] += 1
    hist_wave.sibling_launches["fused" if parent is not None
                               else "unfused"] += 1
    if exact:
        return decode_packed(acc, F, B, S, packed)
    child = tuple(outs) if packed else outs[0]
    if parent is None:
        return child
    return child, (tuple(sibs) if packed else sibs[0])


_FIELDS = (21, 21, 22)      # csrc/hist_wave.cu kField0, kField1, the rest


def _sext(x, bits: int):
    """The low ``bits`` of int64 ``x`` as a signed value."""
    return torch.bitwise_right_shift(
        torch.bitwise_left_shift(x, 64 - bits), 64 - bits)


def decode_packed(acc, F: int, B: int, S: int, packed: bool = True):
    """K1's int accumulator ``[F, B, S, 4]`` int64 (the packed word W of a
    cell's (g, h, count) and the three correction words,
    ``csrc/hist_wave.cu`` ``PackedAcc``) as the layout's int64 sums: field
    k of W plus correction k, W's fields unpacked as the kernel's
    ``unpack`` does."""
    a = acc.reshape(F, B, S, 4)
    w = a[..., 0]
    d = []
    for k, bits in enumerate(_FIELDS):
        v = _sext(w, bits)
        d.append(v + a[..., 1 + k])
        if k < 2:
            # (w - v) >> bits, a logical shift of the unsigned word
            w = torch.bitwise_and(torch.bitwise_right_shift(w - v, bits),
                                  (1 << (64 - bits)) - 1)
    sums = torch.stack(d, -1)                             # [F, B, S, 3]
    out = [torch.zeros((F, B, C_MAX), dtype=torch.int64, device=acc.device)
           for _ in range(2 if packed else 1)]
    if packed:
        out[0][..., :2 * S] = sums[..., :2].reshape(F, B, 2 * S)
        out[1][..., :S] = sums[..., 2]
        return tuple(out)
    out[0][..., :3 * S] = sums.reshape(F, B, 3 * S)
    return out[0]


hist_wave.launches = 0                                   # all launches
hist_wave.plain_calls = 0           # calls answered by the plain version
hist_wave.layout_launches = {"packed": 0, "triple": 0}   # by layout
hist_wave.sibling_launches = {"fused": 0, "unfused": 0}  # by sibling form
