"""Quantized-gradient helpers (counterpart of lightgbm_tpu/ops/pallas_hist.py
``QUANT_MODES`` .. ``quant_error_bound``).

``tpu_hist_dtype=int16|int8`` feeds K1 stochastic-rounded INTEGER g/h under
per-tree symmetric scales ``s = max|x| / QMAX``; K1 accumulates them
exactly and the wave grower dequantizes at split-scan time.

``stochastic_round`` is plain torch and bit for bit the JAX function: a
murmur-style finalizer over the float's own bits, mixed with ``seed``,
gives ``u`` in [0, 1), and the result is ``floor(x + u)``: floor(x) or
ceil(x), except that ``x + u`` is rounded to f32 first, so an
integer-valued x of large magnitude can come out as x + 1 (as in the
reference: a few in 10^4 at the int16 range).  torch's
uint32 has almost no arithmetic, so the hash runs in int64 masked to 32
bits after each step, and each 32x32-bit multiply is split into 16-bit
halves so that no product passes 2^63.  ``u`` and ``x + u`` are two
separate f32 roundings, as in the reference.
"""
from __future__ import annotations

import numpy as np
import torch

QUANT_MODES = ("int16", "int8")
QUANT_QMAX = {"int16": 32767.0, "int8": 127.0}
SEED_H_XOR = 0x9E3779B9        # the hessian's seed is seed ^ this

_M32 = 0xFFFFFFFF


def _mul32(z, c: int):
    """(z * c) mod 2^32 for z in [0, 2^32) held in int64."""
    lo = z * (c & 0xFFFF)                       # < 2^48
    hi = ((z * (c >> 16)) & 0xFFFF) << 16       # < 2^32
    return (lo + hi) & _M32


def stochastic_round(x, seed: int = 0):
    """``floor(x + u(x, seed))`` in f32 with ``u`` in [0, 1) from the value's
    bit pattern: deterministic, value-based (not position-based), and
    zeros stay zero."""
    xf = x.float()
    z = xf.view(torch.int32).to(torch.int64) & _M32
    z = z ^ (int(seed) & _M32)
    z = _mul32(z ^ (z >> 16), 0x7FEB352D)
    z = _mul32(z ^ (z >> 15), 0x846CA68B)
    z = z ^ (z >> 16)
    u = (z >> 8).float() * (2.0 ** -24)         # exact: < 2^24 times 2^-k
    return torch.floor(xf + u)


def quant_error_bound(counts, scale):
    """Per-bin bound on |dequantized - f32| histogram deltas: each row's
    rounded value is within one step of its f32 value and the integer
    accumulation is exact, so a bin of ``counts`` rows is off by at most
    ``counts * scale``."""
    return np.asarray(counts, np.float64) * float(scale)
