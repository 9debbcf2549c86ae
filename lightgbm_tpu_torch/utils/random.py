"""Deterministic RNG for the bin-construction row sample (the ``sample``
of lightgbm_tpu/utils/random.py, copied so both packages draw the same
rows and so find the same bins).

Plays the role of the reference's lightweight ``Random`` helper
(reference: include/LightGBM/utils/random.h). It does not reproduce the
reference's LCG bit-for-bit, only determinism for a given seed: NumPy's
PCG64 on the host.
"""
from __future__ import annotations

import numpy as np


class Random:
    def __init__(self, seed: int = 0):
        self._gen = np.random.Generator(np.random.PCG64(seed))

    def sample(self, n: int, k: int) -> np.ndarray:
        """k distinct indices from range(n), sorted ascending.

        Mirrors the contract of the reference ``Random::Sample`` (used for
        feature_fraction and bin-sample selection).
        """
        k = min(k, n)
        if k <= 0:
            return np.empty(0, dtype=np.int32)
        idx = self._gen.choice(n, size=k, replace=False)
        idx.sort()
        return idx.astype(np.int32)


# ---- jax.random's threefry2x32 draw, reproduced bit for bit ------------
#
# GOSS (boosting/goss.py) draws ``jax.random.uniform(jax.random.fold_in(
# jax.random.PRNGKey(seed), it), (N,))`` in the JAX package.  Threefry-2x32
# (Salmon et al., "Parallel random numbers: as easy as 1, 2, 3", SC 2011;
# jax/_src/prng.py) is public integer arithmetic, so the same bits come
# out here: uint32 words held in int64 tensors and masked to 32 bits, so
# the same code runs on the CPU and on the card.  The draw follows jax's
# ``jax_threefry_partitionable`` mode (on in jax 0.5 and later): element i
# hashes the 64-bit counter i, split into (hi, lo) words, and its bits are
# the XOR of the two output words.

_U32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl32(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _U32


def threefry2x32(k0: int, k1: int, x0, x1):
    """Threefry-2x32 with 20 rounds of key ``(k0, k1)`` on the counter
    words ``(x0, x1)`` (Python ints or int64 tensors of uint32 values);
    returns the two output words."""
    ks = (k0 & _U32, k1 & _U32, (k0 ^ k1 ^ 0x1BD11BDA) & _U32)
    x0 = (x0 + ks[0]) & _U32
    x1 = (x1 + ks[1]) & _U32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _U32
            x1 = _rotl32(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _U32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _U32
    return x0, x1


def prng_key(seed: int):
    """``jax.random.PRNGKey(seed)``: the key words (seed >> 32, seed &
    0xFFFFFFFF) of a non-negative seed (a 32-bit seed pads with 0)."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return (seed >> 32) & _U32, seed & _U32


def fold_in(key, data: int):
    """``jax.random.fold_in(key, data)``: the key hashed with the counter
    words (0, data)."""
    return threefry2x32(key[0], key[1], 0, int(data) & _U32)


def uniform_f32(key, n: int, device="cpu"):
    """``jax.random.uniform(key, (n,))`` (f32 in [0, 1)) on ``device``:
    the partitionable bits of counters 0..n-1, their top 23 bits as the
    mantissa of a float in [1, 2), minus 1."""
    import torch
    lo = torch.arange(n, dtype=torch.int64, device=device)
    b0, b1 = threefry2x32(key[0], key[1], torch.zeros_like(lo), lo)
    bits = (b0 ^ b1) >> 9 | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0
