"""The ranking plane's work, counted (counterpart of lightgbm_tpu/ops/rank.py
``mslr_like_sizes`` and ``rank_pair_cost``): MSLR-WEB30K-shaped query sizes
for synthetic data, and the operations and bytes of one lambdarank pair
pass, from which the pair pass's bound on the card is stated.  The pair
pass is torch (``objective/rank.py``), not a hand kernel."""
from __future__ import annotations

import numpy as np

from ..core.query import CHUNK_ELEMS, bucket_shapes

# elementwise operations per [P, P] pair slot: score, gain and discount
# gaps (3), the delta product and inverse-DCG scale (2), the norm gate and
# divide (3), the sigmoid (exp ~6 + 2), the lambda and hessian products
# (6), the validity mask (2) -- the JAX package's tally
_PAIR_SLOT_OPS = 24.0
# per element per log2(P) step of a sort network; the pair pass sorts
# twice (rank positions need a sort and its inverse)
_SORT_OPS = 8.0


def mslr_like_sizes(rows: int, rng=None) -> np.ndarray:
    """MSLR-WEB30K-shaped ragged query sizes: lognormal(3.8, 1.0) clamped
    to [1, 1251] documents (mean ~72), totalling ``rows``; the JAX
    package's generator, which its bench.py rank legs draw from."""
    if rng is None:
        rng = np.random.default_rng(0)
    out = []
    total = 0
    while total < rows:
        s = int(min(max(1, rng.lognormal(3.8, 1.0)), 1251))
        s = min(s, rows - total)
        out.append(s)
        total += s
    return np.asarray(out, dtype=np.int64)


def rank_pair_cost(sizes, chunk_elems: int = CHUNK_ELEMS):
    """(operations, bytes) of one pair pass over the padded buckets of
    ``sizes``: the ``[Q, P, P]`` pair tensor and the two sorts per block;
    bytes: the block tensors (idx, labels, gains; inverse max DCG) read
    once, the score gather and the g/h scatter (read and write).  The pair
    tensor itself need not leave the chip.  ``chunk_elems=1`` counts the port's blocks
    (no padding queries); the default, the JAX package's."""
    ops = 0.0
    nbytes = 0.0
    for P, Qp, _qc in bucket_shapes(sizes, chunk_elems):
        ops += Qp * P * P * _PAIR_SLOT_OPS
        ops += 2.0 * Qp * P * np.log2(P) * _SORT_OPS
        nbytes += Qp * P * (12.0 + 4.0 + 16.0)
        nbytes += Qp * 4.0
    return ops, nbytes
