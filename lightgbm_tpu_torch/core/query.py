"""Padded query blocks, the device side of ranking (counterpart of
lightgbm_tpu/core/query.py).

Queries are ragged (MSLR-WEB30K's span 1-1,251 documents).  They are
grouped once, at ``init``, into power-of-two padded-length buckets, each
holding ``[Q, P]`` doc-index, label and gain tensors and per-query scalars
(inverse max DCG, query weight, per-``eval_at``-k NDCG tables) on the
training device.  Invalid slots carry index ``sentinel`` (the row count):
a gather through a score padded by one element reads a value that is
masked out, and a write to it is dropped.

The JAX package additionally pads each bucket's query count to a multiple
of its ``lax.map`` chunk (``[nc, qc, P]``); here a bucket keeps its ``Q``
queries and the pair pass (``objective/rank.py``) walks them in chunks
whose size it picks from the device's memory at call time, so the blocks
are the JAX package's rows without the padding queries.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..utils import log

# the JAX package's pair-tensor budget per lax.map step (elements): the
# port's pair pass on the CPU
CHUNK_ELEMS = 1 << 19
MIN_PAD = 8
# the longest padded query: one [P, P] pair matrix is built per query
MAX_PAD = 4096
MAX_LABEL = 31


def default_label_gain(n: int = MAX_LABEL) -> np.ndarray:
    """2^label - 1 (reference: DCGCalculator::DefaultLabelGain)."""
    return np.asarray([(1 << i) - 1 for i in range(n)], dtype=np.float64)


def max_dcg_at_k(k: int, labels: np.ndarray, gains: np.ndarray) -> float:
    """Ideal DCG truncated at k (reference: DCGCalculator::CalMaxDCGAtK)."""
    top = np.sort(labels)[::-1][:k]
    disc = 1.0 / np.log2(np.arange(len(top)) + 2.0)
    return float((gains[top.astype(np.int64)] * disc).sum())


def query_pads(sizes: np.ndarray, min_pad: int = MIN_PAD) -> np.ndarray:
    """Per-query power-of-two padded length; fatal past MAX_PAD."""
    if sizes.max(initial=0) > MAX_PAD:
        log.fatal(f"Query with {int(sizes.max())} documents exceeds the "
                  f"supported maximum of {MAX_PAD} for lambdarank")
    return np.maximum(min_pad, 2 ** np.ceil(
        np.log2(np.maximum(sizes, 1))).astype(np.int64))


def chunk_queries(P: int, chunk_elems: int = CHUNK_ELEMS) -> int:
    """Queries per pair-pass chunk at pad ``P``: bounds the ``[qc, P, P]``
    pair tensor to ``chunk_elems``."""
    return max(1, chunk_elems // (P * P))


def bucket_shapes(sizes, chunk_elems: int = CHUNK_ELEMS,
                  min_pad: int = MIN_PAD):
    """``[(P, Qp, qc)]``: each bucket's pad, its query count padded to a
    chunk multiple (the JAX package's layout) and its chunk.  With
    ``chunk_elems=1`` the count is the bucket's own, the port's layout."""
    sizes = np.asarray(sizes, dtype=np.int64)
    pads = query_pads(sizes, min_pad=min_pad)
    out = []
    for P in np.unique(pads):
        Q = int((pads == P).sum())
        qc = chunk_queries(int(P), chunk_elems)
        out.append((int(P), -(-Q // qc) * qc, qc))
    return out


def pair_chunk_elems(device) -> int:
    """The pair pass's chunk (elements of one ``[qc, P, P]`` tensor) on
    ``device``: the JAX package's ``CHUNK_ELEMS`` on the CPU; on a card, an
    eighth of the free memory over the pass's ~16 f32 temporaries of that
    size, capped at 2^26, so an MSLR-sized pass takes tens of chunks, not
    thousands.  The results do not depend on it."""
    device = torch.device(device)
    if device.type != "cuda":
        return CHUNK_ELEMS
    free, _ = torch.cuda.mem_get_info(device)
    return int(min(1 << 26, max(CHUNK_ELEMS, free // (8 * 16 * 4))))


class QueryBucket:
    """Every query whose padded length is ``P``: ``idx``/``labs``/``gains``
    ``[Q, P]`` and ``inv`` ``[Q]`` (inverse max DCG at ``max_position``);
    with ``eval_at``, per query and k: NDCG = dcg[k_idx]·inv_k + one_k, so
    queries without relevance (or with an ideal DCG <= 0) count as
    perfect, as the host loop counts them, and ``qw`` the query weight."""
    __slots__ = ("P", "idx", "labs", "gains", "inv", "k_idx", "inv_k",
                 "one_k", "qw")

    def __init__(self, **kw):
        for k in self.__slots__:
            setattr(self, k, kw.get(k))


class QueryBlocks:
    """The padded-query-bucket set of one (query set, label) pair."""

    def __init__(self, buckets: List[QueryBucket], sentinel: int,
                 eval_at: Optional[List[int]], wsum: float,
                 num_queries: int):
        self.buckets = buckets
        self.sentinel = int(sentinel)
        self.eval_at = list(eval_at) if eval_at else None
        self.wsum = float(wsum)
        self.num_queries = int(num_queries)


def build_query_blocks(query_boundaries, label, label_gain, *,
                       optimize_pos_at: int = 20,
                       eval_at: Optional[Sequence[int]] = None,
                       query_weights=None, sentinel: Optional[int] = None,
                       with_labels: bool = True,
                       device="cpu") -> QueryBlocks:
    """Group the queries into padded-length buckets and build their static
    tensors on ``device`` (reference package: core/query.py
    ``build_query_blocks``; the inverse max DCG is rank_objective.hpp:60-70's
    cache).  ``with_labels=False`` skips the pair pass's labels and inverse
    max DCG for blocks that only evaluate NDCG."""
    b = np.asarray(query_boundaries, dtype=np.int64)
    label = np.asarray(label, dtype=np.float64)
    gains_tab = np.asarray(label_gain, dtype=np.float64)
    sizes = np.diff(b)
    if sentinel is None:
        sentinel = int(b[-1])
    pads = query_pads(sizes)
    ks = [int(k) for k in eval_at] if eval_at else None
    nK = len(ks) if ks else 0
    buckets: List[QueryBucket] = []
    wsum = 0.0

    def dev(a):
        return None if a is None else torch.as_tensor(a).to(device)

    for P in np.unique(pads):
        P = int(P)
        sel = np.flatnonzero(pads == P)
        Q = len(sel)
        idx = np.full((Q, P), sentinel, dtype=np.int64)
        labs = np.zeros((Q, P), dtype=np.float32)
        gains = np.zeros((Q, P), dtype=np.float32)
        inv = np.zeros(Q, dtype=np.float32)
        k_idx = np.zeros((Q, nK), dtype=np.int64) if nK else None
        inv_k = np.zeros((Q, nK), dtype=np.float32) if nK else None
        one_k = np.zeros((Q, nK), dtype=np.float32) if nK else None
        qw = np.zeros(Q, dtype=np.float32) if nK else None
        for r, q in enumerate(sel):
            lo, hi = int(b[q]), int(b[q + 1])
            cnt = hi - lo
            idx[r, :cnt] = np.arange(lo, hi)
            ql = label[lo:hi]
            qi = ql.astype(np.int64)
            gains[r, :cnt] = gains_tab[qi]
            if with_labels:
                labs[r, :cnt] = ql
                maxdcg = max_dcg_at_k(optimize_pos_at, qi, gains_tab)
                inv[r] = 1.0 / maxdcg if maxdcg > 0.0 else 0.0
            if not nK:
                continue
            w = (float(query_weights[q]) if query_weights is not None
                 else 1.0)
            qw[r] = w
            wsum += w
            zero_rel = (gains_tab[qi].max(initial=0.0) <= 0.0
                        if cnt else True)
            if cnt:
                ideal = np.sort(qi)[::-1]
                disc = 1.0 / np.log2(np.arange(cnt) + 2.0)
                icum = np.cumsum(gains_tab[ideal] * disc)
            for i, k in enumerate(ks):
                kk = min(k, cnt)
                k_idx[r, i] = max(kk - 1, 0)
                idcg = float(icum[kk - 1]) if cnt else 0.0
                if zero_rel or idcg <= 0.0:
                    one_k[r, i] = 1.0
                else:
                    inv_k[r, i] = 1.0 / idcg
        buckets.append(QueryBucket(
            P=P, idx=dev(idx), labs=dev(labs) if with_labels else None,
            gains=dev(gains), inv=dev(inv) if with_labels else None,
            k_idx=dev(k_idx), inv_k=dev(inv_k), one_k=dev(one_k),
            qw=dev(qw)))
    return QueryBlocks(buckets, sentinel, ks, wsum, len(sizes))


def sort_key(x: torch.Tensor) -> torch.Tensor:
    """int32 keys of f32 values that sort as ``jnp.argsort`` sorts them:
    -0.0 ties with +0.0 (a stable sort keeps their document order) and
    every NaN goes last.  Sorting the integers gives that order on any
    device; a float sort on the card need not tie the two zeros."""
    x = torch.where(torch.isnan(x), torch.full_like(x, float("nan")).abs(),
                    x + 0.0)
    bits = x.contiguous().view(torch.int32)
    return torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
