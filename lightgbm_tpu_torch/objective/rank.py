"""Lambdarank NDCG (counterpart of lightgbm_tpu/objective/rank.py;
reference: src/objective/rank_objective.hpp:23-254).

The reference walks each query's document pairs in a host loop
(GetGradientsForOneQuery, rank_objective.hpp:117-166).  Here, as in the
JAX package, the queries sit in padded buckets (``core/query.py``) and
each chunk of queries evaluates its whole ``[qc, P, P]`` pair tensor of
sigmoid lambdas at once; a Python loop over chunks takes the place of
``lax.map``, with the chunk sized from the device's memory
(``pair_chunk_elems``).  Each query's arithmetic does not depend on the
chunking.  The sigmoid is computed exactly, not from the reference's
lookup table.
"""
from __future__ import annotations

import numpy as np
import torch

from ..convert import to_device
from ..core.query import (build_query_blocks, chunk_queries,
                          default_label_gain, pair_chunk_elems,
                          sort_key)
from ..utils import log
from .base import Objective


def _check_rank_labels(label: np.ndarray, num_gains: int) -> None:
    """(reference: DCGCalculator::CheckLabel)."""
    if not np.all(label == np.floor(label)):
        log.fatal("label should be int type (met type with decimals) for "
                  "ranking task")
    if label.min(initial=0) < 0 or label.max(initial=0) >= num_gains:
        log.fatal(f"label excel [0, {num_gains}) range for ranking task")


def _chunk_lambdas(score_pad, idx, labs, gains, inv, sentinel: int,
                   sig: float, norm: bool):
    """(lambda, hessian) ``[qc, P]`` of one chunk of queries: the JAX
    package's ``pair_lambdas`` ``chunk_fn`` (lightgbm_tpu/objective/
    rank.py:65-110), operation for operation."""
    valid = idx < sentinel
    s_raw = score_pad[idx]                     # the pad slot is masked
    neg_inf = to_device(float("-inf"), idx.device)
    s_sort = torch.where(valid, s_raw, neg_inf)
    # rank positions: a stable sort in jnp.argsort's float order (ties
    # keep document order like the reference's stable_sort), then its
    # inverse
    order = torch.argsort(sort_key(-s_sort), dim=-1, stable=True)
    pos = torch.argsort(order, dim=-1, stable=True)
    disc = 1.0 / torch.log2(pos.to(torch.float32) + 2.0)

    sv = torch.where(valid, s_raw, torch.zeros((), device=idx.device))
    best = s_sort.max(dim=-1).values
    worst = torch.where(valid, s_raw, -neg_inf).min(dim=-1).values

    ds = sv[:, :, None] - sv[:, None, :]                   # [qc, P, P]
    delta = (gains[:, :, None] - gains[:, None, :]) \
        * (disc[:, :, None] - disc[:, None, :]).abs_() * inv[:, None, None]
    if norm:
        delta = torch.where((best != worst)[:, None, None],
                            delta / (0.01 + ds.abs()), delta)
    p0 = torch.sigmoid(-sig * ds)
    del ds
    vp = (valid[:, :, None] & valid[:, None, :]
          & (labs[:, :, None] > labs[:, None, :]))
    zero = torch.zeros((), device=idx.device)
    pl = torch.where(vp, -sig * delta * p0, zero)
    ph = torch.where(vp, sig * sig * delta * p0 * (1.0 - p0), zero)
    del vp, delta, p0
    lam = pl.sum(dim=2) - pl.sum(dim=1)
    hes = ph.sum(dim=2) + ph.sum(dim=1)
    if norm:
        sum_lambdas = -2.0 * pl.sum(dim=(1, 2))
        factor = torch.where(
            sum_lambdas > 0.0,
            torch.log2(1.0 + sum_lambdas) / sum_lambdas.clamp(min=1e-30),
            torch.ones((), device=idx.device))
        lam = lam * factor[:, None]
        hes = hes * factor[:, None]
    return lam, hes


def pair_lambdas(score: torch.Tensor, blocks, sigmoid: float, norm: bool,
                 chunk_elems: int = None):
    """Flat f32 (g, h) like ``score`` [N] from the pair pass over the padded
    query buckets of ``blocks`` (``core/query.py QueryBlocks``), in chunks
    of ``chunk_elems`` pair-tensor elements (default: by the device's
    memory).  Every row belongs to exactly one query, so each chunk's
    values are written, not added, into g and h; the pad slot past the
    rows takes the invalid slots' writes and is dropped."""
    N = score.shape[0]
    if chunk_elems is None:
        chunk_elems = pair_chunk_elems(score.device)
    pad = torch.zeros(1, dtype=score.dtype, device=score.device)
    score_pad = torch.cat([score, pad])
    g = torch.zeros(N + 1, dtype=torch.float32, device=score.device)
    h = torch.zeros(N + 1, dtype=torch.float32, device=score.device)
    for bk in blocks.buckets:
        qc = chunk_queries(bk.P, chunk_elems)
        for lo in range(0, bk.idx.shape[0], qc):
            sl = slice(lo, lo + qc)
            lam, hes = _chunk_lambdas(score_pad, bk.idx[sl], bk.labs[sl],
                                      bk.gains[sl], bk.inv[sl],
                                      blocks.sentinel, sigmoid, norm)
            flat = bk.idx[sl].reshape(-1)
            # + 0.0: the JAX package adds into zeros, so -0.0 lands as +0.0
            g[flat] = lam.reshape(-1) + 0.0
            h[flat] = hes.reshape(-1) + 0.0
    return g[:N], h[:N]


class LambdarankNDCG(Objective):
    name = "lambdarank"
    # the data-parallel learner may split the pair pass on query
    # boundaries across ranks (parallel/rank_shard.py)
    supports_query_sharding = True
    _shard = None

    def __init__(self, config):
        super().__init__(config)
        self.sigmoid = float(config.sigmoid)
        self.norm = bool(config.lambdamart_norm)
        self.optimize_pos_at = int(config.max_position)
        gains = list(config.label_gain or [])
        self.label_gain = (np.asarray(gains, dtype=np.float64) if gains
                           else default_label_gain())
        if self.sigmoid <= 0.0:
            log.fatal(f"Sigmoid param {self.sigmoid} should be greater than "
                      "zero")

    def init(self, metadata, num_data, device):
        super().init(metadata, num_data, device)
        if metadata.query_boundaries is None:
            log.fatal("Lambdarank tasks require query information")
        label = np.asarray(self.label, dtype=np.float64)
        _check_rank_labels(label, len(self.label_gain))
        self.query_boundaries = np.asarray(metadata.query_boundaries,
                                           dtype=np.int64)
        self.qblocks = build_query_blocks(
            self.query_boundaries, label, self.label_gain,
            optimize_pos_at=self.optimize_pos_at, sentinel=num_data,
            device=self.device)

    def get_gradients(self, score):
        if self._shard is not None:
            g, h = self._shard(score)
        else:
            g, h = pair_lambdas(score, self.qblocks, self.sigmoid, self.norm)
        return self._apply_weight(g, h)
