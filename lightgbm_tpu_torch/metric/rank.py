"""Ranking metrics: NDCG@k and MAP@k (counterpart of
lightgbm_tpu/metric/rank.py; reference: src/metric/rank_metric.hpp:19,
map_metric.hpp:20, src/metric/dcg_calculator.cpp).

NDCG runs on the training device over padded query blocks
(``core/query.py``): a stable sort of each block's scores, the
gain-times-discount cumsum, one gather per ``eval_at`` k against ideal-DCG
tables baked on the host, and the query-weighted mean; only the
``[len(eval_at)]`` result is read back.  The per-query host loop
(``eval_host``) is its oracle.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..core.query import build_query_blocks, default_label_gain, sort_key
from ..utils import log
from .basic import EvalResult, Metric


class _RankMetric(Metric):
    higher_is_better = True

    def __init__(self, config):
        super().__init__(config)
        self.eval_at = [int(k) for k in (config.eval_at or [1, 2, 3, 4, 5])]

    def init(self, metadata, num_data, device="cpu"):
        super().init(metadata, num_data, device)
        if metadata.query_boundaries is None:
            log.fatal(f"The {self.name} metric requires query information")
        self.query_boundaries = metadata.query_boundaries
        self.query_weights = metadata.query_weights


def ndcg_device(score: torch.Tensor, qb) -> torch.Tensor:
    """The query-weighted NDCG mean at each of ``qb.eval_at``, ``[nK]`` f32
    on the score's device (the JAX package's ``_ndcg_device_fn``,
    lightgbm_tpu/metric/rank.py:44-82): invalid slots sort last at -inf,
    ties keep document order (a stable sort in jnp.argsort's order), and the
    zero-relevance branches are in the tables."""
    nK = len(qb.eval_at)
    dev = score.device
    score_pad = torch.cat([score, score.new_zeros(1)])
    neg_inf = torch.tensor(float("-inf"), device=dev)
    sums = torch.zeros(nK, dtype=torch.float32, device=dev)
    for bk in qb.buckets:
        valid = bk.idx < qb.sentinel
        s = torch.where(valid, score_pad[bk.idx], neg_inf)
        order = torch.argsort(sort_key(-s), dim=-1, stable=True)
        gs = torch.gather(bk.gains, 1, order)
        disc = 1.0 / torch.log2(torch.arange(bk.P, dtype=torch.float32,
                                             device=dev) + 2.0)
        cum = torch.cumsum(gs * disc, dim=-1)
        dcg = torch.gather(cum, 1, bk.k_idx)
        ndcg = dcg * bk.inv_k + bk.one_k
        sums = sums + (bk.qw[:, None] * ndcg).sum(dim=0)
    return sums / torch.tensor(max(qb.wsum, 1e-300), dtype=torch.float32,
                               device=dev)


class NDCGMetric(_RankMetric):
    """NDCG@k averaged over queries; label gain 2^l - 1 (reference:
    rank_metric.hpp:19-100, dcg_calculator.cpp).  Takes the score tensor
    on the training device, or with ``tpu_rank_device_eval=false`` the
    host copy, for the per-query host loop."""
    name = "ndcg"

    def __init__(self, config):
        super().__init__(config)
        self.accepts_device_score = bool(config.tpu_rank_device_eval)
        gains = config.label_gain or []
        self.label_gain = (np.asarray(gains, dtype=np.float64) if gains
                           else default_label_gain())

    def init(self, metadata, num_data, device="cpu"):
        super().init(metadata, num_data, device)
        if not self.accepts_device_score:
            return
        self._qblocks = build_query_blocks(
            self.query_boundaries, self.label, self.label_gain,
            eval_at=self.eval_at, query_weights=self.query_weights,
            sentinel=num_data, with_labels=False, device=device)

    def eval(self, score, objective) -> List[EvalResult]:
        if not isinstance(score, torch.Tensor):
            return self.eval_host(score)
        vals = ndcg_device(score.to(torch.float32), self._qblocks).cpu()
        return [(f"{self.name}@{k}", float(vals[i]), True)
                for i, k in enumerate(self.eval_at)]

    def _dcg_at_k(self, ks, labels, order):
        """DCG at each k of one query in ranking ``order``."""
        gains = self.label_gain[labels[order].astype(np.int64)]
        discounts = 1.0 / np.log2(np.arange(len(order)) + 2.0)
        cum = np.cumsum(gains * discounts)
        return [float(cum[min(k, len(order)) - 1]) if len(order) else 0.0
                for k in ks]

    def eval_host(self, score) -> List[EvalResult]:
        """The per-query host loop: the oracle of ``ndcg_device``."""
        score = np.asarray(score, dtype=np.float64).ravel()
        b = self.query_boundaries
        sums = np.zeros(len(self.eval_at))
        wsum = 0.0
        for q in range(len(b) - 1):
            lo, hi = int(b[q]), int(b[q + 1])
            lab = self.label[lo:hi]
            qw = (float(self.query_weights[q])
                  if self.query_weights is not None else 1.0)
            wsum += qw
            if self.label_gain[lab.astype(np.int64)].max(initial=0.0) <= 0:
                # queries without relevance count as perfect (reference:
                # NDCGMetric::Eval, the empty-dcg case)
                sums += qw
                continue
            idcg = self._dcg_at_k(self.eval_at, lab,
                                  np.argsort(-lab, kind="stable"))
            dcg = self._dcg_at_k(self.eval_at, lab,
                                 np.argsort(-score[lo:hi], kind="stable"))
            for i in range(len(self.eval_at)):
                sums[i] += qw * (dcg[i] / idcg[i] if idcg[i] > 0 else 1.0)
        return [(f"{self.name}@{k}", float(sums[i] / max(wsum, 1e-300)), True)
                for i, k in enumerate(self.eval_at)]


class MapMetric(_RankMetric):
    """MAP@k (reference: map_metric.hpp:20-120)."""
    name = "map"

    def eval(self, score, objective) -> List[EvalResult]:
        score = np.asarray(score, dtype=np.float64).ravel()
        b = self.query_boundaries
        sums = np.zeros(len(self.eval_at))
        wsum = 0.0
        for q in range(len(b) - 1):
            lo, hi = int(b[q]), int(b[q + 1])
            lab = (self.label[lo:hi] > 0).astype(np.float64)
            qw = (float(self.query_weights[q])
                  if self.query_weights is not None else 1.0)
            wsum += qw
            rel = lab[np.argsort(-score[lo:hi], kind="stable")]
            prec = np.cumsum(rel) / (np.arange(len(rel)) + 1.0)
            for i, k in enumerate(self.eval_at):
                kk = min(k, len(rel))
                npos = rel[:kk].sum()
                sums[i] += (qw * float((prec[:kk] * rel[:kk]).sum() / npos)
                            if npos > 0 else qw)
        return [(f"{self.name}@{k}", float(sums[i] / max(wsum, 1e-300)), True)
                for i, k in enumerate(self.eval_at)]
