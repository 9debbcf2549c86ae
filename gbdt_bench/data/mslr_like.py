"""MSLR-WEB30K-shaped lambdarank data, drawn from the seed.

Frozen copies of ``chip_smoke.py mslr_like`` / bench.py ``_rank_data``
(136 standard-normal features; grades 0-4 by within-query quantiles of a
noisy blend of the first 12).  The query sizes follow fold 1's training
set instead of ``ops/rank.py mslr_like_sizes`` (lognormal(3.8, 1.0),
about 31,000 queries of 74 documents on 2,270,296 rows): ``rows /
mean_docs`` queries (18,919 of a mean of 120.0 at fold 1's rows), at
most ``max_docs``, drawn from a lognormal of ``size_sigma`` (the copied
generator's 1.0) and scaled to the rows.  They are one fixed set, drawn
from ``size_seed``; ``--seed`` only permutes their order, so every seed
carries the same pair work (the sum of the squared query sizes), and the
blend's weights are one fixed draw (``problem_seed``).  Features and
noise come from one ``torch.Generator`` on the device; the per-query
quantile loop of the original is one vectorised pass (the same linear
interpolation as ``np.quantile``, the same ``np.searchsorted`` rule).
"""
from __future__ import annotations

import math

import numpy as np
import torch


def query_sizes(rows: int, mean_docs: float, max_docs: int, sigma: float,
                rng) -> np.ndarray:
    """round(rows / mean_docs) query sizes in [1, max_docs] that total
    ``rows``: a lognormal draw with that mean, scaled to the rows, the
    rows left by rounding down handed one each to the queries that lost
    the most."""
    queries = max(1, round(rows / mean_docs))
    s = rng.lognormal(math.log(rows / queries) - sigma ** 2 / 2, sigma,
                      queries)
    for _ in range(100):
        s = np.clip(s * rows / s.sum(), 1.0, max_docs)
    n = np.floor(s).astype(np.int64)
    frac = np.where(n < max_docs, s - n, -1.0)
    short = rows - int(n.sum())
    n[np.argsort(-frac, kind="stable")[:short]] += 1
    if n.sum() != rows or n.max() > max_docs:
        raise ValueError(f"{queries} queries of at most {max_docs} "
                         f"documents cannot hold {rows} rows")
    return n


def grades(score: torch.Tensor, sizes: torch.Tensor,
           quantiles) -> torch.Tensor:
    """Per row, how many of the query's ``quantiles`` of ``score`` lie
    strictly below it (``np.searchsorted(np.quantile(q, qs), q)``)."""
    Q = sizes.shape[0]
    qid = torch.repeat_interleave(torch.arange(Q, device=score.device), sizes)
    order = torch.argsort(score, stable=True)
    order = order[torch.argsort(qid[order], stable=True)]
    v = score[order]                                  # sorted within queries
    start = torch.cumsum(sizes, 0) - sizes
    out = torch.zeros_like(score)
    for p in quantiles:
        pos = p * (sizes - 1).double()
        lo = torch.floor(pos).long()
        hi = torch.minimum(lo + 1, sizes - 1)
        frac = pos - lo.double()
        a, b = v[start + lo], v[start + hi]
        thr = a + frac * (b - a)
        out += (thr[qid] < score).double()
    return out


def make(spec: dict, seed: int, device: torch.device) -> dict:
    rows = int(spec["rows"])
    feats = int(spec["features"])
    informative = int(spec["informative"])
    sizes = query_sizes(rows, float(spec["mean_docs"]),
                        int(spec["max_docs"]), float(spec["size_sigma"]),
                        np.random.default_rng(int(spec["size_seed"])))
    sizes = sizes[np.random.default_rng(int(seed)).permutation(len(sizes))]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    X = torch.randn(rows, feats, generator=gen, device=device,
                    dtype=torch.float32)
    w = torch.as_tensor(np.random.default_rng(int(spec["problem_seed"]))
                        .normal(size=informative), device=device)
    u = torch.rand(rows, generator=gen, device=device, dtype=torch.float64)
    u = u.clamp_(1e-12, 1.0 - 1e-12)
    score = X[:, :informative].double() @ w \
        + float(spec["noise_scale"]) * torch.log(u / (1.0 - u))
    y = grades(score, torch.as_tensor(sizes, device=device),
               spec["grade_quantiles"])
    return {"X": X.cpu().numpy(), "label": y.cpu().numpy(), "group": sizes}
