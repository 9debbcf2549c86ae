"""LambdaRank NDCG (LightGBM v2.3.2 rank_objective.hpp
GetGradientsForOneQuery) in plain torch, float64: every pair of documents
of a query with different grades, sigmoid 1, label gain 2^g - 1, the
inverse ideal DCG at max_position 20, lambdamart_norm on."""
from __future__ import annotations

import numpy as np
import torch

MAX_POSITION = 20
PAIR_ELEMS = 1 << 24          # pair-tensor elements per chunk of queries


def init_score(label: torch.Tensor, group) -> float:
    return 0.0


def _inverse_max_dcg(label: np.ndarray, sizes: np.ndarray) -> np.ndarray:
    gain = np.exp2(label) - 1.0
    out = np.zeros(len(sizes))
    lo = 0
    for q, s in enumerate(sizes):
        top = np.sort(gain[lo:lo + s])[::-1][:MAX_POSITION]
        dcg = float(np.sum(top / np.log2(np.arange(len(top)) + 2.0)))
        out[q] = 1.0 / dcg if dcg > 0.0 else 0.0
        lo += s
    return out


def gradients(score: torch.Tensor, label: torch.Tensor, group):
    """float64 (g, h) at ``score``; ``group`` holds the query sizes."""
    dev = score.device
    sizes = np.asarray(group, dtype=np.int64)
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    inv = _inverse_max_dcg(label.cpu().numpy(), sizes)
    g = torch.zeros_like(score)
    h = torch.zeros_like(score)
    pad_of = np.maximum(32, 1 << np.ceil(np.log2(np.maximum(sizes, 1)))
                        .astype(np.int64))
    for P in np.unique(pad_of):
        qs = np.flatnonzero((pad_of == P) & (sizes > 1))
        step = max(1, PAIR_ELEMS // int(P * P))
        for lo in range(0, len(qs), step):
            q = qs[lo:lo + step]
            slot = np.arange(P)[None, :]
            valid_np = slot < sizes[q][:, None]
            idx_np = np.where(valid_np, starts[q][:, None] + slot, 0)
            idx = torch.as_tensor(idx_np, device=dev)
            valid = torch.as_tensor(valid_np, device=dev)
            s = torch.where(valid, score[idx],
                            torch.full((), float("-inf"), device=dev,
                                       dtype=torch.float64))
            lab = torch.where(valid, label[idx], -1.0)
            order = torch.sort(s, dim=1, descending=True, stable=True).indices
            pos = torch.argsort(order, dim=1)
            disc = 1.0 / torch.log2(pos.double() + 2.0)
            gain = torch.exp2(lab.clamp(min=0)) - 1.0
            sv = torch.where(valid, s, 0.0)
            best = s.max(dim=1).values
            worst = torch.where(valid, s, float("inf")).min(dim=1).values
            ds = sv[:, :, None] - sv[:, None, :]
            delta = (gain[:, :, None] - gain[:, None, :]) \
                * (disc[:, :, None] - disc[:, None, :]).abs() \
                * torch.as_tensor(inv[q], device=dev)[:, None, None]
            delta = torch.where((best != worst)[:, None, None],
                                delta / (0.01 + ds.abs()), delta)
            p = 1.0 / (1.0 + torch.exp(ds))
            pair = valid[:, :, None] & valid[:, None, :] \
                & (lab[:, :, None] > lab[:, None, :])
            pl = torch.where(pair, -delta * p, 0.0)
            ph = torch.where(pair, delta * p * (1.0 - p), 0.0)
            lam = pl.sum(2) - pl.sum(1)
            hes = ph.sum(2) + ph.sum(1)
            total = -2.0 * pl.sum(dim=(1, 2))
            factor = torch.where(total > 0.0,
                                 torch.log2(1.0 + total)
                                 / total.clamp(min=1e-300), 1.0)
            lam = lam * factor[:, None]
            hes = hes * factor[:, None]
            g[idx[valid]] = lam[valid]
            h[idx[valid]] = hes[valid]
    return g, h


def goss_weight(score32: torch.Tensor, label: torch.Tensor, group):
    g, h = gradients(score32.double(), label, group)
    return torch.abs(g * h)
