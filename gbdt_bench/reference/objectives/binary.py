"""Binary log-loss with sigmoid 1 (LightGBM v2.3.2
binary_objective.hpp), in plain torch."""
from __future__ import annotations

import math

import torch

K_EPSILON = 1e-15


def init_score(label: torch.Tensor, group) -> float:
    """boost_from_average: the log-odds of the positive share."""
    p = float((label > 0).double().mean())
    p = min(max(p, K_EPSILON), 1.0 - K_EPSILON)
    return math.log(p / (1.0 - p))


def gradients(score: torch.Tensor, label: torch.Tensor, group):
    """float64 (g, h) at ``score``."""
    y = torch.where(label > 0, 1.0, -1.0).double()
    r = -y / (1.0 + torch.exp(y * score))
    a = r.abs()
    return r, a * (1.0 - a)


def goss_weight(score32: torch.Tensor, label: torch.Tensor, group):
    """|g h| as GOSS ranks the rows, in float32 from float32 scores: the
    top set is decided in the precision the sampler decides it in, so a
    row at the threshold falls on the same side."""
    y = torch.where(label > 0, 1.0, -1.0).float()
    r = -y * 1.0 / (1.0 + torch.exp(y * 1.0 * score32))
    a = torch.abs(r)
    g = r * torch.ones_like(r)
    h = a * (1.0 - a) * torch.ones_like(r)
    return torch.abs(g * h)
