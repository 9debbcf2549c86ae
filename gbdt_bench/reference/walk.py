"""Trees of the model text walked over the raw rows in plain torch (the
reference's partition and scores; LightGBM v2.3.2's NumericalDecision)."""
from __future__ import annotations

import torch

from .model_text import depth

K_ZERO_THRESHOLD = 1e-35


def leaves(tree: dict, X: torch.Tensor) -> torch.Tensor:
    """int64 leaf index of every row of ``X`` ([N, F], raw values)."""
    N = X.shape[0]
    dev = X.device
    if tree["num_leaves"] <= 1:
        return torch.zeros(N, dtype=torch.long, device=dev)
    dt = tree["decision_type"]
    if (dt & 1).any():
        raise ValueError("categorical splits are outside the reference")
    t = {k: torch.as_tensor(tree[k], device=dev) for k in (
        "split_feature", "threshold", "left_child", "right_child")}
    dtt = torch.as_tensor(dt, device=dev)
    default_left = (dtt & 2) != 0
    missing = (dtt >> 2) & 3                  # 0 none, 1 zero, 2 NaN
    rows = torch.arange(N, device=dev)
    node = torch.zeros(N, dtype=torch.long, device=dev)   # ~leaf when < 0
    for _ in range(depth(tree)):
        live = node >= 0
        cur = node.clamp(min=0)
        x = X[rows, t["split_feature"][cur]].double()
        mt = missing[cur]
        nan = torch.isnan(x)
        x = torch.where(nan & (mt != 2), torch.zeros_like(x), x)
        to_default = ((mt == 1) & (x.abs() <= K_ZERO_THRESHOLD)) \
            | ((mt == 2) & nan)
        left = torch.where(to_default, default_left[cur],
                           x <= t["threshold"][cur])
        nxt = torch.where(left, t["left_child"][cur], t["right_child"][cur])
        node = torch.where(live, nxt, node)
    return ~node


def raw_scores(trees: list, X: torch.Tensor) -> torch.Tensor:
    """float64 sum of every tree's leaf value over the rows of ``X``."""
    out = torch.zeros(X.shape[0], dtype=torch.float64, device=X.device)
    for tree in trees:
        lv = torch.as_tensor(tree["leaf_value"], device=X.device)
        out += lv[leaves(tree, X)]
    return out
