"""Epsilon-shaped binary data (the PASCAL Large Scale Learning Challenge
set in LIBSVM's ``epsilon_normalized`` form), drawn from the seed on the
run's device.

Epsilon is dense: every row holds all of its 2,000 numerical features,
each feature standardised over the rows, then each row scaled to unit
length.  Here the raw features are standard normal from one
``torch.Generator`` seeded by ``--seed``, then standardised over the rows
and normalised by row, as the set's own preparation does.  The label is a
logistic draw around a fixed blend (``problem_seed``): a linear part over
``informative`` features chosen at random and ``pairs`` products of two
features, each part scaled to unit variance before its weight
(``signal``, ``interaction``).  Every seed then poses the same problem on
other rows, with the same work, and the positives are about one half.

Departures from the real set: synthetic rows in place of the LIBSVM file
(the repository holds no data set); the label's blend is this file's own,
not the challenge's unknown one; float32 throughout (the file's values
are decimal text).
"""
from __future__ import annotations

import numpy as np
import torch


def make(spec: dict, seed: int, device: torch.device) -> dict:
    rows = int(spec["rows"])
    feats = int(spec["features"])
    informative = int(spec["informative"])
    pairs = int(spec["pairs"])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    X = torch.randn(rows, feats, generator=gen, device=device,
                    dtype=torch.float32)
    X -= X.mean(0)
    X /= X.std(0).clamp_(min=1e-12)
    X /= torch.linalg.vector_norm(X, dim=1, keepdim=True).clamp_(min=1e-12)

    rng = np.random.default_rng(int(spec["problem_seed"]))
    lin_idx = rng.choice(feats, informative, replace=False)
    w = rng.normal(size=informative)
    pair_idx = np.stack([rng.choice(feats, 2, replace=False)
                         for _ in range(pairs)])
    v = rng.normal(size=pairs)

    def col(idx):
        # features back at unit variance: a unit row spreads over feats
        return X[:, torch.as_tensor(idx, device=device)].double() \
            * feats ** 0.5
    lin = col(lin_idx) @ torch.as_tensor(w / np.sqrt(informative),
                                         device=device)
    inter = (col(pair_idx[:, 0]) * col(pair_idx[:, 1])) @ torch.as_tensor(
        v / np.sqrt(pairs), device=device)
    logit = float(spec["signal"]) * lin + float(spec["interaction"]) * inter
    u = torch.rand(rows, generator=gen, device=device, dtype=torch.float64)
    u = u.clamp_(1e-12, 1.0 - 1e-12)
    y = (logit + torch.log(u / (1.0 - u)) > 0).double()
    return {"X": X.cpu().numpy(), "label": y.cpu().numpy(), "group": None}
