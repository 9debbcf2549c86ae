"""HIGGS-shaped binary data, drawn from the seed on the run's device.

A frozen copy of ``bench.py``'s synthetic HIGGS generator (also
``chip_smoke.py higgs_like``): 28 standard-normal features, a label from a
logistic draw around a linear blend of the first 8 and one interaction.
Departures from the copied generator: the rows and the label noise are
one ``torch.Generator`` on the device in a few large calls (seeded by
``--seed``) instead of NumPy's; the blend's weights are one fixed draw
(``problem_seed``), so every seed poses the same problem on other rows and
carries the same work; the features stay float32 (the binning reads
float32 as is).
"""
from __future__ import annotations

import numpy as np
import torch


def make(spec: dict, seed: int, device: torch.device) -> dict:
    rows = int(spec["rows"])
    feats = int(spec["features"])
    informative = int(spec["informative"])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    X = torch.randn(rows, feats, generator=gen, device=device,
                    dtype=torch.float32)
    w = torch.as_tensor(np.random.default_rng(int(spec["problem_seed"]))
                        .normal(size=informative), device=device)
    logit = X[:, :informative].double() @ w \
        + float(spec["interaction"]) * X[:, 0].double() * X[:, 1].double()
    u = torch.rand(rows, generator=gen, device=device, dtype=torch.float64)
    u = u.clamp_(1e-12, 1.0 - 1e-12)
    y = (logit + torch.log(u / (1.0 - u)) > 0).double()
    return {"X": X.cpu().numpy(), "label": y.cpu().numpy(), "group": None}
