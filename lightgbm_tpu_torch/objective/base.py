"""Objective interface (counterpart of lightgbm_tpu/objective/base.py;
reference: include/LightGBM/objective_function.h:19-91)."""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


class Objective:
    """Base objective: ``get_gradients`` is elementwise torch on the score's
    device.  Labels and weights are bound on the training device at
    ``init``; the host copies stay for ``boost_from_score`` and the leaf
    refits."""

    name = "none"
    is_renew_tree_output = False
    num_tree_per_iteration = 1

    def __init__(self, config):
        self.config = config
        self.num_data = 0
        self.label: Optional[np.ndarray] = None
        self.weights: Optional[np.ndarray] = None

    def init(self, metadata, num_data: int, device) -> None:
        """Bind labels and weights (reference: ObjectiveFunction::Init)."""
        self.num_data = num_data
        self.label = metadata.label
        self.weights = metadata.weights
        self.device = torch.device(device)
        self._to_device()

    def _to_device(self) -> None:
        self._label_d = (None if self.label is None else
                         torch.as_tensor(self.label).to(self.device))
        self._weights_d = (None if self.weights is None else
                           torch.as_tensor(self.weights).to(self.device))

    def _apply_weight(self, g, h):
        if self._weights_d is not None:
            return g * self._weights_d, h * self._weights_d
        return g, h

    def get_gradients(self, score) -> Tuple[torch.Tensor, torch.Tensor]:
        raise NotImplementedError

    def health_tap(self, g, h, iteration: int) -> bool:
        """The health sentinel on this objective's gradients, called once
        an iteration while ``tpu_health`` is on, so a non-finite gradient
        is put down to the objective that made it.  True when healthy."""
        from ..obs import health
        return health.check_gradients(g, h, phase="boosting (grad/hess)",
                                      iteration=iteration,
                                      objective=self.name)

    def boost_from_score(self, class_id: int = 0) -> float:
        return 0.0

    def class_need_train(self, class_id: int) -> bool:
        return True

    def to_model_string(self) -> str:
        """The model text's ``objective=`` value, as the JAX package writes
        it (lightgbm_tpu/io/model_io.py ``_objective_string``)."""
        return self.name

    def convert_output(self, raw: np.ndarray) -> np.ndarray:
        """Raw margin -> user-space prediction."""
        return raw

    def renew_leaf_values(self, residual: np.ndarray, leaf_id: np.ndarray,
                          num_leaves: int, bag_mask: np.ndarray) -> np.ndarray:
        """Per-leaf refit for percentile-style losses (reference:
        RenewTreeOutput, serial_tree_learner.cpp:855-893): new leaf
        outputs [num_leaves], NaN = keep the grown value."""
        raise NotImplementedError

    def __str__(self) -> str:
        return self.name


def percentile(values: np.ndarray, weights: Optional[np.ndarray],
               alpha: float) -> float:
    """(Weighted) percentile with the reference's interpolation
    (reference: PercentileFun / WeightedPercentileFun,
    src/objective/regression_objective.hpp:18-76)."""
    cnt = len(values)
    if cnt == 0:
        return 0.0
    if cnt == 1:
        return float(values[0])
    order = np.argsort(values, kind="stable")
    data = values[order]
    if weights is None:
        float_pos = (1.0 - alpha) * cnt
        pos = int(float_pos)
        if pos < 1:
            return float(data[-1])
        if pos >= cnt:
            return float(data[0])
        bias = float_pos - pos
        # the reference selects the (pos-1)/pos-th largest
        v1 = data[cnt - pos]
        v2 = data[cnt - pos - 1]
        return float(v1 - (v1 - v2) * bias)
    cdf = np.cumsum(weights[order])
    threshold = cdf[-1] * alpha
    pos = min(int(np.searchsorted(cdf, threshold, side="right")), cnt - 1)
    if pos == 0 or pos == cnt - 1:
        return float(data[pos])
    v1, v2 = float(data[pos - 1]), float(data[pos])
    if cdf[pos + 1] - cdf[pos] >= 1.0:
        return float((threshold - cdf[pos]) / (cdf[pos + 1] - cdf[pos])
                     * (v2 - v1) + v1)
    return v2
