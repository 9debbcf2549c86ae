"""Cross-entropy objectives (counterpart of lightgbm_tpu/objective/xentropy.py;
reference: src/objective/xentropy_objective.hpp:44-260)."""
from __future__ import annotations

import numpy as np
import torch

from ..utils import log
from .base import Objective


class CrossEntropy(Objective):
    """Labels in [0, 1] (reference: xentropy_objective.hpp:44-145)."""
    name = "cross_entropy"

    def init(self, metadata, num_data, device):
        super().init(metadata, num_data, device)
        if ((self.label < 0) | (self.label > 1)).any():
            log.fatal("[cross_entropy]: label should be in [0, 1]")

    def get_gradients(self, score):
        z = 1.0 / (1.0 + torch.exp(-score))
        return self._apply_weight(z - self._label_d, z * (1.0 - z))

    def boost_from_score(self, class_id: int = 0) -> float:
        if self.weights is not None:
            pavg = float(np.sum(self.label * self.weights)
                         / np.sum(self.weights))
        else:
            pavg = float(np.mean(self.label))
        pavg = min(max(pavg, 1e-15), 1.0 - 1e-15)
        return float(np.log(pavg / (1.0 - pavg)))

    def convert_output(self, raw):
        return 1.0 / (1.0 + np.exp(-np.asarray(raw)))


class CrossEntropyLambda(Objective):
    """Weighted cross-entropy in the lambda parameterization
    (reference: xentropy_objective.hpp:148-260)."""
    name = "cross_entropy_lambda"

    def init(self, metadata, num_data, device):
        super().init(metadata, num_data, device)
        if ((self.label < 0) | (self.label > 1)).any():
            log.fatal("[cross_entropy_lambda]: label should be in [0, 1]")
        if self.weights is not None and (self.weights <= 0).any():
            log.fatal("[cross_entropy_lambda]: at least one weight is "
                      "non-positive")

    def get_gradients(self, score):
        if self._weights_d is None:
            z = 1.0 / (1.0 + torch.exp(-score))
            return z - self._label_d, z * (1.0 - z)
        w = self._weights_d
        y = self._label_d
        epf = torch.exp(score)
        hhat = torch.log1p(epf)
        z = 1.0 - torch.exp(-w * hhat)
        enf = 1.0 / epf
        g = (1.0 - y / z) * w / (1.0 + enf)
        c = 1.0 / (1.0 - z)
        d = 1.0 + epf
        a = w * epf / (d * d)
        d2 = c - 1.0
        b = (c / (d2 * d2)) * (1.0 + w * epf - c)
        h = a * (1.0 + y * b)
        return g, h

    def boost_from_score(self, class_id: int = 0) -> float:
        if self.weights is not None:
            havg = float(np.sum(self.label * self.weights)
                         / np.sum(self.weights))
        else:
            havg = float(np.mean(self.label))
        return (float(np.log(np.expm1(havg))) if havg > 0
                else float(np.log(1e-15)))

    def convert_output(self, raw):
        return np.log1p(np.exp(np.asarray(raw)))
