"""Regression objectives (counterpart of lightgbm_tpu/objective/regression.py;
reference: src/objective/regression_objective.hpp:78-757): the output
conversion a loaded model predicts through.  Training with them is not in
the port yet (``PredictionObjective``)."""
from __future__ import annotations

import numpy as np

from .base import PredictionObjective


class RegressionL2(PredictionObjective):
    """(reference: regression_objective.hpp:78-186); ``reg_sqrt`` squares
    the prediction back."""
    name = "regression"

    def __init__(self, config):
        super().__init__(config)
        self.sqrt = bool(getattr(config, "reg_sqrt", False))

    def convert_output(self, raw):
        raw = np.asarray(raw)
        if self.sqrt:
            return np.sign(raw) * raw * raw
        return raw


class RegressionL1(RegressionL2):
    name = "regression_l1"


class RegressionHuber(RegressionL2):
    name = "huber"


class RegressionFair(RegressionL2):
    name = "fair"


class RegressionQuantile(RegressionL2):
    name = "quantile"


class RegressionMAPE(RegressionL2):
    name = "mape"


class RegressionPoisson(RegressionL2):
    """log link (reference: regression_objective.hpp:381-459)."""
    name = "poisson"

    def convert_output(self, raw):
        return np.exp(np.asarray(raw))


class RegressionGamma(RegressionPoisson):
    name = "gamma"


class RegressionTweedie(RegressionPoisson):
    name = "tweedie"
