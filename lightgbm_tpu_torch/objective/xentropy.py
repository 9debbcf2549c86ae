"""Cross-entropy objectives (counterpart of lightgbm_tpu/objective/xentropy.py;
reference: src/objective/xentropy_objective.hpp:44-260): the output
conversion a loaded model predicts through."""
from __future__ import annotations

import numpy as np

from .base import PredictionObjective


class CrossEntropy(PredictionObjective):
    name = "cross_entropy"

    def convert_output(self, raw):
        return 1.0 / (1.0 + np.exp(-np.asarray(raw)))


class CrossEntropyLambda(PredictionObjective):
    name = "cross_entropy_lambda"

    def convert_output(self, raw):
        return np.log1p(np.exp(np.asarray(raw)))
