"""Multiclass objectives (counterpart of lightgbm_tpu/objective/multiclass.py;
reference: src/objective/multiclass_objective.hpp:24-252): the output
conversion a loaded model predicts through."""
from __future__ import annotations

import numpy as np

from .base import PredictionObjective


class MulticlassSoftmax(PredictionObjective):
    """Softmax over the ``num_class`` raw scores of a row."""
    name = "multiclass"

    def __init__(self, config):
        super().__init__(config)
        self.num_class = int(config.num_class)
        self.num_tree_per_iteration = self.num_class

    def convert_output(self, raw):
        raw = np.asarray(raw)
        e = np.exp(raw - raw.max(axis=-1, keepdims=True))
        return e / e.sum(axis=-1, keepdims=True)


class MulticlassOVA(PredictionObjective):
    """One sigmoid per class."""
    name = "multiclassova"

    def __init__(self, config):
        super().__init__(config)
        self.num_class = int(config.num_class)
        self.num_tree_per_iteration = self.num_class
        self.sigmoid = float(config.sigmoid)

    def convert_output(self, raw):
        return 1.0 / (1.0 + np.exp(-self.sigmoid * np.asarray(raw)))
