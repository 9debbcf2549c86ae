"""Multiclass objectives (counterpart of lightgbm_tpu/objective/multiclass.py;
reference: src/objective/multiclass_objective.hpp:24-252).  Scores are
``[N, num_class]``; the trainer computes g and h once per iteration and
grows class k on column k."""
from __future__ import annotations

import numpy as np
import torch

from ..utils import log
from .base import Objective
from .binary import BinaryLogloss

K_EPSILON = 1e-15


class _IsClass:
    """The positive rows of one-vs-all class ``k`` (a picklable
    callable)."""

    def __init__(self, k: int):
        self.k = k

    def __call__(self, y):
        return np.asarray(y).astype(np.int32) == self.k


class MulticlassSoftmax(Objective):
    """(reference: multiclass_objective.hpp:24-177)."""
    name = "multiclass"

    def __init__(self, config):
        super().__init__(config)
        self.num_class = int(config.num_class)
        self.num_tree_per_iteration = self.num_class

    def init(self, metadata, num_data, device):
        super().init(metadata, num_data, device)
        lab = self.label.astype(np.int32)
        if not ((lab >= 0) & (lab < self.num_class)).all():
            log.fatal(f"Label must be in [0, {self.num_class}), but found "
                      "out of range label")
        counts = np.bincount(lab, minlength=self.num_class)
        self.class_init_probs = counts / max(num_data, 1)
        self._onehot = torch.as_tensor(
            (lab[:, None] == np.arange(self.num_class)[None, :]).astype(
                np.float32)).to(self.device)

    def get_gradients(self, score):
        """score [N, num_class] raw margins -> g, h of that shape.  The
        hessian is the JAX package's 2·p·(1 − p)."""
        p = torch.softmax(score, dim=1)
        g = p - self._onehot
        h = 2.0 * p * (1.0 - p)
        if self._weights_d is not None:
            g = g * self._weights_d[:, None]
            h = h * self._weights_d[:, None]
        return g, h

    def boost_from_score(self, class_id: int = 0) -> float:
        return float(np.log(max(K_EPSILON, self.class_init_probs[class_id])))

    def class_need_train(self, class_id: int) -> bool:
        p = self.class_init_probs[class_id]
        return K_EPSILON < abs(p) < 1.0 - K_EPSILON

    def to_model_string(self) -> str:
        return f"multiclass num_class:{self.num_class}"

    def convert_output(self, raw):
        raw = np.asarray(raw)
        e = np.exp(raw - raw.max(axis=-1, keepdims=True))
        return e / e.sum(axis=-1, keepdims=True)


class MulticlassOVA(Objective):
    """One-vs-all: an independent binary log-loss per class
    (reference: multiclass_objective.hpp:180-252)."""
    name = "multiclassova"

    def __init__(self, config):
        super().__init__(config)
        self.num_class = int(config.num_class)
        self.num_tree_per_iteration = self.num_class
        self.sigmoid = float(config.sigmoid)
        self._binary = [BinaryLogloss(config, is_pos=self._make_is_pos(k))
                        for k in range(self.num_class)]

    @staticmethod
    def _make_is_pos(k):
        return _IsClass(k)

    def init(self, metadata, num_data, device):
        self.num_data = num_data
        self.label = metadata.label
        self.weights = metadata.weights
        self.device = torch.device(device)
        for b in self._binary:
            b.init(metadata, num_data, device)

    def get_gradients(self, score):
        gs, hs = zip(*(b.get_gradients(score[:, k])
                       for k, b in enumerate(self._binary)))
        return torch.stack(gs, dim=1), torch.stack(hs, dim=1)

    def boost_from_score(self, class_id: int = 0) -> float:
        return self._binary[class_id].boost_from_score()

    def class_need_train(self, class_id: int) -> bool:
        return self._binary[class_id].need_train

    def to_model_string(self) -> str:
        return (f"multiclassova num_class:{self.num_class} "
                f"sigmoid:{self.sigmoid:g}")

    def convert_output(self, raw):
        return 1.0 / (1.0 + np.exp(-self.sigmoid * np.asarray(raw)))
