"""Binary log-loss objective (counterpart of
lightgbm_tpu/objective/binary.py; reference:
src/objective/binary_objective.hpp:21-187)."""
from __future__ import annotations

import numpy as np
import torch

from ..utils import log
from .base import Objective

K_EPSILON = 1e-15


def _positive(y):
    """The binary objective's positive class (a module-level function, so
    an objective pickles)."""
    return y > 0


class BinaryLogloss(Objective):
    """``is_pos`` picks the positive rows from the labels (label > 0;
    one class of a one-vs-all multiclass)."""
    name = "binary"

    def __init__(self, config, is_pos=None):
        super().__init__(config)
        self.sigmoid = float(config.sigmoid)
        if self.sigmoid <= 0.0:
            log.fatal(f"Sigmoid parameter {self.sigmoid} should be greater than zero")
        self.is_unbalance = bool(config.is_unbalance)
        self.scale_pos_weight = float(config.scale_pos_weight)
        if self.is_unbalance and abs(self.scale_pos_weight - 1.0) > 1e-6:
            log.fatal("Cannot set is_unbalance and scale_pos_weight at the same time")
        self._is_pos = is_pos if is_pos is not None else _positive
        self.need_train = True

    def init(self, metadata, num_data, device):
        super().init(metadata, num_data, device)
        pos = self._is_pos(self.label)
        cnt_pos = int(pos.sum())
        cnt_neg = num_data - cnt_pos
        self.need_train = cnt_pos > 0 and cnt_neg > 0
        if not self.need_train:
            log.warning("Contains only one class")
        # -1 for negative, +1 for positive; unbalance reweighting
        # (reference: binary_objective.hpp:90-106)
        w_neg, w_pos = 1.0, 1.0
        if self.is_unbalance and cnt_pos > 0 and cnt_neg > 0:
            if cnt_pos > cnt_neg:
                w_neg = cnt_pos / cnt_neg
            else:
                w_pos = cnt_neg / cnt_pos
        w_pos *= self.scale_pos_weight
        log.info("Number of positive: %d, number of negative: %d", cnt_pos, cnt_neg)
        self._y = torch.as_tensor(
            np.where(pos, 1.0, -1.0).astype(np.float32)).to(self.device)
        self._lw = torch.as_tensor(
            np.where(pos, w_pos, w_neg).astype(np.float32)).to(self.device)

    def get_gradients(self, score):
        response = -self._y * self.sigmoid / (
            1.0 + torch.exp(self._y * self.sigmoid * score))
        abs_resp = torch.abs(response)
        g = response * self._lw
        h = abs_resp * (self.sigmoid - abs_resp) * self._lw
        return self._apply_weight(g, h)

    def boost_from_score(self, class_id: int = 0) -> float:
        pos = self._is_pos(self.label).astype(np.float64)
        if self.weights is not None:
            pavg = float(np.sum(pos * self.weights) / np.sum(self.weights))
        else:
            pavg = float(pos.mean())
        pavg = min(max(pavg, K_EPSILON), 1.0 - K_EPSILON)
        initscore = float(np.log(pavg / (1.0 - pavg)) / self.sigmoid)
        log.info("[binary:BoostFromScore]: pavg=%f -> initscore=%f", pavg, initscore)
        return initscore

    def class_need_train(self, class_id: int) -> bool:
        return self.need_train

    def to_model_string(self) -> str:
        return f"binary sigmoid:{self.sigmoid:g}"

    def convert_output(self, raw):
        return 1.0 / (1.0 + np.exp(-self.sigmoid * np.asarray(raw)))
