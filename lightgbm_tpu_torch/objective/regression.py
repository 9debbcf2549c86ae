"""Regression objectives (counterpart of lightgbm_tpu/objective/regression.py;
reference: src/objective/regression_objective.hpp:78-757): gradients in
torch on the training device, ``boost_from_score`` and the percentile leaf
refits (L1, quantile, MAPE) on the host, as the JAX package does them."""
from __future__ import annotations

import numpy as np
import torch

from ..utils import log
from .base import Objective, percentile


class RegressionL2(Objective):
    """L2 loss (reference: regression_objective.hpp:78-186); ``reg_sqrt``
    trains on sign(y)·sqrt(|y|) and squares the prediction back."""
    name = "regression"

    def __init__(self, config):
        super().__init__(config)
        self.sqrt = bool(getattr(config, "reg_sqrt", False))

    def init(self, metadata, num_data, device):
        super().init(metadata, num_data, device)
        if self.sqrt:
            self.label = np.sign(self.label) * np.sqrt(np.abs(self.label))
            self._to_device()

    def get_gradients(self, score):
        return self._apply_weight(score - self._label_d,
                                  torch.ones_like(score))

    def boost_from_score(self, class_id: int = 0) -> float:
        if self.weights is not None:
            return float(np.sum(self.label * self.weights)
                         / np.sum(self.weights))
        return float(np.mean(self.label))

    def convert_output(self, raw):
        raw = np.asarray(raw)
        if self.sqrt:
            return np.sign(raw) * raw * raw
        return raw


def leaf_rows(leaf_id: np.ndarray, num_leaves: int,
              bag_mask: np.ndarray) -> list:
    """The sampled rows of each leaf, in row order: what the JAX package's
    per-leaf mask ``(leaf_id == leaf) & bag_mask`` selects, from one stable
    sort instead of one pass over all rows a leaf."""
    rows = np.flatnonzero(bag_mask)
    lid = leaf_id[rows]
    order = np.argsort(lid, kind="stable")
    rows = rows[order]
    bounds = np.searchsorted(lid[order], np.arange(num_leaves + 1))
    return [rows[bounds[i]:bounds[i + 1]] for i in range(num_leaves)]


class RegressionL1(RegressionL2):
    """L1 loss with the median leaf refit
    (reference: regression_objective.hpp:189-271)."""
    name = "regression_l1"
    is_renew_tree_output = True

    def get_gradients(self, score):
        return self._apply_weight(torch.sign(score - self._label_d),
                                  torch.ones_like(score))

    def boost_from_score(self, class_id: int = 0) -> float:
        return percentile(self.label.astype(np.float64), self.weights, 0.5)

    def _renew_alpha(self) -> float:
        return 0.5

    def renew_leaf_values(self, residual, leaf_id, num_leaves, bag_mask):
        alpha = self._renew_alpha()
        out = np.full(num_leaves, np.nan)
        for leaf, sel in enumerate(leaf_rows(leaf_id, num_leaves, bag_mask)):
            if len(sel):
                w = self.weights[sel] if self.weights is not None else None
                out[leaf] = percentile(residual[sel].astype(np.float64), w,
                                       alpha)
        return out


class RegressionHuber(RegressionL2):
    """(reference: regression_objective.hpp:275-332)."""
    name = "huber"

    def __init__(self, config):
        super().__init__(config)
        self.alpha = float(config.alpha)
        if self.alpha <= 0.0:
            log.fatal("alpha should be greater than 0")

    def get_gradients(self, score):
        diff = score - self._label_d
        g = torch.where(torch.abs(diff) <= self.alpha, diff,
                        torch.sign(diff) * self.alpha)
        return self._apply_weight(g, torch.ones_like(score))


class RegressionFair(RegressionL2):
    """(reference: regression_objective.hpp:335-378)."""
    name = "fair"

    def __init__(self, config):
        super().__init__(config)
        self.c = float(config.fair_c)

    def get_gradients(self, score):
        x = score - self._label_d
        ax = torch.abs(x) + self.c
        g = self.c * x / ax
        h = self.c * self.c / (ax * ax)
        return self._apply_weight(g, h)


class RegressionPoisson(RegressionL2):
    """log-link Poisson (reference: regression_objective.hpp:381-459)."""
    name = "poisson"

    def __init__(self, config):
        super().__init__(config)
        self.max_delta_step = float(config.poisson_max_delta_step)

    def init(self, metadata, num_data, device):
        super().init(metadata, num_data, device)
        if (self.label < 0).any():
            log.fatal(f"[{self.name}]: at least one target label is negative")

    def get_gradients(self, score):
        g = torch.exp(score) - self._label_d
        h = torch.exp(score + self.max_delta_step)
        return self._apply_weight(g, h)

    def boost_from_score(self, class_id: int = 0) -> float:
        return float(np.log(max(1e-20, RegressionL2.boost_from_score(self))))

    def convert_output(self, raw):
        return np.exp(np.asarray(raw))


class RegressionQuantile(RegressionL2):
    """Pinball loss with the percentile leaf refit
    (reference: regression_objective.hpp:462-557)."""
    name = "quantile"
    is_renew_tree_output = True

    def __init__(self, config):
        super().__init__(config)
        self.alpha = float(config.alpha)
        if not 0.0 < self.alpha < 1.0:
            log.fatal("alpha should be in (0, 1)")

    def get_gradients(self, score):
        delta = score - self._label_d
        g = torch.where(delta >= 0, torch.tensor(1.0 - self.alpha,
                                                 dtype=score.dtype,
                                                 device=score.device),
                        torch.tensor(-self.alpha, dtype=score.dtype,
                                     device=score.device))
        return self._apply_weight(g, torch.ones_like(score))

    def boost_from_score(self, class_id: int = 0) -> float:
        return percentile(self.label.astype(np.float64), self.weights,
                          self.alpha)

    def _renew_alpha(self) -> float:
        return self.alpha

    renew_leaf_values = RegressionL1.renew_leaf_values


class RegressionMAPE(RegressionL1):
    """(reference: regression_objective.hpp:560-655): the gradient's sign
    weighted by 1 / max(1, |label|)."""
    name = "mape"

    def init(self, metadata, num_data, device):
        super().init(metadata, num_data, device)
        if (np.abs(self.label) < 1).mean() > 0.29:
            log.warning("Some label values are < 1 in absolute value. MAPE is "
                        "unstable with such values, so LightGBM rounds them "
                        "to 1.0 when calculating MAPE.")
        w = self.weights if self.weights is not None else 1.0
        self.label_weight = (1.0 / np.maximum(1.0, np.abs(self.label))
                             * w).astype(np.float32)
        self._label_weight_d = torch.as_tensor(self.label_weight).to(
            self.device)

    def get_gradients(self, score):
        g = torch.sign(score - self._label_d) * self._label_weight_d
        h = torch.ones_like(score)
        if self._weights_d is not None:
            h = self._weights_d * h
        return g, h

    def boost_from_score(self, class_id: int = 0) -> float:
        return percentile(self.label.astype(np.float64), self.label_weight,
                          0.5)

    def renew_leaf_values(self, residual, leaf_id, num_leaves, bag_mask):
        out = np.full(num_leaves, np.nan)
        for leaf, sel in enumerate(leaf_rows(leaf_id, num_leaves, bag_mask)):
            if len(sel):
                out[leaf] = percentile(residual[sel].astype(np.float64),
                                       self.label_weight[sel], 0.5)
        return out


class RegressionGamma(RegressionPoisson):
    """(reference: regression_objective.hpp:658-692)."""
    name = "gamma"

    def get_gradients(self, score):
        e = torch.exp(-score)
        g = 1.0 - self._label_d * e
        h = self._label_d * e
        return self._apply_weight(g, h)


class RegressionTweedie(RegressionPoisson):
    """(reference: regression_objective.hpp:695-757)."""
    name = "tweedie"

    def __init__(self, config):
        super().__init__(config)
        self.rho = float(config.tweedie_variance_power)

    def get_gradients(self, score):
        e1 = torch.exp((1.0 - self.rho) * score)
        e2 = torch.exp((2.0 - self.rho) * score)
        g = -self._label_d * e1 + e2
        h = -self._label_d * (1.0 - self.rho) * e1 + (2.0 - self.rho) * e2
        return self._apply_weight(g, h)
