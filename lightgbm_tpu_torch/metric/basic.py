"""Regression, binary, multiclass and cross-entropy metrics (counterpart of
lightgbm_tpu/metric/basic.py; reference:
src/metric/{regression,binary,multiclass,xentropy}_metric.hpp).  Host-side
numpy on the raw scores, converted through the objective where the
reference converts them (``objective->ConvertOutput``)."""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ..utils import log

EvalResult = Tuple[str, float, bool]  # (name, value, higher_is_better)


class Metric:
    name = "metric"
    higher_is_better = False
    # True: ``eval`` takes the score tensor on the training device (the
    # trainer then copies no scores to the host for it)
    accepts_device_score = False

    def __init__(self, config):
        self.config = config
        self.label = None
        self.weights = None
        self.sum_weights = 0.0

    def init(self, metadata, num_data: int, device="cpu") -> None:
        self.label = metadata.label
        self.weights = metadata.weights
        self.sum_weights = (float(np.sum(self.weights))
                            if self.weights is not None else float(num_data))

    def _avg(self, losses: np.ndarray) -> float:
        if self.weights is not None:
            return float(np.sum(losses * self.weights) / self.sum_weights)
        return float(np.mean(losses))

    def eval(self, score: np.ndarray, objective) -> List[EvalResult]:
        raise NotImplementedError


class _Pointwise(Metric):
    """The (weighted) mean of a per-row loss of the converted predictions
    (reference: regression_metric.hpp:21-116 RegressionMetric<T>)."""

    def _loss(self, label, pred):
        raise NotImplementedError

    def eval(self, score, objective) -> List[EvalResult]:
        pred = (np.asarray(objective.convert_output(score))
                if objective is not None else score)
        return [(self.name, self._avg(self._loss(self.label, pred)),
                 self.higher_is_better)]


class L2Metric(_Pointwise):
    name = "l2"

    def _loss(self, label, pred):
        d = label - pred
        return d * d


class RMSEMetric(L2Metric):
    name = "rmse"

    def eval(self, score, objective) -> List[EvalResult]:
        [(_, v, h)] = super().eval(score, objective)
        return [(self.name, float(np.sqrt(v)), h)]


class L1Metric(_Pointwise):
    name = "l1"

    def _loss(self, label, pred):
        return np.abs(label - pred)


class QuantileMetric(_Pointwise):
    name = "quantile"

    def _loss(self, label, pred):
        alpha = float(self.config.alpha)
        d = label - pred
        return np.where(d >= 0, alpha * d, (alpha - 1.0) * d)


class HuberMetric(_Pointwise):
    name = "huber"

    def _loss(self, label, pred):
        alpha = float(self.config.alpha)
        d = np.abs(label - pred)
        return np.where(d <= alpha, 0.5 * d * d, alpha * (d - 0.5 * alpha))


class FairMetric(_Pointwise):
    name = "fair"

    def _loss(self, label, pred):
        c = float(self.config.fair_c)
        x = np.abs(label - pred)
        return c * x - c * c * np.log1p(x / c)


class PoissonMetric(_Pointwise):
    name = "poisson"

    def _loss(self, label, pred):
        p = np.maximum(pred, 1e-10)
        return p - label * np.log(p)


class GammaMetric(_Pointwise):
    """Negative log-likelihood of a unit-shape Gamma (reference:
    regression_metric.hpp:228-250)."""
    name = "gamma"

    def _loss(self, label, pred):
        p = np.maximum(pred, 1e-10)
        return label / p + np.log(p)


class GammaDevianceMetric(_Pointwise):
    name = "gamma_deviance"

    def _loss(self, label, pred):
        eps = 1e-10
        r = label / np.maximum(pred, eps)
        return 2.0 * (-np.log(np.maximum(r, eps)) + r - 1.0)


class TweedieMetric(_Pointwise):
    name = "tweedie"

    def _loss(self, label, pred):
        rho = float(self.config.tweedie_variance_power)
        p = np.maximum(pred, 1e-10)
        a = label * np.power(p, 1.0 - rho) / (1.0 - rho)
        b = np.power(p, 2.0 - rho) / (2.0 - rho)
        return -a + b


class MAPEMetric(_Pointwise):
    name = "mape"

    def _loss(self, label, pred):
        return np.abs((label - pred)) / np.maximum(1.0, np.abs(label))


class BinaryLoglossMetric(_Pointwise):
    """(reference: binary_metric.hpp:115-136)."""
    name = "binary_logloss"

    def _loss(self, label, pred):
        p = np.clip(pred, 1e-15, 1.0 - 1e-15)
        y = (label > 0).astype(np.float64)
        return -(y * np.log(p) + (1.0 - y) * np.log(1.0 - p))


class BinaryErrorMetric(_Pointwise):
    """(reference: binary_metric.hpp:139-156)."""
    name = "binary_error"

    def _loss(self, label, pred):
        y = (label > 0).astype(np.float64)
        return ((pred > 0.5) != (y > 0)).astype(np.float64)


class AUCMetric(Metric):
    """Weighted ROC AUC with tied scores sharing credit (reference:
    binary_metric.hpp:159-225 AUCMetric)."""
    name = "auc"
    higher_is_better = True

    def eval(self, score, objective) -> List[EvalResult]:
        score = np.asarray(score).ravel()
        y = (self.label > 0).astype(np.float64)
        w = self.weights if self.weights is not None else np.ones_like(y)
        order = np.argsort(-score, kind="stable")
        ys, ws, ss = y[order], w[order], score[order]
        pos_w = ys * ws
        neg_w = (1.0 - ys) * ws
        new_block = np.empty(len(ss), dtype=bool)
        new_block[0] = True
        new_block[1:] = ss[1:] != ss[:-1]
        block_id = np.cumsum(new_block) - 1
        n_blocks = block_id[-1] + 1 if len(ss) else 0
        bp = np.bincount(block_id, weights=pos_w, minlength=n_blocks)
        bn = np.bincount(block_id, weights=neg_w, minlength=n_blocks)
        cum_neg_before = np.concatenate([[0.0], np.cumsum(bn)[:-1]])
        area = np.sum(bp * (cum_neg_before + 0.5 * bn))
        total_pos, total_neg = pos_w.sum(), neg_w.sum()
        if total_pos <= 0 or total_neg <= 0:
            log.warning("AUC: data contains only one class")
            return [(self.name, 1.0, True)]
        # with a descending sort, counting negatives ranked above each
        # positive gives 1 - AUC
        return [(self.name, float(1.0 - area / (total_pos * total_neg)),
                 True)]


class MultiLoglossMetric(Metric):
    """(reference: multiclass_metric.hpp:138-160)."""
    name = "multi_logloss"

    def eval(self, score, objective) -> List[EvalResult]:
        prob = np.asarray(objective.convert_output(score))
        lab = self.label.astype(np.int64)
        p = np.clip(prob[np.arange(len(lab)), lab], 1e-15, None)
        return [(self.name, self._avg(-np.log(p)), False)]


class MultiErrorMetric(Metric):
    """Top-k error: a row scores 0 when at most ``multi_error_top_k``
    classes score >= its true class (reference: multiclass_metric.hpp:140-160)."""
    name = "multi_error"

    def __init__(self, config):
        super().__init__(config)
        self.top_k = max(1, int(config.multi_error_top_k))
        if self.top_k > 1:
            self.name = f"multi_error@{self.top_k}"

    def eval(self, score, objective) -> List[EvalResult]:
        score = np.asarray(score)
        lab = self.label.astype(np.int64)
        true_score = score[np.arange(len(lab)), lab][:, None]
        num_ge = (score >= true_score).sum(axis=1)   # the label's included
        return [(self.name, self._avg((num_ge > self.top_k).astype(
            np.float64)), False)]


class AucMuMetric(Metric):
    """Multi-class AUC-mu of Kleiman & Page (reference:
    multiclass_metric.hpp:183-294): the mean of pairwise class-separation
    AUCs along partition-weight difference directions.  Sample weights
    are not read, as in the reference."""
    name = "auc_mu"
    higher_is_better = True
    K_EPS = 1e-15

    def eval(self, score, objective) -> List[EvalResult]:
        score = np.asarray(score)
        K = int(self.config.num_class)
        lab = self.label.astype(np.int64)
        w = self.config.auc_mu_weights
        W = (np.asarray(w, np.float64).reshape(K, K) if w
             else 1.0 - np.eye(K))
        total = 0.0
        for i in range(K):
            idx_i = np.flatnonzero(lab == i)
            for j in range(i + 1, K):
                idx_j = np.flatnonzero(lab == j)
                if len(idx_i) == 0 or len(idx_j) == 0:
                    continue
                v = W[i] - W[j]
                t1 = v[i] - v[j]
                rows = np.concatenate([idx_i, idx_j])
                dist = t1 * (score[rows] @ v)
                is_i = np.concatenate([np.ones(len(idx_i), bool),
                                       np.zeros(len(idx_j), bool)])
                # ascending by distance, class j first on exact ties; the
                # epsilon-chained ties follow in the scan
                order = np.lexsort((is_i, dist))
                d_s, i_s = dist[order], is_i[order]
                s_ij = num_j = last_j_dist = num_cur_j = 0.0
                for k in range(len(d_s)):
                    if i_s[k]:
                        if abs(d_s[k] - last_j_dist) < self.K_EPS:
                            s_ij += num_j - 0.5 * num_cur_j
                        else:
                            s_ij += num_j
                    else:
                        num_j += 1.0
                        if abs(d_s[k] - last_j_dist) < self.K_EPS:
                            num_cur_j += 1.0
                        else:
                            last_j_dist = d_s[k]
                            num_cur_j = 1.0
                total += s_ij / (len(idx_i) * len(idx_j))
        value = 2.0 * total / (K * (K - 1)) if K > 1 else 1.0
        return [(self.name, float(value), True)]


class CrossEntropyMetric(_Pointwise):
    """(reference: xentropy_metric.hpp:71-163)."""
    name = "cross_entropy"

    def _loss(self, label, pred):
        p = np.clip(pred, 1e-15, 1.0 - 1e-15)
        return -(label * np.log(p) + (1.0 - label) * np.log(1.0 - p))


class CrossEntropyLambdaMetric(Metric):
    """(reference: xentropy_metric.hpp:166-246)."""
    name = "cross_entropy_lambda"

    def eval(self, score, objective) -> List[EvalResult]:
        score = np.asarray(score).ravel()
        hhat = np.log1p(np.exp(score))
        w = self.weights if self.weights is not None else 1.0
        z = np.clip(-np.expm1(-w * hhat), 1e-15, 1.0 - 1e-15)
        loss = -(self.label * np.log(z) + (1.0 - self.label) * np.log(1.0 - z))
        return [(self.name, float(np.mean(loss)), False)]


class KLDivMetric(Metric):
    """(reference: xentropy_metric.hpp:249-318)."""
    name = "kullback_leibler"

    def eval(self, score, objective) -> List[EvalResult]:
        score = np.asarray(score).ravel()
        eps = 1e-15
        p = np.clip(1.0 / (1.0 + np.exp(-score)), eps, 1.0 - eps)
        y = np.clip(self.label, eps, 1.0 - eps)
        loss = (y * np.log(y / p) + (1.0 - y) * np.log((1.0 - y) / (1.0 - p)))
        return [(self.name, self._avg(loss), False)]
