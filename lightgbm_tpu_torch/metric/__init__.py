"""Evaluation metrics (counterpart of lightgbm_tpu/metric/__init__.py;
reference: src/metric/metric.cpp:16-63)."""
from __future__ import annotations

from typing import List

from ..utils import log
from .basic import (AUCMetric, AucMuMetric, BinaryErrorMetric,
                    BinaryLoglossMetric, CrossEntropyLambdaMetric,
                    CrossEntropyMetric, FairMetric, GammaDevianceMetric,
                    GammaMetric, HuberMetric, KLDivMetric, L1Metric, L2Metric,
                    MAPEMetric, Metric, MultiErrorMetric, MultiLoglossMetric,
                    PoissonMetric, QuantileMetric, RMSEMetric, TweedieMetric)
from .rank import MapMetric, NDCGMetric

_METRICS = {
    "l2": L2Metric,
    "rmse": RMSEMetric,
    "l1": L1Metric,
    "quantile": QuantileMetric,
    "huber": HuberMetric,
    "fair": FairMetric,
    "poisson": PoissonMetric,
    "gamma": GammaMetric,
    "gamma_deviance": GammaDevianceMetric,
    "tweedie": TweedieMetric,
    "mape": MAPEMetric,
    "binary_logloss": BinaryLoglossMetric,
    "binary_error": BinaryErrorMetric,
    "auc": AUCMetric,
    "multi_logloss": MultiLoglossMetric,
    "multi_error": MultiErrorMetric,
    "auc_mu": AucMuMetric,
    "cross_entropy": CrossEntropyMetric,
    "cross_entropy_lambda": CrossEntropyLambdaMetric,
    "kullback_leibler": KLDivMetric,
    "ndcg": NDCGMetric,
    "map": MapMetric,
}
_ALIASES = {"binary": "binary_logloss"}

# objective -> its default metric (reference package: metric/__init__.py)
_DEFAULT_FOR_OBJECTIVE = {
    "regression": "l2",
    "regression_l1": "l1",
    "huber": "huber",
    "fair": "fair",
    "poisson": "poisson",
    "quantile": "quantile",
    "mape": "mape",
    "gamma": "gamma",
    "tweedie": "tweedie",
    "binary": "binary_logloss",
    "multiclass": "multi_logloss",
    "multiclassova": "multi_error",
    "cross_entropy": "cross_entropy",
    "cross_entropy_lambda": "cross_entropy_lambda",
    "lambdarank": "ndcg",
}


def create_metrics(config) -> List[Metric]:
    """Instances for ``config.metric``, else the objective's default."""
    names = list(config.metric) or [
        _DEFAULT_FOR_OBJECTIVE.get(config.objective, "")]
    out = []
    for n in names:
        n = _ALIASES.get(n, n)
        if n in ("", "none", "null", "na", "custom"):
            continue
        if n not in _METRICS:
            log.fatal(f"Unknown metric type name: {n}")
        out.append(_METRICS[n](config))
    return out
