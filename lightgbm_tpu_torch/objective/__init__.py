"""Objective functions (counterpart of lightgbm_tpu/objective/): the binary
log-loss trains; every objective the JAX package writes into a model
header is built for prediction (its ``convert_output``)."""
from __future__ import annotations

from ..utils import log
from .base import OTHER_OBJECTIVES, Objective
from .binary import BinaryLogloss
from .multiclass import MulticlassOVA, MulticlassSoftmax
from .rank import LambdarankNDCG
from .regression import (RegressionFair, RegressionGamma, RegressionHuber,
                         RegressionL1, RegressionL2, RegressionMAPE,
                         RegressionPoisson, RegressionQuantile,
                         RegressionTweedie)
from .xentropy import CrossEntropy, CrossEntropyLambda

_OBJECTIVES = {
    "regression": RegressionL2,
    "regression_l1": RegressionL1,
    "huber": RegressionHuber,
    "fair": RegressionFair,
    "poisson": RegressionPoisson,
    "quantile": RegressionQuantile,
    "mape": RegressionMAPE,
    "gamma": RegressionGamma,
    "tweedie": RegressionTweedie,
    "binary": BinaryLogloss,
    "multiclass": MulticlassSoftmax,
    "multiclassova": MulticlassOVA,
    "cross_entropy": CrossEntropy,
    "cross_entropy_lambda": CrossEntropyLambda,
    "lambdarank": LambdarankNDCG,
}
# model headers that name no objective: predictions are raw scores
NO_OBJECTIVE = ("none", "null", "custom", "na", "")


def create_objective(config) -> Objective:
    """The training objective (reference: src/objective/
    objective_function.cpp:15-50): binary only in the port."""
    if config.objective != "binary":
        log.fatal(f"objective={config.objective!r} is not in the PyTorch port "
                  f"yet (ROADMAP.md port queue: {OTHER_OBJECTIVES})")
    return BinaryLogloss(config)


def objective_from_model(obj_str: str, num_class: int = 1):
    """The objective a model header's ``objective=`` line names, built for
    prediction (``name key:value ...``, as the JAX package writes it);
    None for a header that names none.  Raises ``LightGBMError`` for a
    name the port does not know."""
    from ..config import Config, parse_objective_alias
    parts = obj_str.split()
    name = parse_objective_alias(parts[0]) if parts else ""
    if name in NO_OBJECTIVE:
        return None
    if name not in _OBJECTIVES:
        log.fatal(f"Unknown objective type name: {parts[0]}")
    params = {"objective": name, "verbosity": log.verbosity()}
    for tok in parts[1:]:
        if ":" in tok:
            k, v = tok.split(":", 1)
            params[k] = v
    n_class = int(params.pop("num_class", num_class))
    cfg = Config.from_params(params)
    # the header's class count; Config refuses num_class > 1 for training
    cfg.num_class = max(n_class, int(num_class))
    return _OBJECTIVES[name](cfg)
