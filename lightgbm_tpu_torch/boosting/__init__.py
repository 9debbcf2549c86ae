"""Boosting (counterpart of lightgbm_tpu/boosting/): ``gbdt`` and ``goss``;
DART and RF are not in the port yet (``config.py`` refuses them)."""
from __future__ import annotations

from ..utils import log
from .gbdt import GBDT
from .goss import GOSS


def create_boosting(config) -> GBDT:
    """(reference: src/boosting/boosting.cpp CreateBoosting)."""
    types = {"gbdt": GBDT, "goss": GOSS}
    if config.boosting not in types:
        log.fatal(f"Unknown boosting type {config.boosting}")
    return types[config.boosting]()
