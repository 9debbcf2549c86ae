"""Boosting (counterpart of lightgbm_tpu/boosting/): ``gbdt``, ``goss``,
``dart`` and ``rf`` (alias ``random_forest``)."""
from __future__ import annotations

from ..utils import log
from .dart import DART
from .gbdt import GBDT
from .goss import GOSS
from .rf import RF


def create_boosting(config) -> GBDT:
    """(reference: src/boosting/boosting.cpp CreateBoosting)."""
    types = {"gbdt": GBDT, "gbrt": GBDT, "goss": GOSS, "dart": DART,
             "rf": RF, "random_forest": RF}
    if config.boosting not in types:
        log.fatal(f"Unknown boosting type {config.boosting}")
    return types[config.boosting]()
