"""Lambdarank (counterpart of lightgbm_tpu/objective/rank.py): its output
conversion is the identity (lightgbm_tpu/objective/base.py), so a loaded
ranking model predicts its raw scores."""
from __future__ import annotations

from .base import PredictionObjective


class LambdarankNDCG(PredictionObjective):
    name = "lambdarank"
