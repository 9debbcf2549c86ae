"""Objective interface (counterpart of lightgbm_tpu/objective/base.py;
reference: include/LightGBM/objective_function.h:19-91)."""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..utils.log import refuse

# the ROADMAP.md port-queue item that brings training with the objectives
# a loaded model may name
OTHER_OBJECTIVES = ("the rest of queue 1 — multiclass, ranking and the "
                    "other objectives")


class Objective:
    """Base objective: ``get_gradients`` is elementwise torch on the score's
    device, so the trainer computes gradients in the same call as growth."""

    name = "none"
    num_tree_per_iteration = 1

    def __init__(self, config):
        self.config = config
        self.num_data = 0
        self.label: Optional[np.ndarray] = None

    def init(self, metadata, num_data: int, device) -> None:
        """Bind the labels (reference: ObjectiveFunction::Init)."""
        self.num_data = num_data
        self.label = metadata.label

    def get_gradients(self, score) -> Tuple[torch.Tensor, torch.Tensor]:
        raise NotImplementedError

    def boost_from_score(self, class_id: int = 0) -> float:
        return 0.0

    def class_need_train(self, class_id: int) -> bool:
        return True

    def to_model_string(self) -> str:
        """The model text's ``objective=`` value."""
        return self.name

    def convert_output(self, raw: np.ndarray) -> np.ndarray:
        """Raw margin -> user-space prediction."""
        return raw

    def __str__(self) -> str:
        return self.name


class PredictionObjective(Objective):
    """An objective a loaded model names: ``convert_output`` is ported, so
    the model predicts what the JAX package predicts; training with it is
    not in the port yet and raises naming that item."""

    def init(self, metadata, num_data: int, device) -> None:
        refuse(f"training with objective={self.name}", OTHER_OBJECTIVES)

    def get_gradients(self, score):
        refuse(f"gradients of objective={self.name}", OTHER_OBJECTIVES)

    def boost_from_score(self, class_id: int = 0) -> float:
        refuse(f"boost_from_score of objective={self.name}", OTHER_OBJECTIVES)
