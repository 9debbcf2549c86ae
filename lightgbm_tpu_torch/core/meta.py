"""Per-feature metadata as tensors and the split hyperparameters
(counterpart of lightgbm_tpu/core/meta.py).

Per-leaf histograms are padded dense ``[F, B, 3]`` tensors (feature x
padded bin x (grad, hess, count)); every bin is stored, as in the
reference package.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch


class DeviceMeta(NamedTuple):
    """Per-feature metadata, all shaped [F] on the training device."""
    num_bins: torch.Tensor        # int32 — actual bin count per feature
    default_bins: torch.Tensor    # int32 — bin of value 0.0
    missing_types: torch.Tensor   # int32 — MISSING_{NONE,ZERO,NAN}
    monotone: torch.Tensor        # int32 — -1/0/+1 monotone constraint
    penalties: torch.Tensor       # float32 — per-feature gain penalty
    is_categorical: torch.Tensor  # bool — category-set splits (loaded
    #                               models only: the port grows none)


@dataclass(frozen=True)
class SplitConfig:
    """Scalar split hyperparameters (reference: the subset of ``Config``
    read by feature_histogram.hpp:446-506)."""
    lambda_l1: float = 0.0
    lambda_l2: float = 0.0
    min_data_in_leaf: int = 20
    min_sum_hessian_in_leaf: float = 1e-3
    min_gain_to_split: float = 0.0
    max_delta_step: float = 0.0
    num_leaves: int = 31
    max_depth: int = -1

    @classmethod
    def from_config(cls, config) -> "SplitConfig":
        return cls(
            lambda_l1=float(config.lambda_l1),
            lambda_l2=float(config.lambda_l2),
            min_data_in_leaf=int(config.min_data_in_leaf),
            min_sum_hessian_in_leaf=float(config.min_sum_hessian_in_leaf),
            min_gain_to_split=float(config.min_gain_to_split),
            max_delta_step=float(config.max_delta_step),
            num_leaves=int(config.num_leaves),
            max_depth=int(config.max_depth),
        )


def _padded_bin_width(max_num_bin: int) -> int:
    """Pad the per-feature bin axis to the next power of two (min 8)."""
    b = 8
    while b < max_num_bin:
        b *= 2
    return b


def meta_arrays(dataset, config=None) -> dict:
    """The metadata fields of a constructed dataset as numpy arrays."""
    nbins = dataset.feature_max_bins().astype(np.int32)
    F = len(nbins)
    default_bins = np.zeros(F, dtype=np.int32)
    missing = np.zeros(F, dtype=np.int32)
    for inner in range(F):
        m = dataset.inner_to_mapper(inner)
        default_bins[inner] = m.default_bin
        missing[inner] = m.missing_type
    monotone = np.zeros(F, dtype=np.int32)
    penalties = np.ones(F, dtype=np.float32)
    if config is not None:
        mc = list(config.monotone_constraints or [])
        fc = list(config.feature_contri or [])
        for inner in range(F):
            orig = int(dataset.real_feature_idx[inner])
            if orig < len(mc):
                monotone[inner] = int(mc[orig])
            if orig < len(fc):
                penalties[inner] = float(fc[orig])
    return dict(num_bins=nbins, default_bins=default_bins,
                missing_types=missing, monotone=monotone, penalties=penalties,
                is_categorical=np.zeros(F, dtype=bool))


def build_device_meta(dataset, config=None, device="cuda"):
    """(DeviceMeta, B) for a constructed ``BinnedDataset``; ``B`` is the
    padded bin width shared by all features."""
    from ..convert import meta_from_numpy
    fields = meta_arrays(dataset, config)
    B = _padded_bin_width(int(fields["num_bins"].max(initial=1)))
    return meta_from_numpy(fields, device), B
