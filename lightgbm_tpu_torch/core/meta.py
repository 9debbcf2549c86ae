"""Per-feature metadata as tensors and the split hyperparameters
(counterpart of lightgbm_tpu/core/meta.py).

Per-leaf histograms are padded dense ``[F, B, 3]`` tensors (feature x
padded bin x (grad, hess, count)); every bin is stored, as in the
reference package.  Under EFB the kernels histogram physical columns of
``B_phys`` padded bins (``padded_phys_width``), which ``feat2phys`` /
``feat_offset`` map back to features (``core/histogram.py
expand_bundled``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..io.binning import BIN_CATEGORICAL


class DeviceMeta(NamedTuple):
    """Per-feature metadata, all shaped [F] on the training device."""
    num_bins: torch.Tensor        # int32 — actual bin count per feature
    default_bins: torch.Tensor    # int32 — bin of value 0.0
    missing_types: torch.Tensor   # int32 — MISSING_{NONE,ZERO,NAN}
    monotone: torch.Tensor        # int32 — -1/0/+1 monotone constraint
    penalties: torch.Tensor       # float32 — per-feature gain penalty
    is_categorical: torch.Tensor  # bool — category-set splits
    feat2phys: torch.Tensor = None    # int32 — physical X_bin column
    feat_offset: torch.Tensor = None  # int32 — bin offset in the column
    needs_fix: torch.Tensor = None    # bool — default-bin mass elided


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
    # categorical split parameters (reference: config.h:378-430)
    max_cat_threshold: int = 32
    cat_l2: float = 10.0
    cat_smooth: float = 10.0
    max_cat_to_onehot: int = 4
    min_data_per_group: int = 100

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
            max_cat_threshold=int(config.max_cat_threshold),
            cat_l2=float(config.cat_l2),
            cat_smooth=float(config.cat_smooth),
            max_cat_to_onehot=int(config.max_cat_to_onehot),
            min_data_per_group=int(config.min_data_per_group),
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
    is_cat = np.zeros(F, dtype=bool)
    for inner in range(F):
        m = dataset.inner_to_mapper(inner)
        default_bins[inner] = m.default_bin
        missing[inner] = m.missing_type
        is_cat[inner] = m.bin_type == BIN_CATEGORICAL
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
    bundle = getattr(dataset, "bundle", None)
    if bundle is not None:
        feat2phys, feat_offset = bundle.feat2phys, bundle.feat_offset
        needs_fix = bundle.needs_fix
    else:
        feat2phys = np.arange(F, dtype=np.int32)
        feat_offset = np.zeros(F, dtype=np.int32)
        needs_fix = np.zeros(F, dtype=bool)
    return dict(num_bins=nbins, default_bins=default_bins,
                missing_types=missing, monotone=monotone, penalties=penalties,
                is_categorical=is_cat, feat2phys=feat2phys,
                feat_offset=feat_offset, needs_fix=needs_fix)


def build_device_meta(dataset, config=None, device="cuda"):
    """(DeviceMeta, B) for a constructed ``BinnedDataset``; ``B`` is the
    padded bin width shared by all features."""
    from ..convert import meta_from_numpy
    fields = meta_arrays(dataset, config)
    B = _padded_bin_width(int(fields["num_bins"].max(initial=1)))
    return meta_from_numpy(fields, device), B


def padded_phys_width(dataset) -> int:
    """Padded bin width of the PHYSICAL columns, what the histogram
    kernels cover (the split width unless bundled)."""
    return _padded_bin_width(int(dataset.phys_max_bins().max(initial=1)))
