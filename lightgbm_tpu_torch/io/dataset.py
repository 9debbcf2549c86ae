"""Binned dataset (counterpart of lightgbm_tpu/io/dataset.py): dense
numeric matrices only.

``X_bin[num_data, num_features]`` uint8 holds the bin of every used
(non-trivial) feature; it is built on the host exactly as the reference
package builds it — same row sample, same bin mappers (``max_bin_by_feature``
and forced bins included), same bytes, through the native binning loop
where it loads.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional

import numpy as np

from .. import native as _native
from ..config import Config
from ..utils import log
from ..utils.random import Random
from ..utils.timetag import timetag
from .binning import MISSING_NAN, BinMapper

# EFB considers features whose default-bin share reaches this rate
# (lightgbm_tpu/io/bundling.py find_groups sparse_threshold)
_EFB_SPARSE_RATE = 0.8


class Metadata:
    """Labels of the training rows (reference: Metadata, dataset.h:41-250).
    Weights, queries and init scores are not in the port yet."""

    def __init__(self, num_data: int = 0):
        self.num_data = num_data
        self.label: Optional[np.ndarray] = None          # float32 [num_data]

    def set_label(self, label) -> None:
        label = np.ascontiguousarray(label, dtype=np.float32).ravel()
        log.check(len(label) == self.num_data, "label length != num_data")
        self.label = label


class BinnedDataset:
    """The constructed training dataset (reference: Dataset, dataset.h:283).

    X_bin: uint8 [num_data, num_features] (used features only);
    bin_mappers: one per ORIGINAL column; used_feature_map: original ->
    inner index (-1 unused); real_feature_idx: inner -> original."""

    def __init__(self):
        self.num_data: int = 0
        self.num_total_features: int = 0
        self.X_bin: Optional[np.ndarray] = None
        self.bin_mappers: List[BinMapper] = []
        self.used_feature_map: Optional[np.ndarray] = None
        self.real_feature_idx: Optional[np.ndarray] = None
        self.bin_offsets: Optional[np.ndarray] = None
        self.metadata: Metadata = Metadata()
        self.feature_names: List[str] = []

    @property
    def num_features(self) -> int:
        return 0 if self.real_feature_idx is None else len(self.real_feature_idx)

    def inner_to_mapper(self, inner_feature: int) -> BinMapper:
        return self.bin_mappers[int(self.real_feature_idx[inner_feature])]

    def feature_max_bins(self) -> np.ndarray:
        """num_bin per inner feature, int32 [num_features]."""
        return np.diff(self.bin_offsets).astype(np.int32)

    @classmethod
    def from_matrix(cls, data: np.ndarray, config: Config,
                    feature_names: Optional[List[str]] = None,
                    reference: Optional["BinnedDataset"] = None
                    ) -> "BinnedDataset":
        """Construct from a dense float matrix: sample rows, find per-feature
        bin bounds, binarize every row (reference: dataset_loader.cpp:574,
        bin.cpp:325, dataset.cpp:265).  With ``reference`` the mappers are
        shared, so validation data lands in the training bin space."""
        data = np.asarray(data)
        if data.dtype not in (np.float32, np.float64):
            data = data.astype(np.float64)
        if data.ndim != 2:
            log.fatal("data must be a 2-D matrix")
        n, p = data.shape
        if n == 0:
            log.fatal("Cannot construct a Dataset from an empty matrix (0 rows)")
        if reference is not None:
            log.check(p == reference.num_total_features,
                      "validation data has a different number of features")
            ds = cls()
            ds.num_data = n
            ds.num_total_features = p
            ds.metadata = Metadata(n)
            ds.bin_mappers = reference.bin_mappers
            ds.used_feature_map = reference.used_feature_map
            ds.real_feature_idx = reference.real_feature_idx
            ds.bin_offsets = reference.bin_offsets
            ds.feature_names = reference.feature_names
            ds._binarize(data)
            return ds

        sample_cnt = min(config.bin_construct_sample_cnt, n)
        sample_indices = (np.arange(n, dtype=np.int64) if sample_cnt >= n
                          else Random(config.data_random_seed).sample(
                              n, sample_cnt).astype(np.int64))
        sample = data[sample_indices]
        ds = cls()
        ds.num_data = n
        ds.num_total_features = p
        ds.metadata = Metadata(n)
        ds.feature_names = (list(feature_names) if feature_names
                            else [f"Column_{i}" for i in range(p)])
        forced = _load_forced_bins(config.forcedbins_filename, p,
                                   config.max_bin)
        # min-data filter threshold scaled to the bin-finding sample
        # (reference: dataset_loader.cpp:599 filter_cnt)
        filter_cnt = int(config.min_data_in_leaf * sample.shape[0] / n)
        mbf = [int(v) for v in (config.max_bin_by_feature or [])]
        if mbf:
            # reference: dataset_loader.cpp:438-441
            log.check(len(mbf) == p, "max_bin_by_feature should be the "
                      "same size as feature number")
            log.check(min(mbf) > 1,
                      "max_bin_by_feature values should be greater than 1")
        with timetag("bin finding"):
            for j in range(p):
                col = sample[:, j]
                # drop "zero" values (|v| <= kZeroThreshold); NaN compares
                # False, so NaNs stay for the missing-type decision
                non_zero = col[~((col > -1e-35) & (col <= 1e-35))]
                mapper = BinMapper()
                mapper.find_bin(non_zero, sample.shape[0],
                                mbf[j] if mbf else config.max_bin,
                                config.min_data_in_bin, filter_cnt,
                                config.use_missing, config.zero_as_missing,
                                forced.get(j))
                ds.bin_mappers.append(mapper)
        ds._finalize_features()
        if config.enable_bundle:
            ds._refuse_bundling(sample)
        ds._binarize(data)
        return ds

    def _finalize_features(self) -> None:
        used = [j for j, m in enumerate(self.bin_mappers) if not m.is_trivial]
        self.used_feature_map = np.full(self.num_total_features, -1, dtype=np.int32)
        for inner, j in enumerate(used):
            self.used_feature_map[j] = inner
        self.real_feature_idx = np.asarray(used, dtype=np.int32)
        nbins = [self.bin_mappers[j].num_bin for j in used]
        self.bin_offsets = np.concatenate([[0], np.cumsum(nbins)]).astype(np.int32)
        if not used:
            log.warning("There are no meaningful features, as all feature values are constant.")

    def _refuse_bundling(self, sample: np.ndarray) -> None:
        """EFB (lightgbm_tpu/io/bundling.py) may only bundle features whose
        default-bin share in the sample reaches 0.8, and needs two of them.
        Where two such features exist the reference package might bundle,
        so the port refuses rather than train a different tree."""
        sparse = 0
        for j in self.real_feature_idx:
            m = self.bin_mappers[int(j)]
            fb = m.value_to_bin(sample[:, int(j)])
            rate = 1.0 - np.count_nonzero(fb != m.default_bin) / max(len(fb), 1)
            sparse += rate >= _EFB_SPARSE_RATE
        if sparse >= 2:
            log.fatal("this dataset has sparse features that Exclusive "
                      "Feature Bundling may pack, and EFB is not in the "
                      "PyTorch port yet (ROADMAP.md port queue: "
                      "categorical/EFB/mixed width); pass "
                      "enable_bundle=false")

    def _binarize(self, data: np.ndarray) -> None:
        """Bin every row into ``X_bin`` (reference: dataset.py
        ``_binarize_chunk``).  With the native library each used column is
        binned in place, strided, straight into its uint8 column of
        ``X_bin`` (the reference copies the columns feature-major first;
        the bytes are the same, without the f64 copy); otherwise
        ``value_to_bin`` column by column."""
        used = self.real_feature_idx
        X = np.empty((self.num_data, len(used)), dtype=np.uint8)
        fast = _native.lib() is not None
        with timetag("binarize"):
            for inner, j in enumerate(used):
                m = self.bin_mappers[int(j)]
                if fast:
                    ns = m.num_bin - (1 if m.missing_type == MISSING_NAN
                                      else 0)
                    _native.binarize_numerical_u8(
                        data[:, int(j)], m.bin_upper_bound, ns - 1,
                        m.missing_type, m.num_bin, X[:, inner])
                else:
                    X[:, inner] = m.value_to_bin(data[:, int(j)])
        self.X_bin = X


def _load_forced_bins(path: str, num_features: int,
                      max_bin: int) -> Dict[int, List[float]]:
    """Forced bin bounds from JSON: ``[{"feature": i, "bin_upper_bound":
    [...]}]`` (reference: DatasetLoader::GetForcedBins,
    dataset_loader.cpp:1246)."""
    if not path:
        return {}
    with open(path) as fh:
        entries = json.load(fh)
    out: Dict[int, List[float]] = {}
    for e in entries:
        j = int(e["feature"])
        if 0 <= j < num_features:
            out[j] = sorted(float(x) for x in e["bin_upper_bound"])[:max_bin]
    return out
