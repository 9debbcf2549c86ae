"""Binned dataset (counterpart of lightgbm_tpu/io/dataset.py): dense
matrices and scipy sparse ones (never densified) of numerical and
categorical features.

``X_bin[num_data, num_phys_features]`` holds the bin of every used
(non-trivial) feature, or, where Exclusive Feature Bundling packs sparse
features together (``io/bundling.py``), of every physical column; it is
uint8 while every column has at most 256 bins and uint16 above.  It is
built on the host exactly as the reference package builds it — same row
sample, same bin mappers (categorical ones, ``max_bin_by_feature`` and
forced bins included), same bundles, same bytes, through the native
binning loop where it loads.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence

import numpy as np

from .. import native as _native
from ..config import Config
from ..utils import log
from ..utils.random import Random
from ..utils.timetag import timetag
from .binning import BIN_CATEGORICAL, BIN_NUMERICAL, MISSING_NAN, BinMapper


class Metadata:
    """Labels, sample weights, query boundaries and init scores of the rows
    (reference: Metadata, dataset.h:41-250; reference package:
    io/dataset.py ``Metadata``)."""

    def __init__(self, num_data: int = 0):
        self.num_data = num_data
        self.label: Optional[np.ndarray] = None          # float32 [num_data]
        self.weights: Optional[np.ndarray] = None        # float32 [num_data]
        self.query_boundaries: Optional[np.ndarray] = None  # int32 [Q + 1]
        self.query_weights: Optional[np.ndarray] = None  # float32 [Q]
        self.init_score: Optional[np.ndarray] = None     # float64 [K * N]

    def set_label(self, label) -> None:
        label = np.ascontiguousarray(label, dtype=np.float32).ravel()
        log.check(len(label) == self.num_data, "label length != num_data")
        self.label = label

    def set_weights(self, weights) -> None:
        if weights is None:
            self.weights = None
            return
        weights = np.ascontiguousarray(weights, dtype=np.float32).ravel()
        log.check(len(weights) == self.num_data, "weights length != num_data")
        log.check(bool((weights >= 0).all()), "weights should be non-negative")
        self.weights = weights
        self._update_query_weights()

    def set_query(self, group) -> None:
        """``group`` is per-query sizes (LightGBM convention) or boundaries."""
        if group is None:
            self.query_boundaries = None
            self.query_weights = None
            return
        group = np.ascontiguousarray(group, dtype=np.int64).ravel()
        if group.sum() == self.num_data:  # sizes
            self.query_boundaries = np.concatenate(
                [[0], np.cumsum(group)]).astype(np.int32)
        elif len(group) >= 1 and group[0] == 0 and group[-1] == self.num_data:
            self.query_boundaries = group.astype(np.int32)
        else:
            log.fatal("Initial sizes of queries do not sum to num_data")
        self._update_query_weights()

    def set_init_score(self, init_score) -> None:
        """Starting raw scores, class major ([K * num_data])."""
        if init_score is None:
            self.init_score = None
            return
        init_score = np.ascontiguousarray(init_score,
                                          dtype=np.float64).ravel()
        log.check(len(init_score) % self.num_data == 0,
                  "init_score length must be a multiple of num_data")
        self.init_score = init_score

    def _update_query_weights(self) -> None:
        """A query's weight is the mean weight of its rows."""
        if self.query_boundaries is None or self.weights is None:
            self.query_weights = None
            return
        b = self.query_boundaries
        sums = np.add.reduceat(self.weights, b[:-1])
        cnts = np.diff(b)
        self.query_weights = (sums / np.maximum(cnts, 1)).astype(np.float32)


class BinnedDataset:
    """The constructed training dataset (reference: Dataset, dataset.h:283).

    X_bin: uint8/uint16 [num_data, num_phys_features] (used features
    only, bundled where ``bundle`` is set); bin_mappers: one per ORIGINAL
    column; used_feature_map: original -> inner index (-1 unused);
    real_feature_idx: inner -> original."""

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
        self.max_bin: int = 255
        # EFB bundles (io.bundling.BundleInfo; None = no bundling)
        self.bundle = None

    @property
    def num_features(self) -> int:
        """Used (inner) features, not physical columns: with EFB several
        features share one ``X_bin`` column."""
        return 0 if self.real_feature_idx is None else len(self.real_feature_idx)

    @property
    def num_phys_features(self) -> int:
        """Physical ``X_bin`` columns (``num_features`` unless bundled)."""
        return 0 if self.X_bin is None else self.X_bin.shape[1]

    def phys_max_bins(self) -> np.ndarray:
        """Bins per PHYSICAL column (the histogram kernels' width)."""
        if self.bundle is not None:
            return self.bundle.phys_num_bin
        return self.feature_max_bins()

    def inner_to_mapper(self, inner_feature: int) -> BinMapper:
        return self.bin_mappers[int(self.real_feature_idx[inner_feature])]

    def feature_max_bins(self) -> np.ndarray:
        """num_bin per inner feature, int32 [num_features]."""
        return np.diff(self.bin_offsets).astype(np.int32)

    @classmethod
    def from_matrix(cls, data: np.ndarray, config: Config,
                    categorical_features: Sequence[int] = (),
                    feature_names: Optional[List[str]] = None,
                    reference: Optional["BinnedDataset"] = None
                    ) -> "BinnedDataset":
        """Construct from a dense float matrix: sample rows, find per-feature
        bin bounds (categorical for the columns in
        ``categorical_features``), bundle exclusive sparse features,
        binarize every row (reference: dataset_loader.cpp:574, bin.cpp:325,
        dataset.cpp:265).  With ``reference`` the mappers and bundles are
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
            ds = cls._like(reference, n, p)
            ds._binarize(data)
            return ds

        sample_cnt = min(config.bin_construct_sample_cnt, n)
        sample_indices = (np.arange(n, dtype=np.int64) if sample_cnt >= n
                          else Random(config.data_random_seed).sample(
                              n, sample_cnt).astype(np.int64))
        ds = cls.from_sample(data[sample_indices], n, config,
                             categorical_features, feature_names)
        ds._binarize(data)
        return ds

    @classmethod
    def from_sample(cls, sample, num_data: int, config: Config,
                    categorical_features: Sequence[int] = (),
                    feature_names: Optional[List[str]] = None
                    ) -> "BinnedDataset":
        """Mappers, used features and bundles from a row sample (dense, or
        scipy sparse: only its stored entries are read), ``X_bin`` not yet
        built (reference package: dataset.py ``from_sample``; reference:
        DatasetLoader::ConstructFromSampleData, dataset_loader.cpp:574)."""
        n, p = int(num_data), sample.shape[1]
        sample_csc = sample.tocsc() if hasattr(sample, "tocsc") else None
        ds = cls()
        ds.num_data = n
        ds.num_total_features = p
        ds.metadata = Metadata(n)
        ds.feature_names = (list(feature_names) if feature_names
                            else [f"Column_{i}" for i in range(p)])
        ds.max_bin = config.max_bin
        cat_set = set(int(c) for c in categorical_features)
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
                if sample_csc is not None:
                    # only stored entries can be non-zero
                    lo, hi = sample_csc.indptr[j], sample_csc.indptr[j + 1]
                    col = np.asarray(sample_csc.data[lo:hi], np.float64)
                else:
                    col = sample[:, j]
                # drop "zero" values (|v| <= kZeroThreshold); NaN compares
                # False, so NaNs stay for the missing-type decision
                non_zero = col[~((col > -1e-35) & (col <= 1e-35))]
                mapper = BinMapper()
                mapper.find_bin(non_zero, sample.shape[0],
                                mbf[j] if mbf else config.max_bin,
                                config.min_data_in_bin, filter_cnt,
                                config.use_missing, config.zero_as_missing,
                                forced.get(j),
                                bin_type=(BIN_CATEGORICAL if j in cat_set
                                          else BIN_NUMERICAL))
                ds.bin_mappers.append(mapper)
        ds._finalize_features()
        if (config.enable_bundle and len(ds.real_feature_idx) >= 2
                and config.max_bin <= 255):
            from .bundling import build_bundles
            # wide-sparse datasets get uint16-wide bundle columns so EFB
            # can pack hundreds of features a column (the reference's rule)
            wide = len(ds.real_feature_idx) > 2048
            bundle = build_bundles(ds.bin_mappers, ds.real_feature_idx,
                                   sample if sample_csc is None
                                   else sample_csc, n,
                                   config.max_conflict_rate,
                                   max_bins_per_group=4096 if wide else 256)
            if not bundle.is_trivial:
                ds.bundle = bundle
        from .. import obs
        if obs.enabled():
            obs.event("dataset", num_data=ds.num_data, num_total_features=p,
                      num_used_features=int(len(ds.real_feature_idx)),
                      total_bins=int(ds.bin_offsets[-1]),
                      bundled=ds.bundle is not None,
                      sample_rows=int(sample.shape[0]))
        return ds

    @classmethod
    def from_csr(cls, X, config: Config,
                 categorical_features: Sequence[int] = (),
                 feature_names: Optional[List[str]] = None,
                 reference: Optional["BinnedDataset"] = None
                 ) -> "BinnedDataset":
        """Construct from a scipy sparse matrix without densifying it
        (reference package: dataset.py ``from_csr``): bins from the stored
        entries of the sampled rows, per CSC column; EFB over the sparse
        columns; ``X_bin`` starts at each column's default bin and the
        stored non-default bins are scattered into it.  Peak memory is a
        CSC copy and the binned matrix."""
        import scipy.sparse as sp
        X = X.tocsr() if not sp.isspmatrix_csr(X) else X
        n, p = X.shape
        if n == 0:
            log.fatal("Cannot construct a Dataset from an empty matrix (0 rows)")
        if reference is not None:
            ds = cls._like(reference, n, p)
        else:
            sample_cnt = min(config.bin_construct_sample_cnt, n)
            sample_indices = (np.arange(n, dtype=np.int64) if sample_cnt >= n
                              else Random(config.data_random_seed).sample(
                                  n, sample_cnt).astype(np.int64))
            ds = cls.from_sample(X[sample_indices], n, config,
                                 categorical_features, feature_names)
        with timetag("binarize"):
            ds._binarize_csc(X.tocsc())
        return ds

    @classmethod
    def _like(cls, reference: "BinnedDataset", n: int,
              p: int) -> "BinnedDataset":
        """An empty dataset of n rows in ``reference``'s bin space."""
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
        ds.max_bin = reference.max_bin
        ds.bundle = reference.bundle
        return ds

    def _alloc_X(self, path: Optional[str] = None) -> None:
        """The binned matrix of ``num_data`` rows, to fill by chunks: in
        RAM, or an ``np.memmap`` ``.npy`` file at ``path`` (streaming
        ingestion's ``tpu_ingest_memmap``)."""
        cols, dtype = self._bin_matrix_spec()
        if path:
            self.X_bin = np.lib.format.open_memmap(
                path, mode="w+", dtype=dtype, shape=(self.num_data, cols))
        else:
            self.X_bin = np.zeros((self.num_data, cols), dtype=dtype)

    def _binarize_csc(self, X_csc, row0: Optional[int] = None) -> None:
        """Scatter the stored non-default bins into the physical matrix
        (reference package: dataset.py ``_binarize_csc``): a column alone
        starts at its feature's default bin (the bin of an implicit 0.0), a
        bundle column at physical bin 0 (every member at its default).
        With ``row0`` the rows fill ``X_bin[row0:]`` of an allocated
        matrix (``_alloc_X``)."""
        used = self.real_feature_idx
        groups = (self.bundle.groups if self.bundle is not None
                  else [[i] for i in range(len(used))])
        if row0 is None:
            self._alloc_X()
            row0 = 0
        X = self.X_bin[row0:row0 + X_csc.shape[0]]
        dtype = X.dtype
        indptr, indices, data = X_csc.indptr, X_csc.indices, X_csc.data
        for gp, members in enumerate(groups):
            for inner in members:
                j = int(used[inner])
                m = self.bin_mappers[j]
                lo, hi = indptr[j], indptr[j + 1]
                fb = np.asarray(m.value_to_bin(
                    np.asarray(data[lo:hi], np.float64)))
                if len(members) == 1:
                    if m.default_bin:
                        X[:, gp] = m.default_bin
                    X[indices[lo:hi], gp] = fb.astype(dtype)
                    continue
                nz = fb != m.default_bin
                off = self.bundle.feat_offset[inner]
                X[indices[lo:hi][nz], gp] = (off + fb[nz]).astype(dtype)

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

    def _bin_matrix_spec(self):
        """``(columns, dtype)`` of the physical bin matrix (reference:
        dataset.py ``_bin_matrix_spec``): sized by the actual bin counts,
        since a categorical feature can hold more bins than ``max_bin``."""
        if self.bundle is not None:
            widest = int(max(self.bundle.phys_num_bin.max(initial=0),
                             self.feature_max_bins().max(initial=0)))
            cols = self.bundle.num_phys
        else:
            widest = int(self.feature_max_bins().max(initial=0))
            cols = len(self.real_feature_idx)
        dtype = (np.uint8 if widest <= 256
                 else np.uint16 if widest <= 65536 else np.uint32)
        if dtype != np.uint8 and self.max_bin <= 256:
            log.warning(
                "A feature has %d bins (> 256, from a high-cardinality "
                "categorical); the whole binned matrix is widened to %s",
                widest, np.dtype(dtype).name)
        return cols, dtype

    def _feature_bins(self, data: np.ndarray, inner: int) -> np.ndarray:
        """Bins of inner feature ``inner`` for every row of ``data``."""
        return self.inner_to_mapper(inner).value_to_bin(
            data[:, int(self.real_feature_idx[inner])])

    def _binarize(self, data: np.ndarray, row0: Optional[int] = None) -> None:
        """Bin every row into ``X_bin`` (reference: dataset.py
        ``_binarize_chunk`` / ``_binarize_bundled_chunk``).  With the
        native library each numerical column of a uint8 matrix is binned
        in place, strided, straight into its column of ``X_bin`` (the
        reference copies the columns feature-major first; the bytes are
        the same, without the f64 copy); every other column goes through
        ``value_to_bin``, and a bundle's members through
        ``io/bundling.py encode_column``."""
        from .bundling import encode_column
        used = self.real_feature_idx
        if row0 is None:
            self._alloc_X()
            row0 = 0
        n = len(data)
        X = self.X_bin[row0:row0 + n]
        dtype = X.dtype
        fast = _native.lib() is not None and dtype == np.uint8
        groups = (self.bundle.groups if self.bundle is not None
                  else [[i] for i in range(len(used))])
        with timetag("binarize"):
            for gp, members in enumerate(groups):
                if len(members) > 1:
                    X[:, gp] = encode_column(
                        self.bundle, members,
                        [self._feature_bins(data, i) for i in members],
                        [self.inner_to_mapper(i).default_bin
                         for i in members], n, dtype)
                    continue
                inner = members[0]
                m = self.inner_to_mapper(inner)
                if fast and m.bin_type == BIN_NUMERICAL:
                    ns = m.num_bin - (1 if m.missing_type == MISSING_NAN
                                      else 0)
                    _native.binarize_numerical_u8(
                        data[:, int(used[inner])], m.bin_upper_bound, ns - 1,
                        m.missing_type, m.num_bin, X[:, gp])
                else:
                    X[:, gp] = self._feature_bins(data, inner)


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
