"""Gradient Boosting Decision Tree trainer (counterpart of
lightgbm_tpu/boosting/gbdt.py).

Each iteration computes the objective's gradients once from the training
score ([N], or [N, K] for K trees an iteration), or takes custom ones,
refreshes the bagging mask, and for each class grows a tree with the
wave grower (K1 on the card) or the serial grower (K2 on the card;
forced splits, CEGB, by-node sampling, all-wide columns), refits its
leaves for the percentile objectives (a host step), shrinks it, and adds
it to the training and validation scores — all on the training device.
Scores may start from init scores or from an init model's forest.
Bagging masks are drawn on the host from numpy's generator seeded with
``bagging_seed``, as in the reference, so both packages draw the same
rows. The trees are kept as host ``Tree`` objects for prediction and
model text (reference: GBDT::TrainOneIter, gbdt.cpp:368-449);
``PredictorBase`` predicts from them, on the host or through the stacked
forest on the device.
"""
from __future__ import annotations

import copy
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..core.forest import forest_leaf_fn, forest_predict_fn, stack_forest
from ..core.grower import CegbConfig, build_grow_fn
from ..core.meta import (SplitConfig, _padded_bin_width, build_device_meta,
                         padded_phys_width)
from ..core.predict import predict_leaf_bins
from ..core.splitter import bitset_words
from ..core.tree import Tree, tree_depth
from ..core.wave_grower import MixedWidth, build_wave_grow_fn
from ..io.binning import BIN_CATEGORICAL
from ..io.forced_splits import load_forced_splits
from ..utils import log
from ..utils.timetag import sync, timetag

K_EPSILON = 1e-15


def _is_sparse(X) -> bool:
    """A scipy sparse matrix."""
    return hasattr(X, "tocsr") and hasattr(X, "toarray")


class PredictorBase:
    """Prediction surface shared by the trainer (``GBDT``) and boosters
    loaded from model text (``io.model_io.LoadedGBDT``); counterpart of
    lightgbm_tpu/boosting/gbdt.py ``PredictorBase``.  Subclasses provide
    ``models``, ``num_tpi``, ``objective``, ``config``, ``train_ds`` and
    ``device``.

    Inputs of ``_DEVICE_PREDICT_MIN_WORK`` rows x trees or more are binned
    on the host and walked on ``device`` through the stacked forest
    (``core/forest.py``), in the training bin space when a dataset is
    attached and otherwise in a bin space rebuilt from the model's own
    thresholds (``serve/packing.py``); smaller inputs walk the value-space
    trees on the host, as the JAX package routes them.

    A scipy sparse input is never densified: block by block of rows, only
    the columns the window's trees split on are gathered into a dense
    [rows, used columns] matrix, and the trees, their split features
    renumbered to those columns, walk it by the same routing (on the
    device in the bin space rebuilt from their thresholds).  A matrix
    narrower than the model has implicit zero columns, as LibSVM input
    does."""

    # device prediction pays off above this many rows x trees; below it
    # host numpy wins on binning and launch overhead
    _DEVICE_PREDICT_MIN_WORK = 2_000_000
    # cells of one gathered block of sparse rows (128 MB of f64)
    _SPARSE_BLOCK_CELLS = 1 << 24

    def _iter_window(self, num_iteration: Optional[int],
                     start_iteration: int = 0) -> Tuple[int, int]:
        """(start, stop) boosting iterations."""
        n_iters = len(self.models) // self.num_tpi
        stop = n_iters if num_iteration is None or num_iteration <= 0 \
            else min(start_iteration + num_iteration, n_iters)
        return start_iteration, stop

    def _use_device(self, n_rows: int, start: int, stop: int,
                    sparse: bool = False) -> bool:
        """The JAX package's routing: enough work, and a bin space to walk
        in (the training one, a model with a declared feature space, or,
        for sparse input, the columns the window's trees split on)."""
        space = (len(self._sparse_window(start, stop)[0]) > 0 if sparse
                 else self.train_ds is not None or self.num_features > 0)
        return (n_rows * max(stop - start, 0) * self.num_tpi
                >= self._DEVICE_PREDICT_MIN_WORK and stop > start and space)

    def _sparse_window(self, start: int, stop: int):
        """(used, trees) of a window, for sparse input: the sorted columns
        its trees split on, and its trees with their split features
        renumbered to positions in ``used``; cached per window."""
        key = (start, stop, len(self.models))
        if getattr(self, "_sparse_key", None) != key:
            K = self.num_tpi
            trees = self.models[start * K:stop * K]
            used = np.unique(np.concatenate(
                [t.split_feature[:max(t.num_leaves - 1, 0)] for t in trees]
                + [np.zeros(0, np.int64)]).astype(np.int64))
            col_of = np.zeros(1 + max([int(np.max(t.split_feature))
                                       for t in trees
                                       if len(t.split_feature)] + [0]),
                              np.int64)
            col_of[used] = np.arange(len(used))
            renumbered = []
            for t in trees:
                t = copy.copy(t)
                t.split_feature = col_of[t.split_feature]
                renumbered.append(t)
            self._sparse_cache = (used, renumbered)
            self._sparse_key = key
        return self._sparse_cache

    def _sparse_blocks(self, X, used: np.ndarray):
        """Dense [rows, len(used)] f64 blocks of a sparse matrix's columns
        ``used`` (zero past its width), at most ``_SPARSE_BLOCK_CELLS``
        cells each; one empty block for no rows."""
        csr = X.tocsr()
        in_range = used[used < csr.shape[1]]
        rows = max(256, self._SPARSE_BLOCK_CELLS // max(len(used), 1))
        for r0 in range(0, max(csr.shape[0], 1), rows):
            part = csr[r0:r0 + rows]
            block = np.zeros((part.shape[0], len(used)))
            block[:, :len(in_range)] = part[:, in_range].toarray()
            yield block

    def predict_raw(self, X, num_iteration: Optional[int] = None,
                    start_iteration: int = 0,
                    early_stop: Optional[dict] = None) -> np.ndarray:
        """Raw margins [N, K] of a dense or scipy sparse matrix."""
        start, stop = self._iter_window(num_iteration, start_iteration)
        if _is_sparse(X):
            used, trees = self._sparse_window(start, stop)
            dev = self._use_device(X.shape[0], start, stop, sparse=True)
            return np.concatenate([
                self._predict_raw_device(b, start, stop, early_stop,
                                         sparse=True) if dev
                else self._host_raw(b, trees, early_stop)
                for b in self._sparse_blocks(X, used)], axis=0)
        X = np.ascontiguousarray(X, dtype=np.float64)
        if self._use_device(X.shape[0], start, stop):
            return self._predict_raw_device(X, start, stop, early_stop)
        K = self.num_tpi
        return self._host_raw(X, self.models[start * K:stop * K], early_stop)

    def _host_raw(self, X: np.ndarray, trees: List[Tree],
                  early_stop: Optional[dict] = None) -> np.ndarray:
        """The value-space trees (K an iteration, in order) walked on the
        host: raw margins [N, K]."""
        K = self.num_tpi
        out = np.zeros((X.shape[0], K))
        active = None
        if early_stop is not None:
            active = np.ones(X.shape[0], dtype=bool)
        for i in range(len(trees) // K):
            Xa = X if active is None else X[active]
            for k in range(K):
                if active is None:
                    out[:, k] += trees[i * K + k].predict(X)
                else:
                    out[active, k] += trees[i * K + k].predict(Xa)
            if active is not None and \
                    (i + 1) % early_stop["round_period"] == 0:
                if early_stop["kind"] == "binary":
                    margin = 2.0 * np.abs(out[:, 0])
                else:
                    top2 = np.sort(out, axis=1)[:, -2:]
                    margin = top2[:, 1] - top2[:, 0]
                active &= margin < early_stop["margin_threshold"]
                if not active.any():
                    break
        return out

    def _early_stop_spec(self, config) -> Optional[dict]:
        """Margin-based prediction early stop (reference:
        CreatePredictionEarlyStopInstance, prediction_early_stop.cpp:54-88):
        None unless ``pred_early_stop`` is set and the model classifies
        (margins mean nothing for regression)."""
        if config is None or not config.pred_early_stop:
            return None
        if self.num_tpi > 1:
            kind = "multiclass"
        elif self.objective is not None and self.objective.name in (
                "binary", "cross_entropy", "cross_entropy_lambda"):
            kind = "binary"
        else:
            return None
        return {"kind": kind,
                "round_period": int(config.pred_early_stop_freq) or 1,
                "margin_threshold": float(config.pred_early_stop_margin)}

    def predict(self, X, num_iteration=None, raw_score=False,
                start_iteration: int = 0, config=None) -> np.ndarray:
        """Predictions; ``config`` (default ``self.config``) supplies the
        prediction early-stop parameters."""
        if not raw_score and getattr(self, "objective_error", None):
            log.fatal(self.objective_error)
        raw = self.predict_raw(X, num_iteration, start_iteration,
                               early_stop=self._early_stop_spec(
                                   config if config is not None
                                   else self.config))
        if not raw_score and self.objective is not None:
            return np.asarray(self.objective.convert_output(
                raw if self.num_tpi > 1 else raw[:, 0]))
        return raw if self.num_tpi > 1 else raw[:, 0]

    def predict_leaf(self, X, num_iteration=None,
                     start_iteration: int = 0) -> np.ndarray:
        """Leaf index of every row in every tree of the window, [N, T], of
        a dense or scipy sparse matrix."""
        start, stop = self._iter_window(num_iteration, start_iteration)
        if _is_sparse(X):
            used, trees = self._sparse_window(start, stop)
            dev = self._use_device(X.shape[0], start, stop, sparse=True)
            return np.concatenate([
                self._predict_leaf_device(b, start, stop, sparse=True) if dev
                else self._host_leaf(b, trees)
                for b in self._sparse_blocks(X, used)], axis=0)
        X = np.ascontiguousarray(X, dtype=np.float64)
        if self._use_device(X.shape[0], start, stop):
            return self._predict_leaf_device(X, start, stop)
        K = self.num_tpi
        return self._host_leaf(X, self.models[start * K:stop * K])

    @staticmethod
    def _host_leaf(X: np.ndarray, trees: List[Tree]) -> np.ndarray:
        cols = [t.predict_leaf(X) for t in trees]
        return np.stack(cols, axis=1) if cols else np.zeros((X.shape[0], 0))

    # ------------------------------------------------------------------
    # Device prediction: the training bin space when a dataset is
    # attached, else one rebuilt from the model (serve/packing.py).
    # ------------------------------------------------------------------
    def _forest_device(self, start: int, stop: int, sparse: bool = False):
        """(space, meta, forest) of the window, cached per window: the
        model-derived bin space (None for the training one), the meta the
        walk reads, and the stacked forest on ``device``.  ``sparse``: the
        window's renumbered trees in the space of their used columns."""
        key = (start, stop, len(self.models), sparse)
        if getattr(self, "_forest_key", None) != key:
            from ..serve.packing import ServeBinSpace
            K = self.num_tpi
            if sparse:
                used, trees = self._sparse_window(start, stop)
                space = ServeBinSpace(trees, len(used), self.device)
            else:
                trees = self.models[start * K:stop * K]
                space = (None if self.train_ds is not None
                         else ServeBinSpace(trees, self.num_features,
                                            self.device))
            arrays_np = (self._tree_arrays_np if space is None
                         else space.tree_arrays_np)
            forest = stack_forest(
                [arrays_np(t) for t in trees],
                np.asarray([k for _ in range(start, stop) for k in range(K)],
                           np.int32), self.device,
                min_words=(bitset_words(self.B) + 1 if space is None
                           else space.min_words))
            self._forest_cache = (space, self.meta if space is None
                                  else space.meta, forest)
            self._forest_key = key
        return self._forest_cache

    def _device_bins(self, X: np.ndarray, space) -> torch.Tensor:
        with timetag("predict (bin input)"):
            bins = (self._bin_for_predict(X) if space is None
                    else space.bin_matrix(X))
            return torch.from_numpy(bins).to(self.device)

    def _bin_for_predict(self, X: np.ndarray) -> np.ndarray:
        """Bin raw rows with the training mappers, per used feature
        (reference package: gbdt.py ``_bin_for_predict``).  Numerical
        features take the training mappers verbatim; categorical ones the
        strict predict mapping, which sends NaN, negative and unseen
        categories to a sentinel bin one word past the trees' bitsets, so
        they route right.  For an unbundled uint8 dataset without
        categorical features the bytes are those ``X_bin`` would hold;
        otherwise int32 (the walk gathers no uint16)."""
        ds = self.train_ds
        mappers = [ds.inner_to_mapper(i) for i in range(ds.num_features)]
        if ds.bundle is None and ds.X_bin.dtype == np.uint8 and not any(
                m.bin_type == BIN_CATEGORICAL for m in mappers):
            from ..io.dataset import BinnedDataset
            return BinnedDataset.from_matrix(X, self.config,
                                             reference=ds).X_bin
        out = np.empty((X.shape[0], ds.num_features), np.int32)
        sentinel = bitset_words(self.B) * 32
        for inner, m in enumerate(mappers):
            col = X[:, int(ds.real_feature_idx[inner])]
            out[:, inner] = (m.value_to_bin_predict(col, sentinel)
                             if m.bin_type == BIN_CATEGORICAL
                             else m.value_to_bin(col))
        return out

    def _predict_raw_device(self, X: np.ndarray, start: int, stop: int,
                            early_stop: Optional[dict] = None,
                            sparse: bool = False) -> np.ndarray:
        """Walk the whole window on the device at once (the replacement of
        the reference's per-row Predictor, predictor.hpp:28-271)."""
        space, meta, forest = self._forest_device(start, stop, sparse)
        bins = self._device_bins(X, space)
        with timetag("predict (forest scan)"):
            out = sync(forest_predict_fn(meta, self.num_tpi, early_stop)(
                forest, bins))
        return out.cpu().numpy().astype(np.float64)

    def _predict_leaf_device(self, X: np.ndarray, start: int, stop: int,
                             sparse: bool = False) -> np.ndarray:
        """Leaf indices of the whole window, walked on the device."""
        space, meta, forest = self._forest_device(start, stop, sparse)
        bins = self._device_bins(X, space)
        with timetag("predict (leaf scan)"):
            out = sync(forest_leaf_fn(meta)(forest, bins))
        return np.ascontiguousarray(out.cpu().numpy().T)

    # ------------------------------------------------------------------
    @property
    def num_trees(self) -> int:
        return len(self.models)

    def current_iteration(self) -> int:
        return len(self.models) // self.num_tpi

    def feature_importance(self, importance_type: str = "split",
                           start_iteration: int = 0,
                           num_iteration: int = -1) -> np.ndarray:
        """Split counts or gains per original feature (reference:
        GBDT::FeatureImportance, gbdt.cpp:573-600)."""
        n = (self.train_ds.num_total_features if self.train_ds is not None
             else max(self.num_features, 1))
        imp = np.zeros(n)
        K = self.num_tpi
        n_iter = len(self.models) // K
        stop = n_iter if num_iteration <= 0 else min(num_iteration, n_iter)
        for tree in self.models[start_iteration * K:stop * K]:
            nn = max(tree.num_leaves - 1, 0)
            f = tree.split_feature[:nn]
            if importance_type == "split":
                np.add.at(imp, f, 1.0)
            else:
                np.add.at(imp, f, np.maximum(tree.split_gain[:nn], 0.0))
        return imp


class GBDT(PredictorBase):
    """Trainer state: the forest, the scores and the grower."""

    def __init__(self):
        self.models: List[Tree] = []
        self.iter_ = 0
        self.num_tpi = 1          # trees per iteration (num_class for
        self.num_class = 1        # the multiclass objectives)
        self.config = None
        self.objective = None
        self.train_ds = None
        self.metrics = []
        self.valid_names: List[str] = []
        self.valid_metrics: List[list] = []
        self._valid_scores: List[torch.Tensor] = []
        self._valid_bins: List[torch.Tensor] = []
        # what the scores were built from, for replaying them onto a valid
        # set attached later: the (class, constant) pairs added, and each
        # tree's shrunk f32 leaf values as added (None for a constant tree)
        self._constants: List[Tuple[int, float]] = []
        self._leaf_f32: List[Optional[torch.Tensor]] = []
        self.wave_stats: List[Tuple[int, int]] = []  # per grown tree: (K1
        #                                             launches, rows)
        self.iter_seconds: List[float] = []  # host clock per iteration,
        #                                      device work included
        self.renew_seconds: List[float] = []  # host leaf refit per tree

    def init(self, config, train_ds, objective, metrics, device) -> None:
        self.device = torch.device(device)
        self.config = config
        self.train_ds = train_ds
        self.objective = objective
        self.metrics = list(metrics)
        self.shrinkage_rate = float(config.learning_rate)
        self.num_tpi = self.num_class = (
            objective.num_tree_per_iteration if objective is not None
            else max(1, config.num_class))
        N = train_ds.num_data
        if objective is not None:
            objective.init(train_ds.metadata, N, self.device)
        for m in self.metrics:
            m.init(train_ds.metadata, N, self.device)
        self.meta, self.B = build_device_meta(train_ds, config, self.device)
        self.B_phys = padded_phys_width(train_ds)
        self._bundled = train_ds.bundle is not None
        self._has_cat = any(
            train_ds.inner_to_mapper(i).bin_type == BIN_CATEGORICAL
            for i in range(train_ds.num_features))
        self.split_cfg = SplitConfig.from_config(config)
        self._init_grower(config, train_ds)
        self._train_score = self._init_score(train_ds)
        self._has_init_score = train_ds.metadata.init_score is not None
        self._bag_mask = torch.ones(N, dtype=torch.float32, device=self.device)
        self._bag_mask_host = np.ones(N, dtype=bool)
        self._rng = np.random.default_rng(config.bagging_seed)
        self._feat_rng = np.random.default_rng(config.feature_fraction_seed)
        self.class_need_train = [
            objective.class_need_train(k) if objective is not None else True
            for k in range(self.num_tpi)]

    def _init_score(self, ds) -> torch.Tensor:
        """A dataset's starting scores: its init scores (class major [K·N]
        -> [N, K], reference package: gbdt.py:643-646), else zeros."""
        init = ds.metadata.init_score
        if init is None:
            return self._zero_score(ds.num_data)
        K = self.num_tpi
        arr = np.asarray(init, np.float64).reshape(K, ds.num_data).T
        arr = arr[:, 0] if K == 1 else arr
        return torch.as_tensor(np.ascontiguousarray(
            arr.astype(np.float32))).to(self.device)

    def _zero_score(self, n: int) -> torch.Tensor:
        """Raw scores of n rows: [n] for one tree an iteration, else
        [n, K]."""
        shape = (n,) if self.num_tpi == 1 else (n, self.num_tpi)
        return torch.zeros(shape, dtype=torch.float32, device=self.device)

    def _add_to_class(self, score: torch.Tensor, k: int,
                      delta) -> torch.Tensor:
        """``score`` with ``delta`` (a scalar or [n]) added to class k."""
        if score.dim() == 1:
            return score + delta
        score = score.clone()
        score[:, k] += delta
        return score

    def _cegb_config(self, config, train_ds):
        """CEGB penalties per inner feature, or None (reference package:
        gbdt.py ``_init_grower``)."""
        cl = list(config.cegb_penalty_feature_coupled or [])
        ll = list(config.cegb_penalty_feature_lazy or [])
        if not (config.cegb_penalty_split > 0 or cl or ll):
            return None

        def to_inner(lst, name):
            if not lst:
                return None
            if len(lst) != train_ds.num_total_features:
                log.fatal(f"{name} should be the same size as feature "
                          "number.")
            return tuple(float(lst[int(train_ds.real_feature_idx[i])])
                         for i in range(train_ds.num_features))
        return CegbConfig(
            tradeoff=float(config.cegb_tradeoff),
            penalty_split=float(config.cegb_penalty_split),
            coupled=to_inner(cl, "cegb_penalty_feature_coupled"),
            lazy=to_inner(ll, "cegb_penalty_feature_lazy"))

    def _init_grower(self, config, train_ds) -> None:
        """The grower and its device bins (reference package: gbdt.py
        ``_init_grower``).  The wave grower takes the data unless the
        serial grower must: forced splits, lazy CEGB penalties, by-node
        sampling, or every physical column wider than 256 bins (the split
        and coupled CEGB penalties ride the wave).  With both widths the
        wave grower is mixed-width: the narrow columns go to K1 as uint8,
        the wide ones to the side-pass as int32.  Quantized modes with
        bundles or mixed widths fall back to 2xbf16, as in the reference;
        the serial grower sums f32 histograms in every mode, as the
        reference package's XLA grower does."""
        X = train_ds.X_bin
        cegb = self._cegb_config(config, train_ds)
        forced = load_forced_splits(config.forcedsplits_filename, train_ds,
                                    self.split_cfg.num_leaves)
        bf = float(config.feature_fraction_bynode)
        bynode = bf if bf < 1.0 else None
        phys_bins = np.asarray(train_ds.phys_max_bins())
        wide = phys_bins > 256
        narrow_all = X.dtype == np.uint8 and self.B_phys <= 256
        hist_mode = config.hist_mode()
        serial = False
        if not narrow_all and not (~wide).any():
            log.info("every physical column has more than 256 bins: using "
                     "the serial grower")
            serial = True
        if forced is not None:
            log.info("forcedsplits_filename set: using the serial grower "
                     "(the wave grower splits many leaves per pass and "
                     "cannot follow a BFS prescription)")
            serial = True
        if cegb is not None and cegb.lazy is not None:
            log.warning("cegb_penalty_feature_lazy needs per-row state; "
                        "using the serial grower")
            serial = True
        if bynode is not None:
            log.info("feature_fraction_bynode set: using the serial grower "
                     "(per-node masks need the one-split-at-a-time loop)")
            serial = True
        self.uses_wave = not serial
        self._bynode_on = bynode is not None
        self._cegb_state = None
        if cegb is not None:
            coupled0 = np.zeros(train_ds.num_features, np.float32)
            if cegb.coupled is not None:
                coupled0 = cegb.tradeoff * np.asarray(cegb.coupled,
                                                      np.float32)
            rows0 = (torch.ones((train_ds.num_features, train_ds.num_data),
                                dtype=torch.uint8, device=self.device)
                     if cegb.lazy is not None else None)
            self._cegb_state = [torch.as_tensor(coupled0).to(self.device),
                                rows0]
        if serial:
            if hist_mode in ("int16", "int8"):
                log.info("tpu_hist_dtype=%s is a wave-grower mode; the "
                         "serial grower sums f32 histograms", hist_mode)
            self.hist_mode = "highest"
            xbt = X.T
            narrow_idx, wide_idx = np.flatnonzero(~wide), np.flatnonzero(wide)
            self._bins_fm = tuple(
                torch.as_tensor(np.ascontiguousarray(
                    xbt[idx]).astype(dt)).to(self.device) if len(idx)
                else None
                for idx, dt in ((narrow_idx, np.uint8), (wide_idx, np.int32)))
            self._grow = build_grow_fn(
                self.meta, self.split_cfg, self.B, phys_bins,
                B_phys=self.B_phys, bundled=self._bundled, cegb=cegb,
                forced=forced, bynode=bynode)
            return
        mixed = None
        if not narrow_all:
            mixed = MixedWidth(
                narrow_idx=np.flatnonzero(~wide).astype(np.int32),
                wide_idx=np.flatnonzero(wide).astype(np.int32),
                B_narrow=_padded_bin_width(int(phys_bins[~wide].max())))
        self._wave_mixed = mixed
        if (mixed is not None or self._bundled) \
                and hist_mode in ("int16", "int8"):
            log.info("tpu_hist_dtype=%s needs the pure-kernel un-bundled "
                     "wave path; falling back to 2xbf16", hist_mode)
            hist_mode = "2xbf16"
        self.hist_mode = hist_mode
        if mixed is None:
            self._bins_fm = torch.as_tensor(
                np.ascontiguousarray(X.T)).to(self.device)
        else:
            xbt = X.T
            self._bins_fm = (
                torch.as_tensor(np.ascontiguousarray(
                    xbt[mixed.narrow_idx]).astype(np.uint8)).to(self.device),
                torch.as_tensor(np.ascontiguousarray(
                    xbt[mixed.wide_idx]).astype(np.int32)).to(self.device))
        self._grow = build_wave_grow_fn(
            self.meta, self.split_cfg, self.B,
            wave_capacity=int(config.tpu_wave_capacity),
            highest=hist_mode,
            gain_gate=float(config.tpu_wave_gain_gate),
            fused_sibling=bool(config.tpu_fused_sibling),
            quant_seed=int(config.seed), B_phys=self.B_phys,
            bundled=self._bundled, mixed=mixed, cegb=cegb)

    def _device_phys_bins(self, X_bin: np.ndarray) -> torch.Tensor:
        """A binned matrix of this dataset's layout on the device, row
        major: uint8 as it is, wider bins as int32."""
        if X_bin.dtype != np.uint8:
            X_bin = X_bin.astype(np.int32)
        return torch.as_tensor(np.ascontiguousarray(X_bin)).to(self.device)

    def add_valid(self, valid_ds, name: str) -> None:
        """Attach a valid set binned with the training mappers; the trees
        grown so far are replayed onto it in the order training added them,
        so its scores equal those of a set attached before the first
        iteration."""
        ms = []
        for proto in self.metrics:
            m = type(proto)(self.config)
            m.init(valid_ds.metadata, valid_ds.num_data, self.device)
            ms.append(m)
        bins = self._device_phys_bins(valid_ds.X_bin)
        score = self._init_score(valid_ds)
        for k, c in self._constants:
            score = self._add_to_class(score, k, c)
        grown = [i for i, lv in enumerate(self._leaf_f32) if lv is not None]
        if grown:
            forest = stack_forest(
                [self._tree_arrays_np(self.models[i]) for i in grown],
                np.zeros(len(grown), np.int32), self.device)
            leaves = forest_leaf_fn(self.meta, phys=self._bundled)(forest,
                                                                   bins)
            for row, i in enumerate(grown):
                score = self._add_to_class(score, i % self.num_tpi,
                                           self._leaf_f32[i][leaves[row]])
        self.valid_names.append(name)
        self.valid_metrics.append(ms)
        self._valid_scores.append(score)
        self._valid_bins.append(bins)

    @property
    def objective_string(self) -> str:
        return ("custom" if self.objective is None
                else self.objective.to_model_string())

    def _boost_from_average(self, k: int) -> float:
        """Class k's starting score, added in the first iteration
        (reference: gbdt.cpp:344-367)."""
        if self.models or self._has_init_score or self.objective is None:
            return 0.0
        if not (self.config.boost_from_average
                or self.train_ds.num_features == 0):
            if self.objective.name in ("regression_l1", "quantile", "mape"):
                log.warning("Disabling boost_from_average in %s may cause "
                            "the slow convergence", self.objective.name)
            return 0.0
        init = float(self.objective.boost_from_score(k))
        if abs(init) > K_EPSILON:
            self._add_constant(k, init)
            log.info("Start training from score %f", init)
            return init
        return 0.0

    def _add_constant(self, k: int, value: float) -> None:
        self._constants.append((k, value))
        self._train_score = self._add_to_class(self._train_score, k, value)
        self._valid_scores = [self._add_to_class(s, k, value)
                              for s in self._valid_scores]

    def _bagging(self, it: int) -> None:
        """Row-subsample mask refresh every ``bagging_freq`` iterations,
        plain or balanced by class (reference: gbdt.py ``_bagging``,
        gbdt.cpp:160-276)."""
        c = self.config
        N = self.train_ds.num_data
        balanced = c.pos_bagging_fraction < 1.0 or c.neg_bagging_fraction < 1.0
        if c.bagging_freq <= 0 or (c.bagging_fraction >= 1.0
                                   and not balanced):
            return
        if it % c.bagging_freq != 0:
            return
        mask = np.zeros(N, dtype=bool)
        if balanced:
            label = self.train_ds.metadata.label
            if label is None or not np.all((label == 0) | (label == 1)):
                log.fatal("pos/neg_bagging_fraction requires binary (0/1) "
                          "labels")
            for cls, frac in ((1, c.pos_bagging_fraction),
                              (0, c.neg_bagging_fraction)):
                rows = np.flatnonzero(label == cls)
                take = self._rng.permutation(len(rows))[:int(frac * len(rows))]
                mask[rows[take]] = True
        else:
            mask[self._rng.permutation(N)[:int(c.bagging_fraction * N)]] = True
        self._bag_mask_host = mask
        self._bag_mask = torch.as_tensor(mask.astype(np.float32)).to(
            self.device)

    def _sample(self, it: int, g, h):
        """The rows iteration ``it`` grows on: refreshes the sample mask
        and returns (g, h) as the grower takes them (GOSS amplifies
        some)."""
        self._bagging(it)
        return g, h

    def _feature_mask(self):
        F = self.train_ds.num_features
        frac = float(self.config.feature_fraction)
        mask = np.ones(F, dtype=bool)
        if frac < 1.0:
            cnt = max(1, int(round(frac * F)))
            mask[:] = False
            mask[self._feat_rng.permutation(F)[:cnt]] = True
        return torch.as_tensor(mask).to(self.device)

    def train_one_iter(self, gradients=None, hessians=None) -> bool:
        """One boosting iteration; True when training should stop (no
        class has a splittable leaf).  Gradients come once from the score
        at the iteration's start, so class k's tree does not see the trees
        of classes < k (reference package: gbdt.py:1530-1760), or from the
        caller: ``gradients`` / ``hessians`` of K·N values, class major
        (no boost from average then, as in the reference)."""
        t0 = time.perf_counter()
        K = self.num_tpi
        if gradients is None or hessians is None:
            init_scores = [self._boost_from_average(k) for k in range(K)]
            if self.objective is None:
                log.fatal("no objective: pass gradients and hessians "
                          "(fobj)")
            g, h = self.objective.get_gradients(self._train_score)
        else:
            init_scores = [0.0] * K
            g, h = (self._custom_grad(v) for v in (gradients, hessians))
        g, h = self._sample(self.iter_, g, h)
        feature_mask = self._feature_mask()
        first = len(self.models) < K
        grown_any = False
        for k in range(K):
            gk, hk = (g, h) if K == 1 else (g[:, k].contiguous(),
                                            h[:, k].contiguous())
            nl = 1
            if self.class_need_train[k] and self.train_ds.num_features > 0:
                kw = {}
                if self._cegb_state is not None:
                    kw["cegb_state"] = self._cegb_state
                if not self.uses_wave:
                    kw["tree_seed"] = self.iter_ * K + k
                arrs, leaf_id, stats = self._grow(self._bins_fm, gk, hk,
                                                  self._bag_mask, feature_mask,
                                                  **kw)
                nl = int(arrs.num_leaves)
            if nl > 1:
                grown_any = True
                self._add_tree(k, arrs, leaf_id, stats, init_scores[k])
                continue
            # constant tree: its value only in the first iteration
            # (reference: gbdt.cpp:418-436)
            output = 0.0
            if first:
                output = (init_scores[k] if self.class_need_train[k]
                          else float(self.objective.boost_from_score(k)))
                if abs(output) > K_EPSILON:
                    self._add_constant(k, output)
            self.models.append(Tree.constant(output))
            self._leaf_f32.append(None)
        if not grown_any:
            log.warning("Stopped training because there are no more leaves "
                        "that meet the split requirements")
            if not first:
                del self.models[-K:], self._leaf_f32[-K:]
            return True
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.iter_seconds.append(time.perf_counter() - t0)
        self.iter_ += 1
        return False

    def _custom_grad(self, values) -> torch.Tensor:
        """Custom gradients or hessians (K·N, class major) as the grower
        takes them: [N], or [N, K]."""
        K, N = self.num_tpi, self.train_ds.num_data
        arr = np.asarray(values, np.float32).reshape(K, N).T
        arr = arr[:, 0] if K == 1 else arr
        return torch.as_tensor(np.ascontiguousarray(arr)).to(self.device)

    def load_initial_models(self, models: List[Tree]) -> None:
        """Continued training (reference: Boosting::LoadFileToBoosting +
        GBDT::ResetTrainingData, boosting.cpp:35-69; reference package:
        gbdt.py ``load_initial_models``): seed the forest with an existing
        one and add its trees to the training and validation scores in
        order, tree by tree, as f32 leaf values; the leaves come from one
        walk of the stacked forest on the device.  Its trees may have more
        leaves than this run's ``num_leaves``."""
        K = self.num_tpi
        if len(models) % K != 0:
            log.fatal(f"init model has {len(models)} trees, not a multiple "
                      f"of num_tree_per_iteration={K}")
        grown = [i for i, t in enumerate(models) if t.num_leaves > 1]
        if grown:
            forest = stack_forest(
                [self._tree_arrays_np(models[i]) for i in grown],
                np.zeros(len(grown), np.int32), self.device)
            walk = forest_leaf_fn(self.meta, phys=self._bundled)
            # leaves [trees, rows] of the training set, then each valid set
            leaves = [walk(forest, b) for b in [self._device_phys_bins(
                self.train_ds.X_bin)] + self._valid_bins]
        row = {i: r for r, i in enumerate(grown)}
        for i, tree in enumerate(models):
            k = i % K
            lv = torch.as_tensor(tree.leaf_value[:tree.num_leaves].astype(
                np.float32)).to(self.device)
            if tree.num_leaves <= 1:
                self._add_constant(k, float(lv[0]))
                self._leaf_f32.append(None)
                continue
            scores = [self._train_score] + self._valid_scores
            scores = [self._add_to_class(sc, k, lv[lf[row[i]]])
                      for sc, lf in zip(scores, leaves)]
            self._train_score, self._valid_scores = scores[0], scores[1:]
            self._leaf_f32.append(lv)
        self.models.extend(models)
        self.iter_ = len(self.models) // K

    def _add_tree(self, k: int, arrs, leaf_id, stats,
                  init_score: float) -> None:
        """Refit (percentile objectives), shrink and add class k's grown
        tree to the training and validation scores."""
        if self.objective is not None and self.objective.is_renew_tree_output:
            arrs = self._renew_tree_output(arrs, leaf_id, k)
        lr = self.shrinkage_rate
        arrs = arrs._replace(leaf_value=arrs.leaf_value * lr,
                             internal_value=arrs.internal_value * lr)
        self._train_score = self._add_to_class(
            self._train_score, k, arrs.leaf_value[leaf_id.long()])
        tree = Tree.from_device(arrs, self.train_ds, shrinkage=lr)
        depth = tree_depth(tree.left_child, tree.right_child, tree.num_leaves)
        for i, vb in enumerate(self._valid_bins):
            leaf = predict_leaf_bins(arrs, vb, self.meta, depth,
                                     has_cat=self._has_cat,
                                     phys=self._bundled)
            self._valid_scores[i] = self._add_to_class(
                self._valid_scores[i], k, arrs.leaf_value[leaf])
        if abs(init_score) > K_EPSILON:
            tree.leaf_value = tree.leaf_value + init_score
        self.models.append(tree)
        self._leaf_f32.append(arrs.leaf_value)
        self.wave_stats.append(stats)

    def _renew_tree_output(self, arrs, leaf_id, k: int):
        """The percentile leaf refit of the L1-family objectives, on the
        host between growth and shrinkage (reference:
        serial_tree_learner.cpp:855-893; reference package: gbdt.py
        ``_renew_tree_output``): residuals against the score before this
        tree, over each leaf's sampled rows (bagging or GOSS).  Its host
        time is kept in ``renew_seconds``."""
        t0 = time.perf_counter()
        nl = int(arrs.num_leaves)
        score = self._train_score if self.num_tpi == 1 \
            else self._train_score[:, k]
        residual = (self.train_ds.metadata.label.astype(np.float64)
                    - score.cpu().numpy().astype(np.float64))
        new_vals = self.objective.renew_leaf_values(
            residual, leaf_id.cpu().numpy(), nl,
            (self._bag_mask > 0).cpu().numpy())
        lv = arrs.leaf_value.cpu().numpy().copy()
        ok = ~np.isnan(new_vals)
        lv[:nl][ok] = new_vals[ok]
        self.renew_seconds.append(time.perf_counter() - t0)
        return arrs._replace(leaf_value=torch.as_tensor(lv).to(self.device))

    # ------------------------------------------------------------------
    def _tree_bin_space(self, tree: Tree):
        """A value-space host ``Tree`` back in the training bin space
        (reference package: gbdt.py ``_tree_bin_space``): (inner features,
        threshold bins, default-left, bitsets, left, right).  Thresholds go
        through ``value_to_bin`` (the inverse of ``bin_to_value``: bounds
        ascend) and category sets through ``categorical_2_bin``.  A node on
        a feature that is trivial (constant) in this dataset becomes a
        one-way split on inner feature 0: both children are the side the
        constant value takes in value space."""
        nn = max(tree.num_leaves - 1, 0)
        ds = self.train_ds
        inner = ds.used_feature_map[tree.split_feature[:nn]].astype(np.int32)
        thr_bin = np.zeros(nn, np.int32)
        dl = np.array([tree.default_left(i) for i in range(nn)], bool)
        cat_bits = np.zeros((nn, bitset_words(self.B)), np.uint32)
        left = tree.left_child[:nn].astype(np.int32).copy()
        right = tree.right_child[:nn].astype(np.int32).copy()
        for i in range(nn):
            if inner[i] < 0:
                const = ds.bin_mappers[int(tree.split_feature[i])].min_val
                go_left = bool(tree._decide(np.asarray([const]),
                                            np.asarray([i]))[0])
                inner[i] = 0
                left[i] = right[i] = (tree.left_child[i] if go_left
                                      else tree.right_child[i])
                continue
            mapper = ds.inner_to_mapper(int(inner[i]))
            if not tree.is_categorical(i):
                thr_bin[i] = mapper.value_to_bin(float(tree.threshold[i]))
                continue
            ci = int(tree.threshold[i])
            lo, hi = int(tree.cat_boundaries[ci]), \
                int(tree.cat_boundaries[ci + 1])
            for cat, b in mapper.categorical_2_bin.items():
                word = cat // 32
                if cat >= 0 and word < hi - lo and \
                        (int(tree.cat_threshold[lo + word]) >> (cat % 32)) & 1:
                    cat_bits[i, b // 32] |= np.uint32(1 << (b % 32))
        return inner, thr_bin, dl, cat_bits, left, right

    def _tree_arrays_np(self, tree: Tree) -> dict:
        """Bin-space numpy arrays of one host tree, unpadded: the unit
        ``core.forest.stack_forest`` batches."""
        nl = tree.num_leaves
        inner, thr_bin, dl, cat_bits, left, right = self._tree_bin_space(tree)
        return dict(split_feature=inner, threshold_bin=thr_bin,
                    default_left=dl, left_child=left, right_child=right,
                    leaf_value=tree.leaf_value[:nl].astype(np.float32),
                    num_leaves=np.int32(nl), cat_bitset=cat_bits)

    def eval_results(self, include_train: bool = True) -> List[Tuple]:
        """All (data_name, metric_name, value, higher_better) entries
        (reference: GBDT::OutputMetric, gbdt.cpp:513-571).  A metric that
        takes device scores gets the score tensor; the others share one
        host copy of it."""
        sets = ([("training", self.metrics, self._train_score)]
                if include_train else [])
        sets += list(zip(self.valid_names, self.valid_metrics,
                         self._valid_scores))
        out = []
        for ds_name, metrics, score in sets:
            host = None
            for m in metrics:
                if m.accepts_device_score:
                    res = m.eval(score, self.objective)
                else:
                    if host is None:
                        host = score.double().cpu().numpy()
                    res = m.eval(host, self.objective)
                out += [(ds_name, name, value, hib)
                        for name, value, hib in res]
        return out
