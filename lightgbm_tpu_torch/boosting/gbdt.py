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
import os
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from .. import obs
from ..convert import to_device
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
    # TreeSHAP is O(leaves x depth^2) Python work a row-tree on the host,
    # so the device pass pays off far below the predict threshold;
    # LGBM_TPU_CONTRIB_MIN_WORK overrides it (0 sends everything there)
    _DEVICE_CONTRIB_MIN_WORK = 50_000

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
        key = (start, stop, len(self.models), sparse,
               getattr(self, "_model_version", 0))
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

    def predict_contrib(self, X, num_iteration: Optional[int] = None,
                        start_iteration: int = 0) -> np.ndarray:
        """SHAP contributions of each row, [n, F+1] (the last column is
        the expected value) or [n, K*(F+1)] for K trees an iteration
        (reference package: gbdt.py ``predict_contrib``).  Inputs of
        ``_DEVICE_CONTRIB_MIN_WORK`` rows x trees x classes or more take
        the batched pass on ``device`` (``explain/``); smaller ones the
        host recursion (``core/shap.py``), its oracle.  A model without
        cover counts raises on either path."""
        X = np.ascontiguousarray(X, dtype=np.float64)
        start, stop = self._iter_window(num_iteration, start_iteration)
        work = X.shape[0] * max(stop - start, 0) * self.num_tpi
        try:
            min_work = int(os.environ.get("LGBM_TPU_CONTRIB_MIN_WORK", "")
                           or self._DEVICE_CONTRIB_MIN_WORK)
        except ValueError:
            min_work = self._DEVICE_CONTRIB_MIN_WORK
        ready = stop > start and (self.train_ds is not None
                                  or self.num_features > 0)
        if work >= min_work and ready:
            return self._predict_contrib_device(X, start, stop)
        from ..core.shap import predict_contrib as host_contrib
        return host_contrib(self, X, num_iteration, start_iteration)

    def _predict_contrib_device(self, X: np.ndarray, start: int,
                                stop: int) -> np.ndarray:
        """The batched TreeSHAP pass over the window, always in the bin
        space rebuilt from the model (``ServeBinSpace``): the contribution
        columns are original feature indices, and the training bin space
        rewrites nodes on features trivial in the dataset, which would
        break the path enumeration (the JAX package's reason too)."""
        from ..explain import forest_shap_fn, stack_explain
        from ..serve.packing import ServeBinSpace
        K = self.num_tpi
        F = (int(self.train_ds.num_total_features)
             if self.train_ds is not None else int(self.num_features))
        key = (start, stop, len(self.models),
               getattr(self, "_model_version", 0))
        if getattr(self, "_contrib_key", None) != key:
            trees = self.models[start * K:stop * K]
            space = ServeBinSpace(trees, F, self.device)
            trees_np = [space.tree_arrays_np(t, with_counts=True)
                        for t in trees]
            class_ids = np.asarray([k for _ in range(start, stop)
                                    for k in range(K)], np.int32)
            # the counts ride only in the path metadata
            forest = stack_forest(trees_np, class_ids, self.device,
                                  min_words=space.min_words)
            explain = stack_explain(trees_np, F, self.device)
            self._contrib_cache = (space, forest, explain,
                                   forest_shap_fn(space.meta, K, F))
            self._contrib_key = key
        space, forest, explain, fn = self._contrib_cache
        with timetag("predict (bin input)"):
            bins = torch.from_numpy(space.bin_matrix(X)).to(self.device)
        with timetag("predict (treeshap)"):
            out = sync(fn(forest, explain, bins)).cpu().numpy()
        out = out.astype(np.float64)
        return (out.reshape(X.shape[0], K * (F + 1)) if K > 1
                else out[:, 0, :])

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
        self._valid_ds: list = []
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
        self.num_init_iteration = 0   # iterations seeded by init_model
        self._train_bins = None       # row-major training bins on device
        self._guard = None            # robust/watchdog.py DeviceGuard
        self._ckpt_hook = None        # engine-installed: checkpoint on a
        #                               fatal device error
        self._boundary = None         # iteration-boundary snapshot
        self.last_refit: Optional[dict] = None  # refit_models' report
        self._ranks = None            # obs/ranks.py RankAggregator
        self._reconciler = None       # obs/ranks.py Reconciler
        self._rank_sizes = None       # query sizes of lambdarank

    def init(self, config, train_ds, objective, metrics, device) -> None:
        self.device = torch.device(device)
        self._init_obs(config)
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
        from ..robust.watchdog import DeviceGuard
        self._guard = DeviceGuard(
            policy=config.tpu_on_device_error,
            retries=config.tpu_device_retries,
            stall_timeout_s=config.tpu_wedge_timeout_s,
            enabled=config.tpu_watchdog, seed=int(config.seed),
            on_fatal=self._device_fatal_hook)
        self._telem_iters = 0
        self._telem_train_s = 0.0
        # aggregation across ranks and the reconciliation with the cost
        # functions (obs/ranks.py): the exchange rides the fingerprint
        # cadence and returns at once in one process
        from ..obs.ranks import RankAggregator, Reconciler
        self._ranks = (RankAggregator(
            factor=float(config.tpu_straggler_factor),
            iters=int(config.tpu_straggler_iters))
            if int(config.tpu_straggler_iters) > 0 else None)
        self._reconciler = Reconciler()
        qb = train_ds.metadata.query_boundaries
        self._rank_sizes = (np.diff(np.asarray(qb, np.int64))
                            if qb is not None and getattr(
                                objective, "name", "") == "lambdarank"
                            else None)
        if obs.profile_enabled():
            obs.memory_snapshot("train_init", buffers=self._census_buffers())
        if obs.enabled():
            obs.event("train_start", num_data=N,
                      num_features=train_ds.num_features,
                      num_class=self.num_tpi,
                      num_leaves=self.split_cfg.num_leaves,
                      tree_learner=config.tree_learner,
                      wave=self.uses_wave,
                      objective=getattr(objective, "name", None))

    def _init_obs(self, config) -> None:
        """The observability planes the parameters ask for (process-wide,
        as in the JAX package): the telemetry sink, profile mode, health
        and trace mode, and the flight ring wherever trace, health or the
        device guard may need a post-mortem."""
        if config.tpu_telemetry:
            obs.enable(config.tpu_telemetry)
        if config.tpu_profile:
            obs.enable_profile()
        if config.tpu_health:
            obs.enable_health(config.tpu_health)
        self._fp_freq = max(int(config.tpu_fingerprint_freq), 0)
        if config.tpu_trace:
            obs.enable_trace()
        from ..robust import faults
        guard_on = bool(config.tpu_watchdog) or faults.armed()
        if ((obs.trace_enabled() or obs.health_enabled() or guard_on)
                and not obs.flight_enabled()):
            obs.enable_flight(obs.flight_len_from_env(config.tpu_flight_len))
        self._train_trace_id = (obs.new_trace_id(f"train-{os.getpid()}")
                                if obs.trace_enabled() else None)

    def _census_buffers(self) -> dict:
        """The trainer's device tensors by name, for the memory census."""
        return {"binned_matrix": self._bins_fm,
                "train_bins": self._train_bins,
                "train_score": self._train_score,
                "bag_mask": self._bag_mask,
                "valid_scores": list(self._valid_scores),
                "valid_bins": list(self._valid_bins)}

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
        tl = config.tree_learner
        self._mesh = None
        self._rank_sharded = False
        if tl != "serial" and bynode is not None:
            log.warning("feature_fraction_bynode is ignored with "
                        "tree_learner=%s (supported on the serial learner "
                        "only)", tl)
            bynode = None
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
        if tl != "serial" and train_ds.num_features > 0:
            self._init_parallel(config, train_ds, tl, serial, narrow_all,
                                forced, cegb, phys_bins, hist_mode)
            return
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
            # the feature-major bins, transposed by torch on the device
            # (numpy's byte transpose of a wide matrix takes seconds)
            self._bins_fm = torch.as_tensor(X).to(self.device).t() \
                .contiguous()
        else:
            xbt = X.T
            self._bins_fm = (
                torch.as_tensor(np.ascontiguousarray(
                    xbt[mixed.narrow_idx]).astype(np.uint8)).to(self.device),
                torch.as_tensor(np.ascontiguousarray(
                    xbt[mixed.wide_idx]).astype(np.int32)).to(self.device))
        # the grower's arguments, kept so that a caller can rebuild it
        # with one changed (the overlap oracle "serial" is a grower
        # argument, as in the JAX package)
        self.wave_kw = dict(
            meta=self.meta, cfg=self.split_cfg, B=self.B,
            wave_capacity=int(config.tpu_wave_capacity),
            highest=hist_mode,
            gain_gate=float(config.tpu_wave_gain_gate),
            fused_sibling=bool(config.tpu_fused_sibling),
            quant_seed=int(config.seed), B_phys=self.B_phys,
            bundled=self._bundled, mixed=mixed, cegb=cegb,
            batched_apply=bool(config.tpu_batched_split_apply),
            overlap="on" if config.tpu_wave_overlap else "off")
        self._grow = build_wave_grow_fn(**self.wave_kw)

    def _init_parallel(self, config, train_ds, tl, serial, narrow_all,
                       forced, cegb, phys_bins, hist_mode) -> None:
        """The learner across ranks (reference: tree_learner.cpp:13-36;
        reference package: gbdt.py ``_init_grower``'s parallel branch):
        ``parallel/mesh.py make_engine_grower`` over the process group's
        world.  Under ``data`` the wave grower takes the data where the
        serial learner would (not mixed width), else the serial grower;
        ``voting`` and ``feature`` grow serially.  Forced splits, CEGB and
        by-node sampling are serial-learner knobs, ignored here as in the
        JAX package.  The bins kept on the device are this rank's block of
        the padded rows (``data``, ``voting``) or all of them
        (``feature``)."""
        from ..parallel.mesh import (NETWORK, build_mesh, engine_pad_bins,
                                     make_engine_grower, row_block)
        if forced is not None:
            log.warning("forcedsplits_filename is ignored with "
                        "tree_learner=%s (supported on the serial learner "
                        "only)", tl)
        if cegb is not None:
            log.warning("cegb_* penalties are ignored with tree_learner=%s "
                        "(supported on the serial learner only)", tl)
        if (config.num_machines > 1
                or int(NETWORK.get("num_machines", 1)) > 1):
            # bring up the group first (reference: Network::Init before the
            # learner, application.cpp:54-66)
            from ..parallel.distributed import init_distributed
            init_distributed(config,
                             machines=NETWORK.get("machines", ""),
                             num_machines=int(NETWORK.get("num_machines",
                                                          1)),
                             local_listen_port=int(NETWORK.get(
                                 "local_listen_port", 12400)),
                             time_out=NETWORK.get("time_out"))
        mesh = build_mesh(config.tpu_mesh_shape, self.device)
        self._mesh = mesh
        if (tl == "data" and mesh.size > 1
                and getattr(self.objective, "supports_query_sharding", False)
                and config.tpu_rank_sharded_grad):
            from ..parallel.rank_shard import enable_query_sharded_grads
            enable_query_sharded_grads(self.objective, mesh)
            self._rank_sharded = True
        X = train_ds.X_bin
        use_wave = tl == "data" and not serial and narrow_all
        wave_kw = None
        if use_wave:
            from ..core.wave_grower import effective_pipeline
            if self._bundled and hist_mode in ("int16", "int8"):
                log.info("tpu_hist_dtype=%s needs the pure-kernel "
                         "un-bundled wave path; falling back to 2xbf16",
                         hist_mode)
                hist_mode = "2xbf16"
            wave_kw = dict(
                wave_capacity=int(config.tpu_wave_capacity),
                highest=hist_mode,
                gain_gate=float(config.tpu_wave_gain_gate),
                fused_sibling=bool(config.tpu_fused_sibling),
                quant_seed=int(config.seed), B_phys=self.B_phys,
                bundled=self._bundled,
                batched_apply=bool(config.tpu_batched_split_apply),
                overlap="on" if config.tpu_wave_overlap else "off")
            _, _, fused = effective_pipeline(
                wave_kw["wave_capacity"], fused_sibling=wave_kw[
                    "fused_sibling"], bundled=self._bundled,
                data_parallel=True)
            self.wave_kw = dict(meta=self.meta, cfg=self.split_cfg, B=self.B,
                                **dict(wave_kw, fused_sibling=fused))
            self.hist_mode = hist_mode
            self._wave_mixed = None
            fm = engine_pad_bins(np.ascontiguousarray(X.T), mesh.size, True)
            lo, hi = row_block(mesh, X.shape[0])
            self._bins_fm = torch.as_tensor(np.ascontiguousarray(
                fm[:, lo:hi])).to(self.device)
        else:
            if hist_mode in ("int16", "int8"):
                log.info("tpu_hist_dtype=%s is a wave-grower mode; the "
                         "serial grower sums f32 histograms", hist_mode)
            self.hist_mode = "highest"
            wide = np.asarray(phys_bins) > 256
            xbt = X.T
            if tl != "feature":
                xbt = engine_pad_bins(np.ascontiguousarray(xbt), mesh.size,
                                      True)
                lo, hi = row_block(mesh, X.shape[0])
                xbt = xbt[:, lo:hi]
            self._bins_fm = tuple(
                torch.as_tensor(np.ascontiguousarray(
                    xbt[idx]).astype(dt)).to(self.device) if len(idx)
                else None
                for idx, dt in ((np.flatnonzero(~wide), np.uint8),
                                (np.flatnonzero(wide), np.int32)))
        self.uses_wave = use_wave
        self._grow = make_engine_grower(
            tl, self.meta, self.split_cfg, self.B, mesh, phys_bins,
            wave_kw=wave_kw, top_k=int(config.top_k), B_phys=self.B_phys,
            bundled=self._bundled)
        log.info("Using %s-parallel tree learner over %d rank(s) (rank %d, "
                 "%s)", tl, mesh.size, mesh.rank,
                 "the wave grower" if use_wave else "the serial grower")

    def _train_bins_dev(self) -> torch.Tensor:
        """The training set's row-major bins on the device, made once."""
        if self._train_bins is None:
            self._train_bins = self._device_phys_bins(self.train_ds.X_bin)
        return self._train_bins

    # rows a block of ``_device_phys_bins``'s upload
    _UPLOAD_ROWS = 1 << 18

    def _device_phys_bins(self, X_bin: np.ndarray) -> torch.Tensor:
        """A binned matrix of this dataset's layout on the device, row
        major: uint8 as it is, wider bins as int32.  Filled in row blocks:
        the host never holds a widened (or, from a read-only memmap, a
        whole) copy of the matrix."""
        n, f = X_bin.shape
        dtype = torch.uint8 if X_bin.dtype == np.uint8 else torch.int32
        out = torch.empty((n, f), dtype=dtype, device=self.device)
        for lo in range(0, n, self._UPLOAD_ROWS):
            blk = np.array(X_bin[lo:lo + self._UPLOAD_ROWS],
                           dtype=np.uint8 if dtype == torch.uint8
                           else np.int32)
            out[lo:lo + len(blk)].copy_(torch.from_numpy(blk))
        return out

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
        self._prepare_replay()
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
        self._valid_ds.append(valid_ds)

    def _prepare_replay(self) -> None:
        """Bring the replay state (``_constants``, ``_leaf_f32``) up to
        date before a late valid set replays it (DART rescales trees)."""

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
        self._bag_mask = to_device(mask.astype(np.float32), self.device)

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
        return to_device(mask, self.device)

    def train_one_iter(self, gradients=None, hessians=None) -> bool:
        """One boosting iteration; True when training should stop (no
        class has a splittable leaf).  Gradients come once from the score
        at the iteration's start, so class k's tree does not see the trees
        of classes < k (reference package: gbdt.py:1530-1760), or from the
        caller: ``gradients`` / ``hessians`` of K·N values, class major
        (no boost from average then, as in the reference).  In trace mode
        the iteration is a ``train/iteration`` span whose phases are its
        children."""
        it_span = (obs.begin_span("train/iteration",
                                  trace_id=self._train_trace_id,
                                  iteration=self.iter_)
                   if obs.trace_enabled() else None)
        try:
            return self._train_one_iter_inner(gradients, hessians, it_span)
        finally:
            obs.end_span(it_span)

    def _train_one_iter_inner(self, gradients, hessians, it_span) -> bool:
        t0 = time.perf_counter()
        K = self.num_tpi
        if self._ckpt_hook is not None and self._guard.active:
            self._snapshot_boundary()
        # the iteration record's inputs (the train board reads the same
        # records); with every plane off this is one boolean check and the
        # loop stays as it was
        telem = obs.enabled() or obs.profile_enabled() or obs.board_active()
        if telem:
            phase0 = obs.phase_snapshot()
            builds0 = obs.compile_count()
            leaves_grown: List[int] = []
            waves_total = kern_rows = None
        health_on = obs.health_enabled()
        if gradients is None or hessians is None:
            init_scores = [self._boost_from_average(k) for k in range(K)]
            if self.objective is None:
                log.fatal("no objective: pass gradients and hessians "
                          "(fobj)")
            with timetag("boosting (grad/hess)"):
                g, h = self._guard.run(
                    lambda: self.objective.get_gradients(self._train_score),
                    point="gradients", iteration=self.iter_)
                sync(h)
            if health_on:
                self.objective.health_tap(g, h, self.iter_)
        else:
            init_scores = [0.0] * K
            g, h = (self._custom_grad(v) for v in (gradients, hessians))
            if health_on:
                obs.check_gradients(g, h, phase="boosting (grad/hess)",
                                    iteration=self.iter_, objective="custom")
        g, h = self._sample(self.iter_, g, h)
        if telem and obs.profile_enabled():
            # the score tensor this iteration replaces must be released
            obs.expect_released("train_score", self._train_score)
        feature_mask = self._feature_mask()
        first = len(self.models) < K
        grown_any = False
        grown = []
        for k in range(K):
            nl = 1
            if self.class_need_train[k] and self.train_ds.num_features > 0:
                with timetag("tree growth"):
                    arrs, leaf_id, stats = self._grow_tree(k, g, h,
                                                           feature_mask)
                    with timetag("wait"):
                        nl = int(arrs.num_leaves)
                if health_on:
                    obs.check_tree(arrs, phase="tree growth",
                                   iteration=self.iter_, class_id=k)
                if telem and stats is not None and stats[0] >= 0:
                    waves_total = (waves_total or 0) + int(stats[0])
                    kern_rows = (kern_rows or 0) + int(stats[1])
            if telem:
                leaves_grown.append(nl)
            if nl > 1:
                grown_any = True
                grown.append(arrs)
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
            if telem:
                obs.event("train_stop", iteration=self.iter_,
                          reason="no_splits")
            obs.end_span(it_span, stopped=True)
            return True
        fp_tick = bool(self._fp_freq) and self.iter_ % self._fp_freq == 0
        if health_on and fp_tick:
            self._health_fingerprint(grown)
        # the iteration's end (the range opens on the CPU too, so a trace
        # counts the same waits on either device)
        with timetag("wait"):
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        if telem:
            self._emit_iteration_record(t0, phase0, builds0, leaves_grown,
                                        waves_total, kern_rows)
            if self._ranks is not None and fp_tick:
                # the ranks' phase walls, exchanged on the fingerprint
                # cadence: rank 0 names a straggler
                self._ranks.exchange(self.iter_)
        self.iter_seconds.append(time.perf_counter() - t0)
        self.iter_ += 1
        return False

    def _health_fingerprint(self, trees) -> None:
        """The model-state fingerprint of this iteration (the scores and
        the trees it grew), and the cross-rank audit of it."""
        rec = obs.model_fingerprint(self._train_score, trees,
                                    iteration=self.iter_)
        if rec is not None:
            obs.divergence_audit(rec["stats"], iteration=self.iter_)

    def _emit_iteration_record(self, t_iter0, phase0, builds0, leaves,
                               waves, kern_rows) -> None:
        """One ``iteration`` event (the JAX package's fields): phase
        times, metrics, counters, the kernel builds of the iteration (in
        ``recompiles``), K1's waves and rows; profile mode adds a memory
        census and the release audit."""
        obs.sync(self._train_score)
        iter_s = time.perf_counter() - t_iter0
        self._telem_iters += 1
        self._telem_train_s += iter_s
        metrics = {f"{ds_name}.{mname}": float(value)
                   for ds_name, mname, value, _ in self.eval_results()}
        N = self.train_ds.num_data
        splits = sum(max(int(nl) - 1, 0) for nl in leaves)
        part_batched = bool(self.uses_wave
                            and self.config.tpu_batched_split_apply)
        part_passes = ((int(waves) if waves else None) if part_batched
                       else splits)
        wave_fields = {}
        if self.uses_wave:
            wave_fields = dict(
                hist_mode=self.hist_mode,
                wave_capacity=int(self.config.tpu_wave_capacity),
                fused_sibling=bool(self.wave_kw["fused_sibling"]),
                overlap=self.wave_kw["overlap"] != "off")
        phase_s = obs.phase_delta(phase0)
        recompiles = int(obs.compile_count() - builds0)
        obs.event(
            "iteration", iteration=self.iter_, num_class=self.num_tpi,
            leaves=leaves, waves=waves, kernel_rows=kern_rows,
            iter_s=round(iter_s, 6), phase_s=phase_s,
            metrics=metrics, counters=obs.counters_snapshot(),
            recompiles=recompiles,
            partition_passes=part_passes, partition_batched=part_batched,
            fused_grad=False, grad_hbm_bytes_saved=0,
            cum_row_iters_per_s=round(
                N * self._telem_iters / max(self._telem_train_s, 1e-9), 1),
            **wave_fields)
        if self._ranks is not None:
            self._ranks.accumulate(phase_s)
        if recompiles == 0 and self._reconciler is not None:
            # the phase walls against the cost functions; an iteration
            # that built the kernels would read the build as work
            F, B = int(self.train_ds.X_bin.shape[1]), int(self.B)
            wave_args = chan_args = None
            if self.uses_wave:
                wave_args = (F, B, bool(self.wave_kw.get("packed", True)),
                             bool(self.wave_kw["fused_sibling"]),
                             self.hist_mode in ("int16", "int8"))
            else:
                chan_args = (F, B, 32)
            units = self._reconciler.score(
                phase_s=phase_s, iter_s=iter_s, N=N, kern_rows=kern_rows,
                waves=waves, wave_cost_args=wave_args,
                channels_cost_args=chan_args,
                k2_launches=0 if self.uses_wave else int(waves or 0),
                splits=splits if self.uses_wave else 0,
                part_batched=part_batched, rank_sizes=self._rank_sizes)
            if units:
                obs.event("reconciliation", iteration=self.iter_,
                          units=units)
        if obs.profile_enabled():
            obs.memory_snapshot(f"iteration_{self.iter_}",
                                buffers=self._census_buffers())
            obs.memory_audit(f"iteration_{self.iter_}")

    def _grow_tree(self, k: int, g, h, feature_mask):
        """Class k's tree from the grower, a guarded device step: (tree
        arrays, leaf ids, stats)."""
        K = self.num_tpi
        gk, hk = (g, h) if K == 1 else (g[:, k].contiguous(),
                                        h[:, k].contiguous())
        kw = {}
        if self._cegb_state is not None:
            kw["cegb_state"] = self._cegb_state
        if not self.uses_wave:
            kw["tree_seed"] = self.iter_ * K + k
        return self._guard.run(
            lambda: self._grow(self._bins_fm, gk, hk, self._bag_mask,
                               feature_mask, **kw),
            point="device_execute", iteration=self.iter_)

    def _custom_grad(self, values) -> torch.Tensor:
        """Custom gradients or hessians (K·N, class major) as the grower
        takes them: [N], or [N, K]."""
        K, N = self.num_tpi, self.train_ds.num_data
        arr = np.asarray(values, np.float32).reshape(K, N).T
        arr = arr[:, 0] if K == 1 else arr
        return to_device(np.ascontiguousarray(arr), self.device)

    def load_initial_models(self, models: List[Tree],
                            replay_scores: bool = True) -> None:
        """Continued training (reference: Boosting::LoadFileToBoosting +
        GBDT::ResetTrainingData, boosting.cpp:35-69; reference package:
        gbdt.py ``load_initial_models``): seed the forest with an existing
        one and add its trees to the training and validation scores in
        order, tree by tree, as f32 leaf values; the leaves come from one
        walk of the stacked forest on the device.  Its trees may have more
        leaves than this run's ``num_leaves``.  ``replay_scores=False``
        leaves the scores alone, for a checkpoint's resume, which
        restores them verbatim."""
        K = self.num_tpi
        if len(models) % K != 0:
            log.fatal(f"init model has {len(models)} trees, not a multiple "
                      f"of num_tree_per_iteration={K}")
        grown = [i for i, t in enumerate(models) if t.num_leaves > 1]
        if grown and replay_scores:
            forest = stack_forest(
                [self._tree_arrays_np(models[i]) for i in grown],
                np.zeros(len(grown), np.int32), self.device)
            walk = forest_leaf_fn(self.meta, phys=self._bundled)
            # leaves [trees, rows] of the training set, then each valid set
            leaves = [walk(forest, b)
                      for b in [self._train_bins_dev()] + self._valid_bins]
        row = {i: r for r, i in enumerate(grown)}
        for i, tree in enumerate(models):
            k = i % K
            lv = torch.as_tensor(tree.leaf_value[:tree.num_leaves].astype(
                np.float32)).to(self.device)
            if tree.num_leaves <= 1:
                if replay_scores:
                    self._add_constant(k, float(lv[0]))
                elif float(lv[0]) != 0.0:
                    self._constants.append((k, float(lv[0])))
                self._leaf_f32.append(None)
                continue
            if not replay_scores:
                self._leaf_f32.append(lv)
                continue
            scores = [self._train_score] + self._valid_scores
            scores = [self._add_to_class(sc, k, lv[lf[row[i]]])
                      for sc, lf in zip(scores, leaves)]
            self._train_score, self._valid_scores = scores[0], scores[1:]
            self._leaf_f32.append(lv)
        self.models.extend(models)
        self.iter_ = len(self.models) // K
        self.num_init_iteration = self.iter_

    def refit_models(self, decay_rate: Optional[float] = None) -> None:
        """Refit the loaded tree structures to this trainer's (new) data:
        each leaf's output is recomputed from fresh gradients and mixed
        with the old one, ``decay * old + (1 - decay) * new * shrinkage``
        (reference: GBDT::RefitTree gbdt.cpp:298-321 and
        SerialTreeLearner::FitByExistingTree serial_tree_learner.cpp:
        239-264; reference package: gbdt.py ``refit_models``).  Call
        ``load_initial_models(..., replay_scores=False)`` first: the
        scores are rebuilt from zero.

        The default path is the device refit (``online/refit.py``): one
        stacked walk for every tree's leaf ids, then one step an
        iteration on the training device.  ``tpu_refit_device=false``
        runs the host loop instead, the oracle the device refit is held
        against.  Both emit a ``refit``
        event; the device path's report (with its CUDA-event times on
        the card) is kept in ``last_refit``."""
        decay = float(self.config.refit_decay_rate if decay_rate is None
                      else decay_rate)
        t0 = time.perf_counter()
        if self.config.tpu_refit_device:
            from ..online.refit import device_refit_models
            report = device_refit_models(self, decay)
            mode = "device"
        else:
            self._refit_models_host(decay)
            report = {}
            mode = "host"
        self._refresh_replay_state()
        wall = time.perf_counter() - t0
        self.last_refit = dict(report, mode=mode, wall_s=wall)
        if obs.enabled():
            obs.event("refit", trees=len(self.models),
                      rows=int(self.train_ds.num_data), decay=decay,
                      wall_s=round(wall, 4), mode=mode,
                      iterations=len(self.models) // max(self.num_tpi, 1))

    def _refit_models_host(self, decay: float) -> None:
        """The host refit loop, the device refit's oracle (reference
        package: gbdt.py ``_refit_models_host``): gradients once an
        iteration, before any of its K trees (the reference calls
        Boosting() once an iteration, gbdt.cpp:303); each tree's leaf ids
        from its own walk on the training device; per-leaf f64 sums by
        ``np.bincount``; the closed form with L1, L2 and
        ``max_delta_step`` and the decay mix in f64; the score updated
        with the f32 leaf values."""
        K = self.num_tpi
        cfg = self.split_cfg
        trees = list(self.models)
        bins = self._train_bins_dev()
        walk = forest_leaf_fn(self.meta, phys=self._bundled)
        self._train_score = self._zero_score(self.train_ds.num_data)
        for it in range(len(trees) // K):
            g, h = self.objective.get_gradients(self._train_score)
            for k in range(K):
                tree = trees[it * K + k]
                nl = tree.num_leaves
                gk, hk = (g, h) if K == 1 else (g[:, k], h[:, k])
                forest = stack_forest([self._tree_arrays_np(tree)],
                                      np.zeros(1, np.int32), self.device)
                leaf = walk(forest, bins)[0]
                leaf_np = leaf.cpu().numpy()
                sum_g, sum_h = (np.bincount(leaf_np,
                                            weights=v.double().cpu().numpy(),
                                            minlength=nl)[:nl]
                                for v in (gk, hk))
                sum_h = sum_h + K_EPSILON
                sg = np.sign(sum_g) * np.maximum(
                    np.abs(sum_g) - cfg.lambda_l1, 0.0)
                out = -sg / (sum_h + cfg.lambda_l2)
                if cfg.max_delta_step > 0:
                    out = np.clip(out, -cfg.max_delta_step,
                                  cfg.max_delta_step)
                new_lv = (decay * tree.leaf_value[:nl]
                          + (1.0 - decay) * out * tree.shrinkage)
                tree.leaf_value = new_lv.astype(np.float64)
                lv = torch.as_tensor(new_lv.astype(np.float32)).to(
                    self.device)
                self._train_score = self._add_to_class(self._train_score, k,
                                                       lv[leaf])

    def _refresh_replay_state(self) -> None:
        """After a refit: the per-tree f32 leaf values and the constants
        that replay the scores onto a valid set attached later."""
        K = self.num_tpi
        self._constants, self._leaf_f32 = [], []
        for i, tree in enumerate(self.models):
            lv = tree.leaf_value[:tree.num_leaves].astype(np.float32)
            if tree.num_leaves <= 1:
                if float(lv[0]) != 0.0:
                    self._constants.append((i % K, float(lv[0])))
                self._leaf_f32.append(None)
            else:
                self._leaf_f32.append(torch.as_tensor(lv).to(self.device))

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
        with timetag("valid score update"):
            self._add_to_valid(arrs, tree, k)
        if abs(init_score) > K_EPSILON:
            tree.leaf_value = tree.leaf_value + init_score
        self.models.append(tree)
        self._leaf_f32.append(arrs.leaf_value)
        self.wave_stats.append(stats)

    def _add_to_valid(self, arrs, tree: Tree, k: int) -> None:
        """Add a grown tree's leaf values (``arrs``, on the device) to
        class k of every valid set's scores."""
        depth = tree_depth(tree.left_child, tree.right_child, tree.num_leaves)
        for i, vb in enumerate(self._valid_bins):
            leaf = predict_leaf_bins(arrs, vb, self.meta, depth,
                                     has_cat=self._has_cat,
                                     phys=self._bundled)
            self._valid_scores[i] = self._add_to_class(
                self._valid_scores[i], k, arrs.leaf_value[leaf])

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

    def rollback_one_iter(self) -> None:
        """Take the last iteration's trees off the forest and their shrunk
        f32 leaf values off the training and validation scores (reference:
        GBDT::RollbackOneIter, gbdt.cpp:451-467); rolling back the first
        iteration also takes off its boost-from-average constants."""
        K = self.num_tpi
        if self.iter_ <= 0 or len(self.models) < K:
            return
        first = len(self.models) - K
        grown = [i for i in range(first, len(self.models))
                 if self._leaf_f32[i] is not None]
        if grown:
            forest = stack_forest(
                [self._tree_arrays_np(self.models[i]) for i in grown],
                np.zeros(len(grown), np.int32), self.device)
            walk = forest_leaf_fn(self.meta, phys=self._bundled)
            scores = [self._train_score] + self._valid_scores
            bins = [self._train_bins_dev()] + self._valid_bins
            for j, (sc, b) in enumerate(zip(scores, bins)):
                leaves = walk(forest, b)
                for row, i in enumerate(grown):
                    sc = self._add_to_class(
                        sc, i % K, -self._leaf_f32[i][leaves[row]])
                scores[j] = sc
            self._train_score, self._valid_scores = scores[0], scores[1:]
        if first == 0:
            for k, c in list(self._constants):
                self._add_constant(k, -c)
            self._constants.clear()
        del self.models[first:], self._leaf_f32[first:]
        self.iter_ -= 1

    def quality_profile(self):
        """The drift plane's reference distribution (``obs/drift.py``;
        reference package: gbdt.py ``quality_profile``): each feature's
        bin occupancy, counted on the device, the training raw-score
        histogram and the training AUC.  None without training data."""
        ds = self.train_ds
        if ds is None or ds.X_bin is None:
            return None
        from ..obs.drift import QualityProfile, device_occupancy
        raw = self._train_score.double().cpu().numpy()
        return QualityProfile.from_training(
            ds, raw_score=raw, label=ds.metadata.label,
            occupancy=device_occupancy(ds, self._train_bins_dev()))

    # ------------------------------------------------------------------
    # Fault tolerance (robust/checkpoint.py, robust/watchdog.py)
    # ------------------------------------------------------------------
    # DART changes host trees in place before an iteration's growth, so a
    # half-applied iteration cannot be rolled back
    _boundary_rollback = True

    def checkpoint_state(self):
        """(meta, arrays) for a checkpoint: what a bit-exact resume needs
        besides the forest (the model text).  The f32 scores are copied
        verbatim (a replay would round in another order); the RNG states
        make the next bagging and feature-fraction draws the
        uninterrupted run's; CEGB's coupled (and lazy) penalty state
        carries across trees."""
        meta = {
            "boosting": type(self).__name__.lower(),
            "iteration": int(self.iter_),
            "shrinkage_rate": float(self.shrinkage_rate),
            "num_init_iteration": int(self.num_init_iteration),
            "rng_state": self._rng.bit_generator.state,
            "feat_rng_state": self._feat_rng.bit_generator.state,
        }
        arrays = {"train_score": self._train_score.cpu().numpy(),
                  "bag_mask": np.asarray(self._bag_mask_host, np.bool_)}
        for i, vs in enumerate(self._valid_scores):
            arrays[f"valid_score_{i}"] = vs.cpu().numpy()
        for i, t in enumerate(self._cegb_state or []):
            if t is not None:
                arrays[f"cegb_state_{i}"] = t.cpu().numpy()
        return meta, arrays

    def restore_checkpoint_state(self, meta: dict, arrays: dict) -> None:
        """Inverse of :meth:`checkpoint_state`, after
        ``load_initial_models(..., replay_scores=False)`` and after every
        valid set is attached."""
        want, have = meta.get("boosting", "gbdt"), type(self).__name__.lower()
        if want != have:
            log.warning("checkpoint was written by boosting=%s but this "
                        "trainer is %s; resuming anyway", want, have)
        self.iter_ = int(meta["iteration"])
        self.shrinkage_rate = float(meta["shrinkage_rate"])
        self.num_init_iteration = int(meta.get("num_init_iteration", 0))
        self._rng.bit_generator.state = meta["rng_state"]
        self._feat_rng.bit_generator.state = meta["feat_rng_state"]
        self._train_score = torch.as_tensor(arrays["train_score"]).to(
            self.device)
        mask = np.asarray(arrays["bag_mask"], dtype=bool)
        self._bag_mask_host = mask
        self._bag_mask = torch.as_tensor(mask.astype(np.float32)).to(
            self.device)
        for i in range(len(self._valid_scores)):
            if f"valid_score_{i}" in arrays:
                self._valid_scores[i] = torch.as_tensor(
                    arrays[f"valid_score_{i}"]).to(self.device)
        for i in range(len(self._cegb_state or [])):
            if f"cegb_state_{i}" in arrays:
                self._cegb_state[i] = torch.as_tensor(
                    arrays[f"cegb_state_{i}"]).to(self.device)

    def _snapshot_boundary(self) -> None:
        """The iteration-boundary state, so that a fatal error mid-
        iteration checkpoints a consistent boundary, not a half-applied
        iteration.  Scores and masks are replaced, never written in
        place, so references suffice; CEGB's state is written in place
        and is cloned."""
        self._boundary = {
            "iter": self.iter_,
            "n_models": len(self.models),
            "n_constants": len(self._constants),
            "shrinkage": self.shrinkage_rate,
            "rng": self._rng.bit_generator.state,
            "feat_rng": self._feat_rng.bit_generator.state,
            "bag_mask": self._bag_mask,
            "bag_mask_host": self._bag_mask_host,
            "train_score": self._train_score,
            "valid_scores": list(self._valid_scores),
            "cegb": [None if t is None else t.clone()
                     for t in self._cegb_state or []],
        }

    def _rollback_to_boundary(self) -> bool:
        """Restore the last boundary snapshot; False when there is none or
        the booster cannot roll back (DART)."""
        b = self._boundary
        if b is None or not self._boundary_rollback:
            return False
        self.iter_ = b["iter"]
        self.shrinkage_rate = b["shrinkage"]
        self._rng.bit_generator.state = b["rng"]
        self._feat_rng.bit_generator.state = b["feat_rng"]
        self._bag_mask = b["bag_mask"]
        self._bag_mask_host = b["bag_mask_host"]
        self._train_score = b["train_score"]
        self._valid_scores = list(b["valid_scores"])
        if self._cegb_state is not None:
            self._cegb_state[:] = b["cegb"]
        del self.models[b["n_models"]:], self._leaf_f32[b["n_models"]:]
        del self._constants[b["n_constants"]:]
        return True

    def _device_fatal_hook(self, reason: str, exc: BaseException) -> None:
        """The guard's on_fatal: roll the half-applied iteration back to
        its boundary and let the engine's hook checkpoint it."""
        if self._ckpt_hook is None:
            return
        if not self._rollback_to_boundary():
            log.warning("device wedge: no consistent iteration boundary to "
                        "checkpoint (boosting=%s changes trees mid-"
                        "iteration); the last periodic checkpoint stands",
                        type(self).__name__.lower())
            return
        try:
            self._ckpt_hook(reason)
        except Exception as hook_exc:  # noqa: BLE001
            log.warning("wedge checkpoint failed (%s: %s)",
                        type(hook_exc).__name__, hook_exc)

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
