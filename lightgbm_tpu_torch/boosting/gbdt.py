"""Gradient Boosting Decision Tree trainer (counterpart of
lightgbm_tpu/boosting/gbdt.py, lean: one tree per iteration).

Each iteration computes the objective's gradients from the training
score, refreshes the bagging mask, grows one tree with the wave grower
(K1 on the card), shrinks it, and adds it to the training and validation
scores — all on the training device.  Bagging masks are drawn on the host
from numpy's generator seeded with ``bagging_seed``, as in the reference,
so both packages draw the same rows.  The trees are kept as host ``Tree``
objects for prediction and model text (reference: GBDT::TrainOneIter,
gbdt.cpp:368-449); ``PredictorBase`` predicts from them, on the host or
through the stacked forest on the device.
"""
from __future__ import annotations

import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..core.forest import forest_leaf_fn, forest_predict_fn, stack_forest
from ..core.meta import (SplitConfig, _padded_bin_width, build_device_meta,
                         padded_phys_width)
from ..core.predict import predict_leaf_bins
from ..core.splitter import bitset_words
from ..core.tree import Tree, tree_depth
from ..core.wave_grower import MixedWidth, build_wave_grow_fn
from ..io.binning import BIN_CATEGORICAL
from ..utils import log
from ..utils.timetag import sync, timetag

K_EPSILON = 1e-15


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
    trees on the host, as the JAX package routes them."""

    # device prediction pays off above this many rows x trees; below it
    # host numpy wins on binning and launch overhead
    _DEVICE_PREDICT_MIN_WORK = 2_000_000

    def _iter_window(self, num_iteration: Optional[int],
                     start_iteration: int = 0) -> Tuple[int, int]:
        """(start, stop) boosting iterations."""
        n_iters = len(self.models) // self.num_tpi
        stop = n_iters if num_iteration is None or num_iteration <= 0 \
            else min(start_iteration + num_iteration, n_iters)
        return start_iteration, stop

    def _use_device(self, n_rows: int, start: int, stop: int) -> bool:
        """The JAX package's routing: enough work, and a bin space to walk
        in (the training one, or a model with a declared feature space)."""
        return (n_rows * max(stop - start, 0) * self.num_tpi
                >= self._DEVICE_PREDICT_MIN_WORK and stop > start
                and (self.train_ds is not None or self.num_features > 0))

    def predict_raw(self, X: np.ndarray, num_iteration: Optional[int] = None,
                    start_iteration: int = 0,
                    early_stop: Optional[dict] = None) -> np.ndarray:
        """Raw margins [N, K]."""
        X = np.ascontiguousarray(X, dtype=np.float64)
        K = self.num_tpi
        start, stop = self._iter_window(num_iteration, start_iteration)
        if self._use_device(X.shape[0], start, stop):
            return self._predict_raw_device(X, start, stop, early_stop)
        out = np.zeros((X.shape[0], K))
        active = None
        if early_stop is not None:
            active = np.ones(X.shape[0], dtype=bool)
        for i, it in enumerate(range(start, stop)):
            Xa = X if active is None else X[active]
            for k in range(K):
                if active is None:
                    out[:, k] += self.models[it * K + k].predict(X)
                else:
                    out[active, k] += self.models[it * K + k].predict(Xa)
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
        """Leaf index of every row in every tree of the window, [N, T]."""
        X = np.ascontiguousarray(X, dtype=np.float64)
        K = self.num_tpi
        start, stop = self._iter_window(num_iteration, start_iteration)
        if self._use_device(X.shape[0], start, stop):
            return self._predict_leaf_device(X, start, stop)
        cols = [self.models[it * K + k].predict_leaf(X)
                for it in range(start, stop) for k in range(K)]
        return np.stack(cols, axis=1) if cols else np.zeros((X.shape[0], 0))

    # ------------------------------------------------------------------
    # Device prediction: the training bin space when a dataset is
    # attached, else one rebuilt from the model (serve/packing.py).
    # ------------------------------------------------------------------
    def _forest_device(self, start: int, stop: int):
        """(space, meta, forest) of the window, cached per window: the
        model-derived bin space (None for the training one), the meta the
        walk reads, and the stacked forest on ``device``."""
        key = (start, stop, len(self.models))
        if getattr(self, "_forest_key", None) != key:
            from ..serve.packing import ServeBinSpace
            K = self.num_tpi
            trees = self.models[start * K:stop * K]
            space = (None if self.train_ds is not None
                     else ServeBinSpace(trees, self.num_features, self.device))
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
                            early_stop: Optional[dict] = None) -> np.ndarray:
        """Walk the whole window on the device at once (the replacement of
        the reference's per-row Predictor, predictor.hpp:28-271)."""
        space, meta, forest = self._forest_device(start, stop)
        bins = self._device_bins(X, space)
        with timetag("predict (forest scan)"):
            out = sync(forest_predict_fn(meta, self.num_tpi, early_stop)(
                forest, bins))
        return out.cpu().numpy().astype(np.float64)

    def _predict_leaf_device(self, X: np.ndarray, start: int,
                             stop: int) -> np.ndarray:
        """Leaf indices of the whole window, walked on the device."""
        space, meta, forest = self._forest_device(start, stop)
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

    num_tpi = 1    # trees per iteration: binary only in the port
    num_class = 1

    def __init__(self):
        self.models: List[Tree] = []
        self.iter_ = 0
        self.config = None
        self.objective = None
        self.train_ds = None
        self.metrics = []
        self.valid_names: List[str] = []
        self.valid_metrics: List[list] = []
        self._valid_scores: List[torch.Tensor] = []
        self._valid_bins: List[torch.Tensor] = []
        # what the scores were built from, for replaying them onto a valid
        # set attached later: the constants added, and each tree's shrunk
        # f32 leaf values as added (None for a constant tree)
        self._constants: List[float] = []
        self._leaf_f32: List[Optional[torch.Tensor]] = []
        self.wave_stats: List[Tuple[int, int]] = []  # per tree: (K1
        #                                             launches, rows)
        self.iter_seconds: List[float] = []  # host clock per grown tree,
        #                                      device work included

    def init(self, config, train_ds, objective, metrics, device) -> None:
        self.device = torch.device(device)
        self.config = config
        self.train_ds = train_ds
        self.objective = objective
        self.metrics = list(metrics)
        self.shrinkage_rate = float(config.learning_rate)
        N = train_ds.num_data
        objective.init(train_ds.metadata, N, self.device)
        for m in self.metrics:
            m.init(train_ds.metadata, N)
        self.meta, self.B = build_device_meta(train_ds, config, self.device)
        self.B_phys = padded_phys_width(train_ds)
        self._bundled = train_ds.bundle is not None
        self._has_cat = any(
            train_ds.inner_to_mapper(i).bin_type == BIN_CATEGORICAL
            for i in range(train_ds.num_features))
        self.split_cfg = SplitConfig.from_config(config)
        self._init_grower(config, train_ds)
        self._train_score = torch.zeros(N, dtype=torch.float32,
                                        device=self.device)
        self._bag_mask = torch.ones(N, dtype=torch.float32, device=self.device)
        self._bag_mask_host = np.ones(N, dtype=bool)
        self._rng = np.random.default_rng(config.bagging_seed)
        self._feat_rng = np.random.default_rng(config.feature_fraction_seed)
        self.class_need_train = objective.class_need_train(0)

    def _init_grower(self, config, train_ds) -> None:
        """The wave grower and its device bins (reference package: gbdt.py
        ``_init_grower``'s wave branch).  Physical columns of more than
        256 bins make the dataset mixed-width: the narrow ones go to K1 as
        uint8, the wide ones to the side-pass as int32.  Quantized modes
        with bundles or mixed widths fall back to 2xbf16, as in the
        reference."""
        X = train_ds.X_bin
        mixed = None
        if X.dtype != np.uint8 or self.B_phys > 256:
            phys_bins = np.asarray(train_ds.phys_max_bins())
            wide = phys_bins > 256
            if not (~wide).any():
                log.refuse("a dataset whose every column has more than 256 "
                           "bins", "the rest of queue 1: the serial grower")
            mixed = MixedWidth(
                narrow_idx=np.flatnonzero(~wide).astype(np.int32),
                wide_idx=np.flatnonzero(wide).astype(np.int32),
                B_narrow=_padded_bin_width(int(phys_bins[~wide].max())))
        self._wave_mixed = mixed
        hist_mode = config.hist_mode()
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
            bundled=self._bundled, mixed=mixed)

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
            m.init(valid_ds.metadata, valid_ds.num_data)
            ms.append(m)
        bins = self._device_phys_bins(valid_ds.X_bin)
        score = torch.zeros(valid_ds.num_data, dtype=torch.float32,
                            device=self.device)
        for c in self._constants:
            score = score + c
        grown = [i for i, lv in enumerate(self._leaf_f32) if lv is not None]
        if grown:
            forest = stack_forest(
                [self._tree_arrays_np(self.models[i]) for i in grown],
                np.zeros(len(grown), np.int32), self.device)
            leaves = forest_leaf_fn(self.meta, phys=self._bundled)(forest,
                                                                   bins)
            for row, i in enumerate(grown):
                score = score + self._leaf_f32[i][leaves[row]]
        self.valid_names.append(name)
        self.valid_metrics.append(ms)
        self._valid_scores.append(score)
        self._valid_bins.append(bins)

    @property
    def objective_string(self) -> str:
        return self.objective.to_model_string()

    def _boost_from_average(self) -> float:
        """(reference: gbdt.cpp:344-367)."""
        if self.models or not (self.config.boost_from_average
                               or self.train_ds.num_features == 0):
            return 0.0
        init = float(self.objective.boost_from_score(0))
        if abs(init) > K_EPSILON:
            self._add_constant(init)
            log.info("Start training from score %f", init)
            return init
        return 0.0

    def _add_constant(self, value: float) -> None:
        self._constants.append(value)
        self._train_score = self._train_score + value
        self._valid_scores = [s + value for s in self._valid_scores]

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

    def train_one_iter(self) -> bool:
        """One boosting iteration; True when training should stop (no
        splittable leaf).  Gradients are computed in the same call as the
        growth (the reference's fused gradient pass, gbdt.py:1138-1187)."""
        t0 = time.perf_counter()
        init_score = self._boost_from_average()
        g, h = self.objective.get_gradients(self._train_score)
        g, h = self._sample(self.iter_, g, h)
        feature_mask = self._feature_mask()
        nl = 1
        if self.class_need_train and self.train_ds.num_features > 0:
            arrs, leaf_id, stats = self._grow(self._bins_fm, g, h,
                                              self._bag_mask, feature_mask)
            nl = int(arrs.num_leaves)
        if nl <= 1:
            # constant tree, only for the first iteration
            # (reference: gbdt.cpp:418-436)
            if not self.models:
                output = (init_score if self.class_need_train
                          else float(self.objective.boost_from_score(0)))
                if abs(output) > K_EPSILON:
                    self._add_constant(output)
                self.models.append(Tree.constant(output))
                self._leaf_f32.append(None)
            log.warning("Stopped training because there are no more leaves "
                        "that meet the split requirements")
            return True
        lr = self.shrinkage_rate
        arrs = arrs._replace(leaf_value=arrs.leaf_value * lr,
                             internal_value=arrs.internal_value * lr)
        self._train_score = self._train_score + arrs.leaf_value[leaf_id.long()]
        tree = Tree.from_device(arrs, self.train_ds, shrinkage=lr)
        depth = tree_depth(tree.left_child, tree.right_child, tree.num_leaves)
        for i, vb in enumerate(self._valid_bins):
            leaf = predict_leaf_bins(arrs, vb, self.meta, depth,
                                     has_cat=self._has_cat,
                                     phys=self._bundled)
            self._valid_scores[i] = self._valid_scores[i] + arrs.leaf_value[leaf]
        if abs(init_score) > K_EPSILON:
            tree.leaf_value = tree.leaf_value + init_score
        self.models.append(tree)
        self._leaf_f32.append(arrs.leaf_value)
        self.wave_stats.append(stats)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.iter_seconds.append(time.perf_counter() - t0)
        self.iter_ += 1
        return False

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
        (reference: GBDT::OutputMetric, gbdt.cpp:513-571)."""
        sets = ([("training", self.metrics, self._train_score)]
                if include_train else [])
        sets += list(zip(self.valid_names, self.valid_metrics,
                         self._valid_scores))
        out = []
        for ds_name, metrics, score in sets:
            host = score.double().cpu().numpy()
            for m in metrics:
                for name, value, hib in m.eval(host, self.objective):
                    out.append((ds_name, name, value, hib))
        return out
