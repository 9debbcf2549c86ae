"""Gradient Boosting Decision Tree trainer (counterpart of
lightgbm_tpu/boosting/gbdt.py, lean: one tree per iteration).

Each iteration computes the objective's gradients from the training
score, refreshes the bagging mask, grows one tree with the wave grower
(K1 on the card), shrinks it, and adds it to the training and validation
scores — all on the training device.  Bagging masks are drawn on the host
from numpy's generator seeded with ``bagging_seed``, as in the reference,
so both packages draw the same rows.  The trees are kept as host ``Tree``
objects for prediction and model text (reference: GBDT::TrainOneIter,
gbdt.cpp:368-449).
"""
from __future__ import annotations

import time
from typing import List, Tuple

import numpy as np
import torch

from ..core.grower import go_left_bins
from ..core.meta import SplitConfig, build_device_meta
from ..core.tree import Tree, tree_depth
from ..core.wave_grower import build_wave_grow_fn
from ..utils import log

K_EPSILON = 1e-15


def predict_leaf_bins(arrs, bins_rm, meta):
    """Leaf index of every row of a row-major binned matrix [N, F] for one
    device tree (counterpart of lightgbm_tpu/core/predict.py
    ``predict_leaf_bins``): a bin-space walk, one level per step."""
    host = {k: arrs._asdict()[k].cpu().numpy()
            for k in ("left_child", "right_child", "num_leaves")}
    node = torch.zeros(bins_rm.shape[0], dtype=torch.int64,
                       device=bins_rm.device)
    left, right = arrs.left_child.long(), arrs.right_child.long()
    for _ in range(tree_depth(host["left_child"], host["right_child"],
                              int(host["num_leaves"]))):
        nd = node.clamp(min=0)
        f = arrs.split_feature.long()[nd]
        col = torch.gather(bins_rm, 1, f[:, None])[:, 0].int()
        go = go_left_bins(col, arrs.threshold_bin[nd], arrs.default_left[nd],
                          meta.missing_types[f], meta.num_bins[f],
                          meta.default_bins[f])
        node = torch.where(node >= 0, torch.where(go, left[nd], right[nd]),
                           node)
    return ~node


class GBDT:
    """Trainer state: the forest, the scores and the grower."""

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
        self.split_cfg = SplitConfig.from_config(config)
        self._bins_fm = torch.as_tensor(
            np.ascontiguousarray(train_ds.X_bin.T)).to(self.device)
        self._grow = build_wave_grow_fn(
            self.meta, self.split_cfg, self.B,
            wave_capacity=int(config.tpu_wave_capacity),
            highest=config.hist_mode(),
            gain_gate=float(config.tpu_wave_gain_gate),
            fused_sibling=bool(config.tpu_fused_sibling),
            quant_seed=int(config.seed))
        self._train_score = torch.zeros(N, dtype=torch.float32,
                                        device=self.device)
        self._bag_mask = torch.ones(N, dtype=torch.float32, device=self.device)
        self._bag_mask_host = np.ones(N, dtype=bool)
        self._rng = np.random.default_rng(config.bagging_seed)
        self._feat_rng = np.random.default_rng(config.feature_fraction_seed)
        self.class_need_train = objective.class_need_train(0)

    def add_valid(self, valid_ds, name: str) -> None:
        if self.models:
            log.fatal("valid sets must be attached before the first "
                      "iteration in the PyTorch port (replaying trees onto a "
                      "late valid set comes with forest predict, ROADMAP.md "
                      "port queue)")
        ms = []
        for proto in self.metrics:
            m = type(proto)(self.config)
            m.init(valid_ds.metadata, valid_ds.num_data)
            ms.append(m)
        self.valid_names.append(name)
        self.valid_metrics.append(ms)
        self._valid_scores.append(torch.zeros(
            valid_ds.num_data, dtype=torch.float32, device=self.device))
        self._valid_bins.append(torch.as_tensor(valid_ds.X_bin).to(self.device))

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
        self._bagging(self.iter_)
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
            log.warning("Stopped training because there are no more leaves "
                        "that meet the split requirements")
            return True
        lr = self.shrinkage_rate
        arrs = arrs._replace(leaf_value=arrs.leaf_value * lr,
                             internal_value=arrs.internal_value * lr)
        self._train_score = self._train_score + arrs.leaf_value[leaf_id.long()]
        for i, vb in enumerate(self._valid_bins):
            leaf = predict_leaf_bins(arrs, vb, self.meta)
            self._valid_scores[i] = self._valid_scores[i] + arrs.leaf_value[leaf]
        tree = Tree.from_device(arrs, self.train_ds, shrinkage=lr)
        if abs(init_score) > K_EPSILON:
            tree.leaf_value = tree.leaf_value + init_score
        self.models.append(tree)
        self.wave_stats.append(stats)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.iter_seconds.append(time.perf_counter() - t0)
        self.iter_ += 1
        return False

    # ------------------------------------------------------------------
    def predict_raw(self, X: np.ndarray, num_iteration: int = -1) -> np.ndarray:
        """Raw margins by the host tree walk."""
        X = np.ascontiguousarray(X, dtype=np.float64)
        stop = (len(self.models) if num_iteration is None or num_iteration <= 0
                else min(num_iteration, len(self.models)))
        out = np.zeros(X.shape[0])
        for tree in self.models[:stop]:
            out += tree.predict(X)
        return out

    def predict(self, X, num_iteration: int = -1, raw_score: bool = False):
        raw = self.predict_raw(X, num_iteration)
        return raw if raw_score else self.objective.convert_output(raw)

    def feature_importance(self, num_iteration: int = -1) -> np.ndarray:
        """Split counts per original feature (reference:
        GBDT::FeatureImportance, gbdt.cpp:573-600)."""
        imp = np.zeros(self.train_ds.num_total_features)
        stop = (len(self.models) if num_iteration <= 0
                else min(num_iteration, len(self.models)))
        for tree in self.models[:stop]:
            np.add.at(imp, tree.split_feature[:max(tree.num_leaves - 1, 0)],
                      1.0)
        return imp

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
