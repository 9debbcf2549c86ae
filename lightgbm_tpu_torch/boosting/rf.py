"""Random forest (counterpart of lightgbm_tpu/boosting/rf.py; reference:
src/boosting/rf.hpp:25-218).

Bagging is required, the shrinkage is 1, the gradients come once from the
constant init score, and the scores are the average of the trees
(``average_output``), kept by the reference's multiply, update, multiply
sequence.  The L1-type objectives refit their leaves against the init
score.  Trees grow on the same growers as GBDT (the wave grower, K1 on
the card).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..core.tree import Tree
from ..utils import log
from .gbdt import GBDT, K_EPSILON


class RF(GBDT):
    average_output = True

    def init(self, config, train_ds, objective, metrics, device) -> None:
        if not (config.bagging_freq > 0
                and 0.0 < config.bagging_fraction < 1.0):
            log.fatal("RF mode requires bagging "
                      "(bagging_freq > 0 and bagging_fraction in (0, 1))")
        if not (0.0 < config.feature_fraction <= 1.0):
            log.fatal("RF mode requires feature_fraction in (0, 1]")
        super().init(config, train_ds, objective, metrics, device)
        self.shrinkage_rate = 1.0
        # gradients from the constant init score, once (rf.hpp:82-101)
        self.init_scores = [self._rf_init_score(k)
                            for k in range(self.num_tpi)]
        N = train_ds.num_data
        base = torch.stack([torch.full((N,), s, dtype=torch.float32,
                                       device=self.device)
                            for s in self.init_scores], dim=1)
        score = base[:, 0] if self.num_tpi == 1 else base
        self._g_fixed, self._h_fixed = objective.get_gradients(score)

    def _rf_init_score(self, k: int) -> float:
        if self.objective is None:
            log.fatal("RF mode does not support custom objective functions")
        if not self.config.boost_from_average:
            return 0.0
        return float(self.objective.boost_from_score(k))

    def _multiply_score(self, k: int, val: float) -> None:
        def mul(score):
            if score.dim() == 1:
                return score * val
            score = score.clone()
            score[:, k] *= val
            return score
        self._train_score = mul(self._train_score)
        self._valid_scores = [mul(s) for s in self._valid_scores]

    def train_one_iter(self, gradients=None, hessians=None) -> bool:
        """(reference: rf.hpp:105-168)."""
        if gradients is not None or hessians is not None:
            log.fatal("RF mode does not support custom objective functions")
        t0 = time.perf_counter()
        if self._ckpt_hook is not None and self._guard.active:
            self._snapshot_boundary()
        self._bagging(self.iter_)
        g, h = self._g_fixed, self._h_fixed
        feature_mask = self._feature_mask()
        K = self.num_tpi
        for k in range(K):
            nl = 1
            if self.class_need_train[k] and self.train_ds.num_features > 0:
                arrs, leaf_id, stats = self._grow_tree(k, g, h, feature_mask)
                nl = int(arrs.num_leaves)
            self._multiply_score(k, self.iter_)
            if nl > 1:
                arrs = self._renew_rf_output(arrs, leaf_id, k)
                if abs(self.init_scores[k]) > K_EPSILON:
                    arrs = arrs._replace(
                        leaf_value=arrs.leaf_value + self.init_scores[k])
                tree = Tree.from_device(arrs, self.train_ds, shrinkage=1.0)
                self._train_score = self._add_to_class(
                    self._train_score, k, arrs.leaf_value[leaf_id.long()])
                self._add_to_valid(arrs, tree, k)
                self._leaf_f32.append(arrs.leaf_value)
                self.wave_stats.append(stats)
            else:
                output = 0.0
                if len(self.models) < K and not self.class_need_train[k]:
                    output = float(self.objective.boost_from_score(k))
                tree = Tree.constant(output)
                self._train_score = self._add_to_class(self._train_score, k,
                                                       output)
                self._valid_scores = [self._add_to_class(s, k, output)
                                      for s in self._valid_scores]
                self._leaf_f32.append(None)
            self._multiply_score(k, 1.0 / (self.iter_ + 1))
            self.models.append(tree)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.iter_seconds.append(time.perf_counter() - t0)
        self.iter_ += 1
        return False

    def _renew_rf_output(self, arrs, leaf_id, k: int):
        """Leaf refit against the constant init score (rf.hpp:117-121)."""
        if self.objective is None or not self.objective.is_renew_tree_output:
            return arrs
        nl = int(arrs.num_leaves)
        residual = (self.train_ds.metadata.label.astype(np.float64)
                    - self.init_scores[k])
        new_vals = self.objective.renew_leaf_values(
            residual, leaf_id.cpu().numpy(), nl, self._bag_mask_host)
        lv = arrs.leaf_value.cpu().numpy().copy()
        ok = ~np.isnan(new_vals)
        lv[:nl][ok] = new_vals[ok]
        return arrs._replace(leaf_value=torch.as_tensor(lv).to(self.device))

    def add_valid(self, valid_ds, name: str) -> None:
        """A late valid set: the replayed sum of the trees, averaged."""
        super().add_valid(valid_ds, name)
        if self.iter_ > 0:
            self._valid_scores[-1] = self._valid_scores[-1] / self.iter_

    def predict_raw(self, X, num_iteration=None, start_iteration: int = 0,
                    early_stop=None):
        raw = super().predict_raw(X, num_iteration, start_iteration,
                                  early_stop)
        start, stop = self._iter_window(num_iteration, start_iteration)
        return raw / max(stop - start, 1)
