"""DART — dropout trees (counterpart of lightgbm_tpu/boosting/dart.py;
reference: src/boosting/dart.hpp:30-258).

Each iteration selects trees to drop and takes their contribution out of
the training score, grows the new tree (the wave grower, K1 on the card)
at shrinkage ``lr / (k + 1)`` (``xgboost_dart_mode``: ``lr / (lr + k)``),
then rescales the dropped trees to ``k / (k + 1)`` of their weight and
patches the training and validation scores (the three-step dance of
dart.hpp:142-156).  The drop draw is numpy's generator seeded with
``drop_seed``, as in the JAX package, so both packages drop the same
trees.  A dropped tree's scores are patched through its leaves on the
device (``core/forest.py forest_leaf_fn``, on the physical columns of an
EFB-bundled dataset).
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from .. import obs
from ..core.forest import forest_leaf_fn, stack_forest
from ..utils import log
from .gbdt import GBDT


class DART(GBDT):
    # the drop rescales host trees before the iteration's growth, so a
    # half-applied iteration cannot roll back; a wedge relies on the last
    # periodic checkpoint
    _boundary_rollback = False

    def init(self, config, train_ds, objective, metrics, device) -> None:
        super().init(config, train_ds, objective, metrics, device)
        self._drop_rng = np.random.default_rng(config.drop_seed)
        self.tree_weight: List[float] = []
        self.sum_weight = 0.0
        self.drop_index: List[int] = []
        self.drops: List[int] = []        # trees dropped, per iteration
        self._model_version = 0           # bumped by every rescale
        self._replay_stale = False
        log.info("Using DART")

    def checkpoint_state(self):
        """Besides the base state: the drop RNG, the tree weights and their
        sum (the rescaled leaves ride in the model text)."""
        meta, arrays = super().checkpoint_state()
        meta["drop_rng_state"] = self._drop_rng.bit_generator.state
        meta["tree_weight"] = [float(w) for w in self.tree_weight]
        meta["sum_weight"] = float(self.sum_weight)
        return meta, arrays

    def restore_checkpoint_state(self, meta, arrays) -> None:
        super().restore_checkpoint_state(meta, arrays)
        if "drop_rng_state" in meta:
            self._drop_rng.bit_generator.state = meta["drop_rng_state"]
        self.tree_weight = [float(w) for w in meta.get("tree_weight", [])]
        self.sum_weight = float(meta.get("sum_weight", 0.0))

    def train_one_iter(self, gradients=None, hessians=None) -> bool:
        self._dropping_trees()
        if super().train_one_iter(gradients, hessians):
            return True
        self._normalize()
        if obs.health_enabled():
            # the renormalization changes scores outside the checked
            # gradient path (iter_ has moved on: name the finished one)
            obs.check_score(self._train_score, phase="dart normalize",
                            iteration=self.iter_ - 1)
        if not self.config.uniform_drop:
            self.tree_weight.append(self.shrinkage_rate)
            self.sum_weight += self.shrinkage_rate
        return False

    # ------------------------------------------------------------------
    def _tree_scores(self, tree, bins: torch.Tensor):
        """One host tree's f32 leaf value for every row of ``bins``."""
        lv = torch.as_tensor(tree.leaf_value[:tree.num_leaves].astype(
            np.float32)).to(self.device)
        if tree.num_leaves <= 1:
            return lv[0]
        forest = stack_forest([self._tree_arrays_np(tree)],
                              np.zeros(1, np.int32), self.device)
        leaf = forest_leaf_fn(self.meta, phys=self._bundled)(forest, bins)
        return lv[leaf[0]]

    def _add_tree_to_scores(self, tree, k: int, train: bool,
                            valid: bool) -> None:
        if train:
            self._train_score = self._add_to_class(
                self._train_score, k,
                self._tree_scores(tree, self._train_bins_dev()))
        if valid:
            for i, vb in enumerate(self._valid_bins):
                self._valid_scores[i] = self._add_to_class(
                    self._valid_scores[i], k, self._tree_scores(tree, vb))

    def _dropping_trees(self) -> None:
        """(reference: dart.hpp:97-140)."""
        c = self.config
        self.drop_index = []
        if self._drop_rng.random() >= c.skip_drop:
            drop_rate = c.drop_rate
            if not c.uniform_drop:
                if self.sum_weight > 0:
                    inv_avg = len(self.tree_weight) / self.sum_weight
                    if c.max_drop > 0:
                        drop_rate = min(drop_rate, c.max_drop * inv_avg
                                        / self.sum_weight)
                    for i in range(self.iter_):
                        if (self._drop_rng.random()
                                < drop_rate * self.tree_weight[i] * inv_avg):
                            self.drop_index.append(
                                self.num_init_iteration + i)
                            if (c.max_drop > 0
                                    and len(self.drop_index) >= c.max_drop):
                                break
            else:
                if c.max_drop > 0 and self.iter_ > 0:
                    drop_rate = min(drop_rate, c.max_drop / self.iter_)
                for i in range(self.iter_):
                    if self._drop_rng.random() < drop_rate:
                        self.drop_index.append(self.num_init_iteration + i)
                        if (c.max_drop > 0
                                and len(self.drop_index) >= c.max_drop):
                            break
        # take the dropped trees out of the training score
        for i in self.drop_index:
            for k in range(self.num_tpi):
                tree = self.models[i * self.num_tpi + k]
                tree.apply_shrinkage(-1.0)
                self._add_tree_to_scores(tree, k, train=True, valid=False)
        if self.drop_index:
            self._model_version += 1
            self._replay_stale = True
        self.drops.append(len(self.drop_index))
        kdrop = len(self.drop_index)
        if not c.xgboost_dart_mode:
            self.shrinkage_rate = c.learning_rate / (1.0 + kdrop)
        else:
            self.shrinkage_rate = (c.learning_rate if kdrop == 0 else
                                   c.learning_rate / (c.learning_rate + kdrop))

    def _normalize(self) -> None:
        """(reference: dart.hpp:142-200)."""
        c = self.config
        k = float(len(self.drop_index))
        for i in self.drop_index:
            for cid in range(self.num_tpi):
                tree = self.models[i * self.num_tpi + cid]
                if not c.xgboost_dart_mode:
                    tree.apply_shrinkage(1.0 / (k + 1.0))
                    self._add_tree_to_scores(tree, cid, train=False,
                                             valid=True)
                    tree.apply_shrinkage(-k)
                    self._add_tree_to_scores(tree, cid, train=True,
                                             valid=False)
                else:
                    tree.apply_shrinkage(self.shrinkage_rate)
                    self._add_tree_to_scores(tree, cid, train=False,
                                             valid=True)
                    tree.apply_shrinkage(-k / c.learning_rate)
                    self._add_tree_to_scores(tree, cid, train=True,
                                             valid=False)
            if not c.uniform_drop:
                j = i - self.num_init_iteration
                if not c.xgboost_dart_mode:
                    self.sum_weight -= self.tree_weight[j] * (1.0 / (k + 1.0))
                    self.tree_weight[j] *= k / (k + 1.0)
                else:
                    self.sum_weight -= self.tree_weight[j] * (
                        1.0 / (k + c.learning_rate))
                    self.tree_weight[j] *= k / (k + c.learning_rate)

    def _prepare_replay(self) -> None:
        """After a rescale, a valid set attached late replays the trees as
        they now stand (the model text), not as training first added
        them."""
        if not self._replay_stale:
            return
        self._constants, self._leaf_f32 = [], []
        for i, t in enumerate(self.models):
            if t.num_leaves <= 1:
                self._constants.append((i % self.num_tpi,
                                        float(t.leaf_value[0])))
                self._leaf_f32.append(None)
            else:
                self._leaf_f32.append(torch.as_tensor(
                    t.leaf_value[:t.num_leaves].astype(np.float32)).to(
                        self.device))
        self._replay_stale = False
