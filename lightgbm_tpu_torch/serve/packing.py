"""Model-derived bin space: device prediction without training state
(counterpart of lightgbm_tpu/serve/packing.py: ``collect_split_state``
and ``ServeBinSpace``, whose ``tree_arrays_np`` also packs the cover
counts of TreeSHAP and whose ``pack`` stacks a tree window, with the
arena's tenant lane when asked).

The device walk (``core/forest.py``) runs in bin space, which a trained
booster gets from its dataset's ``BinMapper``s.  A model loaded from text
has only value-space thresholds and category bitsets, so a bin space is
rebuilt from the forest itself:

- **numerical** features: the sorted distinct thresholds the window's
  trees split on become the bin upper bounds
  (``BinMapper.from_thresholds``).  A node with threshold ``thr`` gets
  ``threshold_bin = value_to_bin(thr)``, and the bin-space compare ``col <=
  threshold_bin`` is exactly the host's ``v <= thr``: the bins quantize the
  decisions, not the data, so parity is structural.
- **categorical** features: the category value itself is the bin, so the
  model's value-space bitsets are already bin-space bitsets.  NaN,
  negative and out-of-range categories map to a sentinel bin whose bitset
  word is zero padding, and route right as in the reference's
  CategoricalDecision (tree.h:262-303).
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..core.meta import DeviceMeta
from ..io.binning import BinMapper


def collect_split_state(models, num_features: int,
                        want_cats: bool = False):
    """Walk a forest once and gather, per original feature, what a
    model-derived bin space needs: the numerical split thresholds, the
    widest missing type, the categorical flag, the category values the
    node bitsets reference, and the widest node bitset (in words).

    Only the online loop's continue path (``online/binspace.py``) needs
    the category sets, to rebuild training categorical mappers:
    ``want_cats=True`` decodes the bitsets bit by bit, and without it the
    sets stay empty and serving pays for word counts only.  Returns
    ``(thr_vals, miss, is_cat, cats, words)``."""
    F = int(num_features)
    thr_vals: List[List[float]] = [[] for _ in range(F)]
    miss = np.zeros(F, np.int32)
    is_cat = np.zeros(F, bool)
    cats: List[set] = [set() for _ in range(F)]
    words = 0
    for tree in models:
        for i in range(max(tree.num_leaves - 1, 0)):
            f = int(tree.split_feature[i])
            if f < 0 or f >= F:
                raise ValueError(
                    f"model splits on feature {f} outside the declared "
                    f"feature space [0, {F})")
            if tree.is_categorical(i):
                is_cat[f] = True
                ci = int(tree.threshold[i])
                lo = int(tree.cat_boundaries[ci])
                hi = int(tree.cat_boundaries[ci + 1])
                words = max(words, hi - lo)
                if want_cats:
                    for w in range(hi - lo):
                        bits = int(tree.cat_threshold[lo + w])
                        while bits:
                            b = bits & -bits
                            cats[f].add(w * 32 + b.bit_length() - 1)
                            bits ^= b
            else:
                thr_vals[f].append(float(tree.threshold[i]))
                miss[f] = max(miss[f], tree.missing_type(i))
    return thr_vals, miss, is_cat, cats, words


class ServeBinSpace:
    """Per-feature value -> bin mapping and a ``DeviceMeta`` on ``device``,
    rebuilt from the forest's own split state (no dataset needed)."""

    def __init__(self, models, num_features: int, device="cpu"):
        F = max(int(num_features), 1)
        self.num_features = F
        self.device = device
        thr_vals, miss, is_cat, _, words = collect_split_state(models, F)

        # one zero word past the widest node bitset: the sentinel bin's
        # word gathers 0, so unseen and NaN categories route right
        self.cat_words = max(words, 1)
        self.min_words = self.cat_words + 1
        self.sentinel = self.cat_words * 32

        self.mappers: List[Optional[BinMapper]] = [None] * F
        num_bins = np.ones(F, np.int32)
        default_bins = np.zeros(F, np.int32)
        for f in range(F):
            if is_cat[f]:
                num_bins[f] = self.sentinel + 1
            elif thr_vals[f]:
                m = BinMapper.from_thresholds(thr_vals[f], int(miss[f]))
                self.mappers[f] = m
                num_bins[f] = m.num_bin
                default_bins[f] = m.default_bin
        self._is_cat = is_cat

        def t(a):
            return torch.from_numpy(np.asarray(a)).to(device)
        self.meta = DeviceMeta(
            num_bins=t(num_bins), default_bins=t(default_bins),
            missing_types=t(miss), monotone=t(np.zeros(F, np.int32)),
            penalties=t(np.ones(F, np.float32)), is_categorical=t(is_cat))

    def state(self) -> dict:
        """The space as numpy and plain values (``serve/aot.py`` entries);
        ``from_state`` rebuilds it without the trees."""
        from .aot import to_host
        return {"num_features": self.num_features,
                "cat_words": self.cat_words, "min_words": self.min_words,
                "sentinel": self.sentinel, "is_cat": self._is_cat.copy(),
                "mappers": [None if m is None else m.to_dict()
                            for m in self.mappers],
                "meta": to_host(self.meta)}

    @classmethod
    def from_state(cls, state: dict, device="cpu") -> "ServeBinSpace":
        from .aot import from_host
        self = cls.__new__(cls)
        self.num_features = int(state["num_features"])
        self.device = device
        self.cat_words = int(state["cat_words"])
        self.min_words = int(state["min_words"])
        self.sentinel = int(state["sentinel"])
        self._is_cat = np.asarray(state["is_cat"], bool)
        self.mappers = [None if m is None else BinMapper.from_dict(m)
                        for m in state["mappers"]]
        if not (len(self.mappers) == len(self._is_cat)
                == self.num_features):
            raise ValueError("bin space state has inconsistent widths")
        self.meta = from_host(DeviceMeta, state["meta"], device)
        return self

    def bin_matrix(self, X: np.ndarray) -> np.ndarray:
        """Bin raw rows into this space: [N, F] int32.  Columns no tree
        splits on are never read by the walk and stay zero."""
        X = np.ascontiguousarray(X, dtype=np.float64)
        if X.ndim != 2 or X.shape[1] < self.num_features:
            raise ValueError(
                f"input has {X.shape[-1] if X.ndim else 0} features, the "
                f"model needs {self.num_features}")
        out = np.zeros((X.shape[0], self.num_features), dtype=np.int32)
        for f in range(self.num_features):
            if self._is_cat[f]:
                col = X[:, f]
                # the reference casts to int and sends NaN and negatives
                # right before any missing handling (tree.h:262-265);
                # categories past every bitset cannot be in one either, so
                # both take the zero-word sentinel
                iv = np.where(np.isnan(col) | (col < 0), -1.0,
                              col).astype(np.int64)
                out[:, f] = np.where((iv < 0) | (iv >= self.sentinel),
                                     self.sentinel, iv)
            elif self.mappers[f] is not None:
                out[:, f] = self.mappers[f].value_to_bin(X[:, f])
        return out

    def tree_arrays_np(self, tree, with_counts: bool = False) -> dict:
        """Bin-space numpy arrays of one value-space host ``Tree``: the
        unit ``core.forest.stack_forest`` batches.  ``with_counts`` adds
        the per-node data-cover counts TreeSHAP needs (model text carries
        them, so a loaded model explains without training state)."""
        nl = tree.num_leaves
        nn = max(nl - 1, 0)
        sf = np.asarray(tree.split_feature[:nn], np.int32)
        thr_bin = np.zeros(nn, np.int32)
        dl = np.zeros(nn, bool)
        cat_bits = np.zeros((nn, self.cat_words), np.uint32)
        for i in range(nn):
            if tree.is_categorical(i):
                ci = int(tree.threshold[i])
                lo = int(tree.cat_boundaries[ci])
                hi = int(tree.cat_boundaries[ci + 1])
                cat_bits[i, :hi - lo] = tree.cat_threshold[lo:hi]
            else:
                m = self.mappers[int(sf[i])]
                thr_bin[i] = int(m.value_to_bin(float(tree.threshold[i])))
                dl[i] = tree.default_left(i)
        out = dict(
            split_feature=sf, threshold_bin=thr_bin, default_left=dl,
            left_child=np.asarray(tree.left_child[:nn], np.int32),
            right_child=np.asarray(tree.right_child[:nn], np.int32),
            leaf_value=np.asarray(tree.leaf_value[:nl], np.float32),
            num_leaves=np.int32(nl), cat_bitset=cat_bits)
        if with_counts:
            out["internal_count"] = np.asarray(tree.internal_count[:nn],
                                               np.int32)
            out["leaf_count"] = np.asarray(tree.leaf_count[:nl], np.int32)
        return out

    def pack(self, trees, class_ids, with_counts: bool = False,
             model_ids=None):
        """Stack a tree window into one ``ForestArrays`` on this space's
        device; ``model_ids`` ([T]) stamps the per-tree tenant lane of a
        multi-tenant arena pack (``serve/arena.py``)."""
        from ..core.forest import stack_forest
        return stack_forest([self.tree_arrays_np(t, with_counts=with_counts)
                             for t in trees],
                            np.asarray(class_ids, np.int32), self.device,
                            min_words=self.min_words,
                            with_counts=with_counts, model_ids=model_ids)
