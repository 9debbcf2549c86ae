"""Host-side tree model: raw-value prediction and serialization state
(counterpart of lightgbm_tpu/core/tree.py).

The grower emits bin-space ``TreeArrays``; ``Tree.from_device`` converts
them once to value space with the dataset's bin mappers (reference:
Dataset::RealThreshold) and the tree then serves numpy prediction and
model text.  Categorical nodes hold value-space category bitsets
(``cat_boundaries`` / ``cat_threshold``), translated from the grower's
bin-space bitsets, and the host walk decides them as the reference's
CategoricalDecision does.
"""
from __future__ import annotations

import numpy as np
import torch

from ..io.binning import BIN_CATEGORICAL, MISSING_NAN, MISSING_ZERO

K_ZERO_THRESHOLD = 1e-35

# decision_type bit layout (reference: tree.h:19-20, 193-212): bit 0
# categorical, bit 1 default-left, bits 2-3 the missing type
_CAT_MASK = 1
_DEFAULT_LEFT_MASK = 2


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class Tree:
    """One trained tree in value space; all arrays numpy, trimmed to the
    realized ``num_leaves``."""

    def __init__(self, num_leaves: int,
                 split_feature: np.ndarray,      # original (outer) feature idx
                 threshold: np.ndarray,          # real-valued threshold
                 threshold_bin: np.ndarray,
                 decision_type: np.ndarray,      # packed missing/default-left
                 left_child: np.ndarray, right_child: np.ndarray,
                 leaf_value: np.ndarray, leaf_count: np.ndarray,
                 leaf_weight: np.ndarray,
                 split_gain: np.ndarray, internal_value: np.ndarray,
                 internal_count: np.ndarray, internal_weight: np.ndarray,
                 shrinkage: float = 1.0,
                 cat_boundaries: np.ndarray = None,
                 cat_threshold: np.ndarray = None):
        self.num_leaves = int(num_leaves)
        self.split_feature = split_feature
        self.threshold = threshold
        self.threshold_bin = threshold_bin
        self.decision_type = decision_type
        self.left_child = left_child
        self.right_child = right_child
        self.leaf_value = leaf_value
        self.leaf_count = leaf_count
        self.leaf_weight = leaf_weight
        self.split_gain = split_gain
        self.internal_value = internal_value
        self.internal_count = internal_count
        self.internal_weight = internal_weight
        self.shrinkage = float(shrinkage)
        # categorical thresholds: bitsets concatenated, node i's set is
        # words cat_boundaries[c]..cat_boundaries[c + 1] with c =
        # threshold[i] (reference: tree.h:83-99)
        self.cat_boundaries = (np.zeros(1, np.int32) if cat_boundaries is None
                               else cat_boundaries)
        self.cat_threshold = (np.zeros(0, np.uint32) if cat_threshold is None
                              else cat_threshold)

    @classmethod
    def from_device(cls, arrays, dataset, shrinkage: float = 1.0) -> "Tree":
        """Convert bin-space ``TreeArrays`` (torch tensors or numpy) to a
        value-space tree; ``dataset`` supplies the bin mappers.  A
        categorical node's bin set becomes the set of its categories (the
        NaN pseudo-category -1 dropped: value-space prediction sends
        missing values right, as CategoricalDecision does), stored as the
        reference's value-space bitset (reference package: tree.py
        ``Tree.from_device``)."""
        nl = int(_np(arrays.num_leaves))
        nn = max(nl - 1, 0)
        split_feature_inner = _np(arrays.split_feature)[:nn]
        threshold_bin = _np(arrays.threshold_bin)[:nn]
        default_left = _np(arrays.default_left)[:nn]
        bin_bitsets = _np(arrays.cat_bitset)[:nn].astype(np.int64) & 0xFFFFFFFF
        threshold = np.zeros(nn, dtype=np.float64)
        decision_type = np.zeros(nn, dtype=np.int32)
        split_feature = np.zeros(nn, dtype=np.int32)
        cat_boundaries = [0]
        cat_threshold = []
        for i in range(nn):
            inner = int(split_feature_inner[i])
            mapper = dataset.inner_to_mapper(inner)
            split_feature[i] = int(dataset.real_feature_idx[inner])
            dt = mapper.missing_type << 2
            if mapper.bin_type == BIN_CATEGORICAL:
                dt |= _CAT_MASK
                words = bin_bitsets[i]
                cats = [c for b, c in enumerate(mapper.bin_2_categorical)
                        if (int(words[b // 32]) >> (b % 32)) & 1 and c >= 0]
                n_words = (max(cats) // 32 + 1) if cats else 1
                vw = [0] * n_words
                for c in cats:
                    vw[c // 32] |= 1 << (c % 32)
                threshold[i] = len(cat_boundaries) - 1   # the set's index
                cat_threshold.extend(vw)
                cat_boundaries.append(cat_boundaries[-1] + n_words)
            else:
                if default_left[i]:
                    dt |= _DEFAULT_LEFT_MASK
                threshold[i] = mapper.bin_to_value(int(threshold_bin[i]))
            decision_type[i] = dt
        return cls(
            num_leaves=nl,
            split_feature=split_feature,
            threshold=threshold,
            threshold_bin=threshold_bin.astype(np.int32),
            decision_type=decision_type,
            left_child=_np(arrays.left_child)[:nn].astype(np.int32),
            right_child=_np(arrays.right_child)[:nn].astype(np.int32),
            leaf_value=_np(arrays.leaf_value)[:nl].astype(np.float64),
            leaf_count=_np(arrays.leaf_count)[:nl].astype(np.int32),
            leaf_weight=_np(arrays.leaf_weight)[:nl].astype(np.float64),
            split_gain=_np(arrays.split_gain)[:nn].astype(np.float64),
            internal_value=_np(arrays.internal_value)[:nn].astype(np.float64),
            internal_count=_np(arrays.internal_count)[:nn].astype(np.int32),
            internal_weight=_np(arrays.internal_weight)[:nn].astype(np.float64),
            shrinkage=shrinkage,
            cat_boundaries=np.asarray(cat_boundaries, dtype=np.int32),
            cat_threshold=np.asarray(cat_threshold, dtype=np.uint32),
        )

    @classmethod
    def constant(cls, output: float) -> "Tree":
        """A one-leaf tree (reference: gbdt.cpp:418-436)."""
        z_i, z_f = np.zeros(0, np.int32), np.zeros(0, np.float64)
        return cls(num_leaves=1, split_feature=z_i, threshold=z_f,
                   threshold_bin=z_i, decision_type=z_i, left_child=z_i,
                   right_child=z_i, leaf_value=np.array([output], np.float64),
                   leaf_count=np.zeros(1, np.int32),
                   leaf_weight=np.zeros(1, np.float64), split_gain=z_f,
                   internal_value=z_f, internal_count=z_i,
                   internal_weight=z_f)

    @property
    def num_cat(self) -> int:
        return len(self.cat_boundaries) - 1

    def missing_type(self, node: int) -> int:
        return (int(self.decision_type[node]) >> 2) & 3

    def is_categorical(self, node: int) -> bool:
        return bool(self.decision_type[node] & _CAT_MASK)

    def default_left(self, node: int) -> bool:
        return bool(self.decision_type[node] & _DEFAULT_LEFT_MASK)

    def predict_leaf(self, X: np.ndarray) -> np.ndarray:
        """Leaf index per row for raw feature values (reference:
        Tree::GetLeaf + NumericalDecision, tree.h:447-530)."""
        n = X.shape[0]
        if self.num_leaves <= 1:
            return np.zeros(n, dtype=np.int64)
        node = np.zeros(n, dtype=np.int64)
        active = np.ones(n, dtype=bool)
        while active.any():
            nd = node[active]
            fv = X[active, self.split_feature[nd]].astype(np.float64)
            go_left = self._decide(fv, nd)
            node[active] = np.where(go_left, self.left_child[nd],
                                    self.right_child[nd])
            active = node >= 0
        return ~node

    def _decide(self, fval: np.ndarray, nodes: np.ndarray) -> np.ndarray:
        """Vectorized NumericalDecision / CategoricalDecision (reference:
        tree.h:221-303)."""
        dt = self.decision_type[nodes]
        missing = (dt >> 2) & 3
        default_left = (dt & _DEFAULT_LEFT_MASK).astype(bool)
        thr = self.threshold[nodes]
        nan_mask = np.isnan(fval)
        fv = np.where(nan_mask & (missing != MISSING_NAN), 0.0, fval)
        is_zero = np.abs(fv) <= K_ZERO_THRESHOLD
        is_missing = (((missing == MISSING_ZERO) & is_zero)
                      | ((missing == MISSING_NAN) & np.isnan(fv)))
        numerical = np.where(is_missing, default_left, fv <= thr)
        is_cat = (dt & _CAT_MASK).astype(bool)
        if not is_cat.any():
            return numerical
        # the raw value, not the NaN-zeroed one: CategoricalDecision casts
        # NaN and negatives to a negative int and sends them right before
        # any missing-type handling (tree.h:262-265)
        return np.where(is_cat, self._cat_decide(fval, nodes, is_cat),
                        numerical)

    def _cat_decide(self, fval: np.ndarray, nodes: np.ndarray,
                    is_cat: np.ndarray) -> np.ndarray:
        """FindInBitset over each categorical node's category set
        (reference: tree.h:265-303, utils/common.h ConstructBitset); a
        category past the node's words is not in its set."""
        iv = np.where(np.isnan(fval) | (fval < 0), -1, fval).astype(np.int64)
        ci = np.where(is_cat, self.threshold[nodes], 0).astype(np.int64)
        lo = self.cat_boundaries[ci].astype(np.int64)
        n_words = self.cat_boundaries[ci + 1].astype(np.int64) - lo
        word = iv // 32
        inside = is_cat & (iv >= 0) & (word < n_words)
        bits = np.zeros(len(fval), np.int64)
        bits[inside] = self.cat_threshold[(lo + word)[inside]]
        return inside & (((bits >> (iv % 32)) & 1) == 1)

    def predict(self, X: np.ndarray) -> np.ndarray:
        """Raw (margin) predictions for a dense float matrix."""
        return self.leaf_value[self.predict_leaf(X)]


def tree_depth(left_child: np.ndarray, right_child: np.ndarray,
               num_leaves: int) -> int:
    """Levels a root-to-leaf walk needs (0 for a one-leaf tree); nodes are
    created in split order, so parents precede children."""
    nn = max(num_leaves - 1, 0)
    depth = np.zeros(max(nn, 1), dtype=np.int64)
    md = 0
    for i in range(nn):
        md = max(md, int(depth[i]) + 1)
        for child in (left_child[i], right_child[i]):
            if child >= 0:
                depth[child] = depth[i] + 1
    return md

