"""Forced splits: a breadth-first split prescription loaded from JSON
(counterpart of lightgbm_tpu/io/forced_splits.py; reference:
src/treelearner/serial_tree_learner.cpp:607-770 ForceSplits, config.h
forcedsplits_filename).

The JSON is a binary tree of ``{"feature": <original index>, "threshold":
<value>, "left": {...}, "right": {...}}`` nodes, applied breadth first at
the start of every tree before gain-driven growth.  It is flattened into
three arrays indexed by split step ``k``: (leaf, inner feature, threshold
bin), using the growers' leaf numbering (the left child keeps its
parent's leaf index, the right child of step ``k`` is leaf ``k + 1``).

The JAX package's two documented deviations from the reference hold
here too: thresholds are binned with ``value_to_bin`` and rows go left
when ``bin <= threshold_bin``; a categorical feature cannot be forced (a
warning, and forcing stops there).
"""
from __future__ import annotations

import json
import os
from typing import Optional, Tuple

import numpy as np

from ..utils import log
from .binning import BIN_NUMERICAL


def load_forced_splits(path: str, ds, num_leaves: int
                       ) -> Optional[Tuple[np.ndarray, np.ndarray,
                                           np.ndarray]]:
    """``forcedsplits_filename`` as step-indexed int32 arrays ``(leaf,
    feature, threshold_bin)`` of length ``num_leaves - 1``, -1 where growth
    is gain-driven; None when no file is configured.  ``ds`` is the
    ``BinnedDataset`` whose mappers define the bin space.  A missing file
    is fatal."""
    if not path:
        return None
    if not os.path.exists(path):
        log.fatal(f"Forced splits file {path} does not exist")
    with open(path) as fh:
        root = json.load(fh)
    if not root:
        return None
    n = max(num_leaves - 1, 1)
    fl = np.full(n, -1, np.int32)
    ff = np.full(n, -1, np.int32)
    ft = np.zeros(n, np.int32)
    queue = [(root, 0)]          # (JSON node, leaf index), breadth first
    k = 0
    while queue and k < n:
        node, leaf = queue.pop(0)
        orig = int(node["feature"])
        if orig < 0 or orig >= ds.num_total_features:
            log.fatal(f"Forced split feature {orig} out of range")
        inner = int(ds.used_feature_map[orig])
        if inner < 0:
            log.warning("Forced split on unused feature %d ignored; "
                        "remaining forced splits dropped", orig)
            break
        mapper = ds.inner_to_mapper(inner)
        if mapper.bin_type != BIN_NUMERICAL:
            log.warning("Forced split on categorical feature %d is not "
                        "supported; remaining forced splits dropped", orig)
            break
        fl[k], ff[k] = leaf, inner
        ft[k] = int(np.asarray(mapper.value_to_bin(
            np.asarray([float(node["threshold"])])))[0])
        if isinstance(node.get("left"), dict):
            queue.append((node["left"], leaf))
        if isinstance(node.get("right"), dict):
            queue.append((node["right"], k + 1))
        k += 1
    if queue and k >= n:
        log.warning("Forced splits exceed num_leaves-1=%d; extra nodes "
                    "ignored", n)
    if k == 0:
        return None
    return fl, ff, ft
