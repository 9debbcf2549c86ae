"""Tree arrays shared by the growers (counterpart of the shared part of
lightgbm_tpu/core/grower.py).

The reference's dynamic tree (reference: include/LightGBM/tree.h:360-445)
is a fixed-capacity structure of arrays: internal nodes 0..L-2 in split
order, children < 0 encoding leaves as ``~leaf_index``; the left child
keeps its parent's leaf index, the right child takes the next free one.
A categorical node keeps its left-going bin set as a bitset.  The serial
grower (``build_grow_fn``) is not ported yet.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .splitter import split_decision


class TreeArrays(NamedTuple):
    """Fixed-capacity SoA tree; fields are numpy arrays while a grower
    builds it and torch tensors once handed out (``convert.py``)."""
    split_feature: object    # i32 [L-1] inner feature (-1 = unused node)
    threshold_bin: object    # i32 [L-1]
    default_left: object     # bool [L-1]
    left_child: object       # i32 [L-1]
    right_child: object      # i32 [L-1]
    split_gain: object       # f32 [L-1]
    internal_value: object   # f32 [L-1] output the node had as a leaf
    internal_count: object   # i32 [L-1]
    internal_weight: object  # f32 [L-1] sum_hessian
    leaf_value: object       # f32 [L]
    leaf_count: object       # i32 [L]
    leaf_weight: object      # f32 [L] sum_hessian
    num_leaves: object       # i32 scalar
    cat_bitset: object       # i32 [L-1, W] left-going bin set of a
    #                          categorical node (uint32 words' bits)


def _empty_tree(L: int, W: int = 1) -> TreeArrays:
    """A one-leaf tree of capacity ``L`` (bitsets of ``W`` words) as numpy
    arrays."""
    n = max(L - 1, 1)
    return TreeArrays(
        split_feature=np.full((n,), -1, np.int32),
        threshold_bin=np.zeros((n,), np.int32),
        default_left=np.zeros((n,), bool),
        left_child=np.zeros((n,), np.int32),
        right_child=np.zeros((n,), np.int32),
        split_gain=np.zeros((n,), np.float32),
        internal_value=np.zeros((n,), np.float32),
        internal_count=np.zeros((n,), np.int32),
        internal_weight=np.zeros((n,), np.float32),
        leaf_value=np.zeros((L,), np.float32),
        leaf_count=np.zeros((L,), np.int32),
        leaf_weight=np.zeros((L,), np.float32),
        num_leaves=np.int32(1),
        cat_bitset=np.zeros((n, W), np.int32),
    )


def decode_feature_col(colp, off, num_bin, default_bin):
    """EFB decode: physical-column bins -> the bins of a feature at bin
    offset ``off`` (io/bundling.py layout); the identity for a feature
    alone in its column (offset 0).  All args broadcastable tensors."""
    inb = (colp >= off) & (colp < off + num_bin)
    return torch.where(inb, colp - off, default_bin)


def go_left_bins(col, threshold, default_left, missing_type, num_bin,
                 default_bin, is_cat=None, cat_word=None):
    """Bin-space split decision for every row (reference:
    src/io/dense_bin.hpp:152-231 Split).  ``col`` int tensor [N]."""
    return split_decision(col, threshold, default_left, missing_type,
                          num_bin, default_bin, is_cat, cat_word)
