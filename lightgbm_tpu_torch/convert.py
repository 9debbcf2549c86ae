"""Carry state between the JAX package and the port as numpy arrays.

A GBDT has no weights: its bin mappers, binned matrix, device metadata and
trees are its state.  These functions take the reference package's arrays
as numpy (``np.asarray`` of its jax arrays, ``BinMapper.to_dict()``) and
build the port's objects, so both packages can be fed the same binned
matrix, metadata and trees.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from .utils import log

_META_FIELDS = ("num_bins", "default_bins", "missing_types", "monotone",
                "penalties", "is_categorical")
_META_DTYPES = {"penalties": torch.float32, "is_categorical": torch.bool}
_TREE_INT = ("split_feature", "threshold_bin", "left_child", "right_child",
             "internal_count", "leaf_count", "num_leaves")
_TREE_FLOAT = ("split_gain", "internal_value", "internal_weight",
               "leaf_value", "leaf_weight")


def meta_from_numpy(fields: dict, device):
    """``DeviceMeta`` from numpy fields (the reference's ``DeviceMeta``
    fields work; its EFB and categorical fields must be trivial, and an
    absent ``is_categorical`` means none)."""
    from .core.meta import DeviceMeta
    if np.any(np.asarray(fields.get("is_categorical", False))):
        log.fatal("categorical features are not in the PyTorch port yet "
                  "(ROADMAP.md port queue: categorical/EFB/mixed width)")
    if np.any(np.asarray(fields.get("needs_fix", False))) or np.any(
            np.asarray(fields.get("feat_offset", 0))):
        log.fatal("EFB bundles are not in the PyTorch port yet (ROADMAP.md "
                  "port queue: categorical/EFB/mixed width)")
    fields = {"is_categorical": np.zeros(len(fields["num_bins"]), bool),
              **fields}
    out = {}
    for name in _META_FIELDS:
        dtype = _META_DTYPES.get(name, torch.int32)
        out[name] = torch.tensor(np.asarray(fields[name])).to(
            device=device, dtype=dtype)
    return DeviceMeta(**out)


def tree_arrays_from_numpy(d: dict, device):
    """``TreeArrays`` of tensors from numpy fields (a reference
    ``TreeArrays``' ``_asdict()`` works; its categorical bitsets must be
    empty)."""
    from .core.grower import TreeArrays
    if np.any(np.asarray(d.get("cat_bitset", 0))):
        log.fatal("categorical splits are not in the PyTorch port yet "
                  "(ROADMAP.md port queue: categorical/EFB/mixed width)")
    out = {}
    for name in _TREE_INT:
        out[name] = torch.tensor(np.asarray(d[name], np.int32)).to(device)
    for name in _TREE_FLOAT:
        out[name] = torch.tensor(np.asarray(d[name], np.float32)).to(device)
    out["default_left"] = torch.tensor(
        np.asarray(d["default_left"], bool)).to(device)
    return TreeArrays(**out)


def tree_arrays_to_numpy(t) -> dict:
    """numpy fields of a ``TreeArrays`` (the inverse of the above)."""
    return {k: np.asarray(v.detach().cpu().numpy() if torch.is_tensor(v)
                          else v)
            for k, v in t._asdict().items()}


def dataset_from_numpy(X_bin: np.ndarray, mapper_state: Sequence[dict],
                       feature_names: List[str] = None):
    """A ``BinnedDataset`` from a binned matrix [N, F_used] and one mapper
    state per ORIGINAL column (``BinMapper.to_dict()``, trivial columns
    included)."""
    from .io.binning import BinMapper
    from .io.dataset import BinnedDataset, Metadata
    ds = BinnedDataset()
    ds.bin_mappers = [BinMapper.from_dict(m) for m in mapper_state]
    ds.num_total_features = len(ds.bin_mappers)
    ds.feature_names = (list(feature_names) if feature_names
                        else [f"Column_{i}" for i in range(ds.num_total_features)])
    ds._finalize_features()
    X_bin = np.ascontiguousarray(X_bin)
    if X_bin.dtype != np.uint8 or X_bin.shape[1] != ds.num_features:
        log.fatal(f"X_bin must be uint8 [N, {ds.num_features}], got "
                  f"{X_bin.dtype} {X_bin.shape}")
    ds.X_bin = X_bin
    ds.num_data = X_bin.shape[0]
    ds.metadata = Metadata(ds.num_data)
    return ds
