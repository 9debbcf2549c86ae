"""Carry state between the JAX package and the port as numpy arrays.

A GBDT has no weights: its bin mappers, binned matrix, EFB bundles,
device metadata and trees are its state.  These functions take the
reference package's arrays as numpy (``np.asarray`` of its jax arrays,
``BinMapper.to_dict()``, its ``BundleInfo``) and build the port's objects,
categorical mappers, bundles and tree bitsets included, so both packages
can be fed the same binned matrix, metadata and trees.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from .utils import log

_META_FIELDS = ("num_bins", "default_bins", "missing_types", "monotone",
                "penalties", "is_categorical", "feat2phys", "feat_offset",
                "needs_fix")
_META_DTYPES = {"penalties": torch.float32, "is_categorical": torch.bool,
                "needs_fix": torch.bool}
_TREE_INT = ("split_feature", "threshold_bin", "left_child", "right_child",
             "internal_count", "leaf_count", "num_leaves")
_TREE_FLOAT = ("split_gain", "internal_value", "internal_weight",
               "leaf_value", "leaf_weight")


def meta_from_numpy(fields: dict, device):
    """``DeviceMeta`` from numpy fields (a reference ``DeviceMeta``'s work,
    EFB and categorical fields included; absent ones mean an unbundled
    dataset without categorical features)."""
    from .core.meta import DeviceMeta
    F = len(fields["num_bins"])
    fields = {"is_categorical": np.zeros(F, bool),
              "feat2phys": np.arange(F, dtype=np.int32),
              "feat_offset": np.zeros(F, np.int32),
              "needs_fix": np.zeros(F, bool),
              **{k: v for k, v in fields.items() if v is not None}}
    out = {}
    for name in _META_FIELDS:
        dtype = _META_DTYPES.get(name, torch.int32)
        out[name] = torch.tensor(np.asarray(fields[name])).to(
            device=device, dtype=dtype)
    return DeviceMeta(**out)


def tree_arrays_from_numpy(d: dict, device):
    """``TreeArrays`` of tensors from numpy fields (a reference
    ``TreeArrays``' ``_asdict()`` works).  Categorical bitsets (uint32
    words, or int32 ones holding their bits) are kept as int32 words of
    the same bits; absent ones are empty."""
    from .core.grower import TreeArrays
    out = {}
    for name in _TREE_INT:
        out[name] = torch.tensor(np.asarray(d[name], np.int32)).to(device)
    for name in _TREE_FLOAT:
        out[name] = torch.tensor(np.asarray(d[name], np.float32)).to(device)
    out["default_left"] = torch.tensor(
        np.asarray(d["default_left"], bool)).to(device)
    n = len(np.asarray(d["split_feature"]))
    bits = np.asarray(d.get("cat_bitset", np.zeros((n, 0), np.uint32)))
    out["cat_bitset"] = torch.tensor(
        bits.astype(np.uint32).view(np.int32).reshape(n, -1)).to(device)
    return TreeArrays(**out)


def tree_arrays_to_numpy(t) -> dict:
    """numpy fields of a ``TreeArrays`` (the inverse of the above: the
    bitsets back as uint32 words)."""
    out = {k: np.asarray(v.detach().cpu().numpy() if torch.is_tensor(v)
                         else v)
           for k, v in t._asdict().items()}
    out["cat_bitset"] = out["cat_bitset"].astype(np.int32).view(np.uint32)
    return out


def bundle_from_numpy(bundle):
    """The port's ``BundleInfo`` from the reference's (or any object with
    its fields); None stays None."""
    if bundle is None:
        return None
    from .io.bundling import BundleInfo
    return BundleInfo(
        feat2phys=np.asarray(bundle.feat2phys, np.int32),
        feat_offset=np.asarray(bundle.feat_offset, np.int32),
        needs_fix=np.asarray(bundle.needs_fix, bool),
        num_phys=int(bundle.num_phys),
        phys_num_bin=np.asarray(bundle.phys_num_bin, np.int32),
        groups=[list(map(int, g)) for g in bundle.groups])


def dataset_from_numpy(X_bin: np.ndarray, mapper_state: Sequence[dict],
                       feature_names: List[str] = None, bundle=None):
    """A ``BinnedDataset`` from a binned matrix [N, F_phys] (uint8, or
    uint16 with a feature of more than 256 bins), one mapper state per
    ORIGINAL column (``BinMapper.to_dict()``, trivial and categorical
    columns included) and, for a bundled matrix, the reference's
    ``BundleInfo``."""
    from .io.binning import BinMapper
    from .io.dataset import BinnedDataset, Metadata
    ds = BinnedDataset()
    ds.bin_mappers = [BinMapper.from_dict(m) for m in mapper_state]
    ds.num_total_features = len(ds.bin_mappers)
    ds.feature_names = (list(feature_names) if feature_names
                        else [f"Column_{i}" for i in range(ds.num_total_features)])
    ds._finalize_features()
    ds.bundle = bundle_from_numpy(bundle)
    X_bin = np.ascontiguousarray(X_bin)
    cols, dtype = ds._bin_matrix_spec()
    if X_bin.dtype != dtype or X_bin.shape[1] != cols:
        log.fatal(f"X_bin must be {np.dtype(dtype).name} [N, {cols}], got "
                  f"{X_bin.dtype} {X_bin.shape}")
    ds.X_bin = X_bin
    ds.num_data = X_bin.shape[0]
    ds.metadata = Metadata(ds.num_data)
    return ds
