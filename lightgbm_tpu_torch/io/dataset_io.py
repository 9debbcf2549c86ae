"""Binned-dataset files (counterpart of lightgbm_tpu/io/dataset_io.py;
reference: Dataset::SaveBinaryFile, dataset.h:416, and the loader's fast
path, dataset_loader.cpp:274).

A numpy archive instead of the reference's own binary layout, with the
JAX package's keys and magic string, so a file either package writes
loads in the other; the purpose is the reference's: skip text parsing and
binning on reload.
"""
from __future__ import annotations

import json

import numpy as np

from ..utils import log
from .binning import BinMapper
from .dataset import BinnedDataset, Metadata

MAGIC = "lightgbm_tpu.dataset.v1"


def save_dataset(ds: BinnedDataset, path) -> None:
    """Write ``ds`` to ``path`` (a file name, written as given, or an open
    binary file)."""
    meta = {
        "magic": MAGIC,
        "num_data": ds.num_data,
        "num_total_features": ds.num_total_features,
        "max_bin": ds.max_bin,
        "feature_names": ds.feature_names,
        "bin_mappers": [m.to_dict() for m in ds.bin_mappers],
    }
    arrays = {
        "X_bin": ds.X_bin,
        "used_feature_map": ds.used_feature_map,
        "real_feature_idx": ds.real_feature_idx,
        "bin_offsets": ds.bin_offsets,
    }
    if ds.bundle is not None:
        meta["bundle_groups"] = [[int(i) for i in g]
                                 for g in ds.bundle.groups]
        arrays["bundle_feat2phys"] = ds.bundle.feat2phys
        arrays["bundle_feat_offset"] = ds.bundle.feat_offset
        arrays["bundle_needs_fix"] = ds.bundle.needs_fix
        arrays["bundle_phys_num_bin"] = ds.bundle.phys_num_bin
    md = ds.metadata
    for name in ("label", "weights", "init_score"):
        v = getattr(md, name)
        if v is not None:
            arrays["md_" + name] = v
    if md.query_boundaries is not None:
        # per-query sizes: boundaries like [0, N] would read back as sizes
        arrays["md_query_sizes"] = np.diff(md.query_boundaries)
    if isinstance(path, (str, bytes)) or hasattr(path, "__fspath__"):
        with open(path, "wb") as fh:
            np.savez_compressed(fh, meta=json.dumps(meta), **arrays)
    else:
        np.savez_compressed(path, meta=json.dumps(meta), **arrays)


def is_dataset_file(path) -> bool:
    """Whether ``path`` is a binned-dataset archive (a zip file whose
    ``meta`` carries the magic string)."""
    try:
        with open(path, "rb") as fh:
            if fh.read(4) != b"PK\x03\x04":
                return False
        with np.load(path, allow_pickle=False) as z:
            return (json.loads(str(z["meta"])).get("magic") == MAGIC)
    except (OSError, ValueError, KeyError):
        return False


def load_dataset(path) -> BinnedDataset:
    """A ``BinnedDataset`` from a file ``save_dataset`` (of either
    package) wrote."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["meta"]))
        if meta.get("magic") != MAGIC:
            log.fatal(f"{path} is not a binned dataset file")
        ds = BinnedDataset()
        ds.num_data = int(meta["num_data"])
        ds.num_total_features = int(meta["num_total_features"])
        ds.max_bin = int(meta["max_bin"])
        ds.feature_names = list(meta["feature_names"])
        ds.bin_mappers = [BinMapper.from_dict(d) for d in meta["bin_mappers"]]
        ds.X_bin = z["X_bin"]
        ds.used_feature_map = z["used_feature_map"]
        ds.real_feature_idx = z["real_feature_idx"]
        ds.bin_offsets = z["bin_offsets"]
        if "bundle_feat2phys" in z:
            from .bundling import BundleInfo
            ds.bundle = BundleInfo(
                feat2phys=z["bundle_feat2phys"],
                feat_offset=z["bundle_feat_offset"],
                needs_fix=z["bundle_needs_fix"],
                num_phys=int(ds.X_bin.shape[1]),
                phys_num_bin=z["bundle_phys_num_bin"],
                groups=[list(g) for g in meta.get("bundle_groups", [])])
        ds.metadata = Metadata(ds.num_data)
        if "md_label" in z:
            ds.metadata.set_label(z["md_label"])
        if "md_weights" in z:
            ds.metadata.set_weights(z["md_weights"])
        if "md_query_sizes" in z:
            ds.metadata.set_query(z["md_query_sizes"])
        if "md_init_score" in z:
            ds.metadata.set_init_score(z["md_init_score"])
    return ds
