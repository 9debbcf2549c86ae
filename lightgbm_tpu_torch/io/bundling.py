"""Exclusive Feature Bundling (EFB): host-side bundle construction
(counterpart of lightgbm_tpu/io/bundling.py; reference:
src/io/dataset.cpp:41-263, GetConflictCount :51, FindGroups :91,
FastFeatureBundling :169).

Mutually exclusive sparse features (rarely non-default in the same row)
share one physical ``X_bin`` column, so K1 histograms F_phys < F columns.
A bundle's physical bins:

- physical bin 0 = every member at its default (zero) bin;
- member i owns [offset_i, offset_i + num_bin_i); its feature bin b is
  stored as ``offset_i + b`` wherever ``b != default_bin_i``.

A row whose physical bin falls outside a member's range is at that
member's default bin; the default bin's histogram mass is rebuilt from
the leaf totals (``core/histogram.py fix_default_bins``, the reference's
Dataset::FixHistogram).  Two members non-default in one row (a conflict)
keep the later member's value, EFB's approximation, bounded by
``max_conflict_rate``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import numpy as np

from ..utils import log
from .binning import BIN_NUMERICAL


@dataclass
class BundleInfo:
    """Feature -> physical-column mapping of a constructed dataset."""
    feat2phys: np.ndarray       # i32 [F_inner] physical column per feature
    feat_offset: np.ndarray     # i32 [F_inner] bin offset inside the column
    needs_fix: np.ndarray       # bool [F_inner] default-bin mass elided
    num_phys: int
    phys_num_bin: np.ndarray    # i32 [num_phys] bins used per column
    groups: List[List[int]] = field(default_factory=list)

    @classmethod
    def identity(cls, nbins: np.ndarray) -> "BundleInfo":
        F = len(nbins)
        return cls(feat2phys=np.arange(F, dtype=np.int32),
                   feat_offset=np.zeros(F, dtype=np.int32),
                   needs_fix=np.zeros(F, dtype=bool), num_phys=F,
                   phys_num_bin=np.asarray(nbins, dtype=np.int32),
                   groups=[[i] for i in range(F)])

    @property
    def is_trivial(self) -> bool:
        return (self.num_phys == len(self.feat2phys)
                and not self.needs_fix.any())


# a feature at its default bin in fewer of the sample's rows than this
# share stays alone (the reference's FindGroups threshold)
SPARSE_THRESHOLD = 0.8


def find_groups(nonzero_idx: List[np.ndarray], nbins: List[int],
                sparse_rates: List[float], total_sample: int,
                max_conflict_rate: float,
                sparse_threshold: float = SPARSE_THRESHOLD,
                max_bins_per_group: int = 256,
                max_search_group: int = 128) -> List[List[int]]:
    """Greedy conflict-budgeted grouping over the row sample (reference:
    FindGroups, dataset.cpp:91-167).  ``nonzero_idx[i]``: the sample rows
    where feature i is not at its default bin.  Features with a sparse
    rate below ``sparse_threshold`` stay alone; the rest are visited in
    descending non-default count, and each joins the first of the last
    ``max_search_group`` groups with room for its bins and its conflicts."""
    F = len(nonzero_idx)
    budget_total = int(max_conflict_rate * total_sample)
    candidates = [i for i in range(F) if sparse_rates[i] >= sparse_threshold]
    cand_set = set(candidates)
    dense = [i for i in range(F) if i not in cand_set]

    order = sorted(candidates, key=lambda i: -len(nonzero_idx[i]))
    group_masks: List[np.ndarray] = []  # bool [S] per group
    group_bins: List[int] = []
    group_conflicts: List[int] = []
    groups: List[List[int]] = []
    # ~512 MB of group masks at most; past it a feature that finds no
    # group stays alone
    mask_cap = max(8, (512 << 20) // max(total_sample, 1))
    singles: List[List[int]] = []
    for i in order:
        ii = nonzero_idx[i]
        placed = False
        lo = max(0, len(groups) - max_search_group)
        for gi in range(lo, len(groups)):
            # bin 0 is the shared all-default bin
            if group_bins[gi] + nbins[i] > max_bins_per_group:
                continue
            conflicts = int(group_masks[gi][ii].sum())
            if group_conflicts[gi] + conflicts <= budget_total:
                groups[gi].append(i)
                group_masks[gi][ii] = True
                group_bins[gi] += nbins[i]
                group_conflicts[gi] += conflicts
                placed = True
                break
        if not placed:
            if len(group_masks) >= mask_cap:
                singles.append([i])
                continue
            m = np.zeros(total_sample, bool)
            m[ii] = True
            groups.append([i])
            group_masks.append(m)
            group_bins.append(1 + nbins[i])
            group_conflicts.append(0)
    return groups + singles + [[i] for i in dense]


def build_bundles(mappers, used_features: np.ndarray, sample: np.ndarray,
                  total_rows: int, max_conflict_rate: float,
                  max_bins_per_group: int = 256) -> BundleInfo:
    """The bundle mapping from the bin-finding row sample.  ``mappers``:
    every column's ``BinMapper``; ``used_features``: the original indices
    of the non-trivial features (inner order); ``sample``: [S, P] raw
    values, a dense array or a scipy sparse matrix (only its stored
    entries can be non-default, so the masks come from its CSC columns)."""
    F = len(used_features)
    nbins = [mappers[int(j)].num_bin for j in used_features]
    if F < 2:
        return BundleInfo.identity(np.asarray(nbins))
    S = sample.shape[0]
    sample_csc = sample.tocsc() if hasattr(sample, "tocsc") else None
    idxs, rates = [], []
    for j in used_features:
        m = mappers[int(j)]
        if sample_csc is None and m.bin_type == BIN_NUMERICAL \
                and m.sparse_rate < SPARSE_THRESHOLD \
                and not np.isnan(sample[:, int(j)]).any():
            # without NaN, the sample rows a numerical feature's values
            # put in its default bin are the share its mapper counted,
            # at most ``sparse_rate``: a dense feature, never a candidate,
            # whose rows need not be binned again
            idxs.append(np.zeros(0, np.int64))
            rates.append(m.sparse_rate)
            continue
        if sample_csc is not None:
            lo, hi = sample_csc.indptr[int(j)], sample_csc.indptr[int(j) + 1]
            fb = np.asarray(m.value_to_bin(sample_csc.data[lo:hi]))
            nz_idx = np.asarray(sample_csc.indices[lo:hi][fb != m.default_bin])
        else:
            fb = m.value_to_bin(sample[:, int(j)])
            nz_idx = np.flatnonzero(np.asarray(fb) != m.default_bin)
        idxs.append(nz_idx)
        rates.append(1.0 - float(len(nz_idx)) / max(S, 1))

    groups = find_groups(idxs, nbins, rates, S, max_conflict_rate,
                         max_bins_per_group=max_bins_per_group)
    if all(len(g) <= 1 for g in groups):
        return BundleInfo.identity(np.asarray(nbins))

    feat2phys = np.zeros(F, np.int32)
    feat_offset = np.zeros(F, np.int32)
    needs_fix = np.zeros(F, bool)
    phys_num_bin = []
    for gp, members in enumerate(groups):
        if len(members) == 1:
            i = members[0]
            feat2phys[i] = gp
            phys_num_bin.append(nbins[i])
        else:
            off = 1  # bin 0 = all-default
            for i in members:
                feat2phys[i] = gp
                feat_offset[i] = off
                needs_fix[i] = True
                off += nbins[i]
            phys_num_bin.append(off)
    n_bundled = sum(len(g) for g in groups if len(g) > 1)
    log.info("EFB: bundled %d sparse features into %d columns "
             "(%d physical columns total, was %d)",
             n_bundled, sum(1 for g in groups if len(g) > 1),
             len(groups), F)
    return BundleInfo(feat2phys=feat2phys, feat_offset=feat_offset,
                      needs_fix=needs_fix, num_phys=len(groups),
                      phys_num_bin=np.asarray(phys_num_bin, np.int32),
                      groups=groups)


def encode_column(bundle: BundleInfo, members: List[int],
                  feat_bins: List[np.ndarray], default_bins: List[int],
                  n: int, dtype) -> np.ndarray:
    """One multi-member physical column from its members' feature bins."""
    col = np.zeros(n, dtype=dtype)
    for i, fb, db in zip(members, feat_bins, default_bins):
        nz = fb != db
        col[nz] = (bundle.feat_offset[i] + fb[nz]).astype(dtype)
    return col
