"""Feature binning: value -> bin mapping (counterpart of
lightgbm_tpu/io/binning.py, numeric features).

The algorithm is the reference's ``BinMapper`` (reference:
include/LightGBM/bin.h:65-222, src/io/bin.cpp:78-529): greedy near-equal-
count bin boundaries over a value sample, zero isolated in its own bin,
user-forced bounds, and the three missing modes {None, Zero, NaN}.  The
g++ fast path (``native/``) runs where the JAX package takes its own, and
the numpy path stays as its fallback; both produce the JAX package's bins
byte for byte.  Categorical features map count-ordered categories to bins
(reference: bin.cpp:424-497).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np

from .. import native as _native
from ..utils import log

# Values in (-kZeroThreshold, kZeroThreshold] are "zero"
# (reference: include/LightGBM/meta.h:53).
K_ZERO_THRESHOLD = 1e-35

MISSING_NONE = 0
MISSING_ZERO = 1
MISSING_NAN = 2

BIN_NUMERICAL = 0
BIN_CATEGORICAL = 1

def _upper_bound(v: float) -> float:
    """Smallest double strictly greater than v (reference: Common::GetDoubleUpperBound)."""
    return float(np.nextafter(v, np.inf))


def _close_ordered(a: float, b: float) -> bool:
    """b <= nextafter(a, inf) (reference: Common::CheckDoubleEqualOrdered)."""
    return b <= np.nextafter(a, np.inf)


def greedy_find_bin(distinct_values: np.ndarray, counts: np.ndarray, max_bin: int,
                    total_cnt: int, min_data_in_bin: int) -> List[float]:
    """Greedy near-equal-count bin upper bounds over sorted distinct values
    (reference: GreedyFindBin, bin.cpp:78-155).  Returns ascending upper
    bounds; the last is +inf.  The loop runs over Python lists: the same
    arithmetic as the reference package's numpy-scalar loop, faster."""
    if _native.lib() is not None:
        return _native.greedy_find_bin(distinct_values, counts, max_bin,
                                       total_cnt, min_data_in_bin)
    n = len(distinct_values)
    if n == 0:
        return [math.inf]
    values = np.asarray(distinct_values, np.float64).tolist()
    cnts = np.asarray(counts, np.int64).tolist()
    bounds: List[float] = []
    if n <= max_bin:
        cur = 0
        for i in range(n - 1):
            cur += cnts[i]
            if cur >= min_data_in_bin:
                val = _upper_bound((values[i] + values[i + 1]) / 2.0)
                if not bounds or not _close_ordered(bounds[-1], val):
                    bounds.append(val)
                    cur = 0
        bounds.append(math.inf)
        return bounds

    if min_data_in_bin > 0:
        max_bin = max(1, min(max_bin, total_cnt // min_data_in_bin))
    mean_size = total_cnt / max_bin
    is_big = [c >= mean_size for c in cnts]
    rest_bins = max_bin - sum(is_big)
    rest_cnt = total_cnt - sum(c for c, b in zip(cnts, is_big) if b)
    mean_size = rest_cnt / rest_bins if rest_bins > 0 else math.inf

    uppers: List[float] = []
    lowers: List[float] = [values[0]]
    cur = 0
    for i in range(n - 1):
        if not is_big[i]:
            rest_cnt -= cnts[i]
        cur += cnts[i]
        if (is_big[i] or cur >= mean_size
                or (is_big[i + 1] and cur >= max(1.0, mean_size * 0.5))):
            uppers.append(values[i])
            lowers.append(values[i + 1])
            if len(uppers) >= max_bin - 1:
                break
            cur = 0
            if not is_big[i]:
                rest_bins -= 1
                mean_size = rest_cnt / rest_bins if rest_bins > 0 else math.inf
    for i in range(len(uppers)):
        val = _upper_bound((uppers[i] + lowers[i + 1]) / 2.0)
        if not bounds or not _close_ordered(bounds[-1], val):
            bounds.append(val)
    bounds.append(math.inf)
    return bounds


def find_bin_with_zero_as_one_bin(distinct_values: np.ndarray, counts: np.ndarray,
                                  max_bin: int, total_cnt: int,
                                  min_data_in_bin: int) -> List[float]:
    """Bin bounds with zero guaranteed its own bin: negative side and positive
    side are binned independently around (-eps, eps]
    (reference: FindBinWithZeroAsOneBin, bin.cpp:256-312)."""
    neg = distinct_values <= -K_ZERO_THRESHOLD
    pos = distinct_values > K_ZERO_THRESHOLD
    zero_cnt = int(counts[~neg & ~pos].sum())
    left_cnt_data = int(counts[neg].sum())
    right_cnt_data = int(counts[pos].sum())
    n_left = int(neg.sum())

    bounds: List[float] = []
    if n_left > 0 and max_bin > 1:
        denom = max(total_cnt - zero_cnt, 1)
        left_max_bin = max(1, int(left_cnt_data / denom * (max_bin - 1)))
        bounds = greedy_find_bin(distinct_values[:n_left], counts[:n_left],
                                 left_max_bin, left_cnt_data, min_data_in_bin)
        if bounds:
            bounds[-1] = -K_ZERO_THRESHOLD

    right_start = None
    idx = np.nonzero(pos)[0]
    if len(idx) > 0:
        right_start = int(idx[0])
    right_max_bin = max_bin - 1 - len(bounds)
    if right_start is not None and right_max_bin > 0:
        right = greedy_find_bin(distinct_values[right_start:], counts[right_start:],
                                right_max_bin, right_cnt_data, min_data_in_bin)
        bounds.append(K_ZERO_THRESHOLD)
        bounds.extend(right)
    else:
        bounds.append(math.inf)
    return bounds


def find_bin_with_predefined_bounds(distinct_values: np.ndarray,
                                    counts: np.ndarray, max_bin: int,
                                    total_cnt: int, min_data_in_bin: int,
                                    forced_bounds: Sequence[float]
                                    ) -> List[float]:
    """Forced-bounds variant: the user's bounds are fixed, the remaining
    bin budget is spread across the gaps in proportion to their sample
    mass (reference: FindBinWithPredefinedBin, bin.cpp:157-254)."""
    neg = distinct_values <= -K_ZERO_THRESHOLD
    pos = distinct_values > K_ZERO_THRESHOLD
    n_left = int(neg.sum())
    has_right = bool(pos.any())

    bounds: List[float] = []
    if max_bin == 2:
        bounds.append(K_ZERO_THRESHOLD if n_left == 0 else -K_ZERO_THRESHOLD)
    elif max_bin >= 3:
        if n_left > 0:
            bounds.append(-K_ZERO_THRESHOLD)
        if has_right:
            bounds.append(K_ZERO_THRESHOLD)
    bounds.append(math.inf)

    max_to_insert = max_bin - len(bounds)
    inserted = 0
    for b in forced_bounds:
        if inserted >= max_to_insert:
            break
        if abs(b) > K_ZERO_THRESHOLD:
            bounds.append(float(b))
            inserted += 1
    bounds.sort()

    free_bins = max_bin - len(bounds)
    to_add: List[float] = []
    value_ind = 0
    n = len(distinct_values)
    for i, ub in enumerate(bounds):
        cnt_in_bin = 0
        bin_start = value_ind
        while value_ind < n and distinct_values[value_ind] < ub:
            cnt_in_bin += int(counts[value_ind])
            value_ind += 1
        bins_remaining = max_bin - len(bounds) - len(to_add)
        num_sub_bins = int(round(cnt_in_bin * free_bins / max(total_cnt, 1)))
        num_sub_bins = min(num_sub_bins, bins_remaining) + 1
        if i == len(bounds) - 1:
            num_sub_bins = bins_remaining + 1
        sub = greedy_find_bin(distinct_values[bin_start:value_ind],
                              counts[bin_start:value_ind],
                              num_sub_bins, cnt_in_bin, min_data_in_bin)
        to_add.extend(sub[:-1])  # the last bound is inf
    bounds.extend(to_add)
    bounds.sort()
    return bounds


def _distinct_with_zero(values: np.ndarray, zero_cnt: int):
    """Sorted distinct values + counts, with the implicit zeros inserted at
    their ordered position (reference: BinMapper::FindBin, bin.cpp:353-389).
    ``values`` excludes zeros and NaNs.

    Vectorized form of the reference package's loop: that loop merges a
    value into the previous group when ``v <= nextafter(prev, inf)``,
    where ``prev`` is always the previous sorted value, so groups break
    exactly where ``v[i] > nextafter(v[i-1], inf)`` and each group keeps
    its last value.  The zero bin goes between the last negative and the
    first positive group (even with a zero count, as the loop does), or
    at either end when all values share one sign and zeros exist."""
    values = np.sort(values.astype(np.float64), kind="stable")
    if _native.lib() is not None:
        return _native.distinct_with_zero(values, zero_cnt)
    n = len(values)
    if n == 0:
        return np.array([0.0]), np.array([zero_cnt], dtype=np.int64)
    brk = values[1:] > np.nextafter(values[:-1], np.inf)
    starts = np.flatnonzero(np.concatenate([[True], brk]))
    stops = np.concatenate([starts[1:], [n]])
    distinct = values[stops - 1]
    counts = (stops - starts).astype(np.int64)
    first = values[starts]
    cross = np.flatnonzero((distinct[:-1] < 0.0) & (first[1:] > 0.0))
    if len(cross):
        k = int(cross[0]) + 1
        distinct = np.insert(distinct, k, 0.0)
        counts = np.insert(counts, k, zero_cnt)
    elif values[0] > 0.0 and zero_cnt > 0:
        distinct = np.insert(distinct, 0, 0.0)
        counts = np.insert(counts, 0, zero_cnt)
    elif values[-1] < 0.0 and zero_cnt > 0:
        distinct = np.append(distinct, 0.0)
        counts = np.append(counts, zero_cnt)
    return distinct, counts


class BinMapper:
    """Per-feature value<->bin mapping (reference: BinMapper, bin.h:65)."""

    def __init__(self):
        self.num_bin: int = 1
        self.missing_type: int = MISSING_NONE
        self.is_trivial: bool = True
        self.sparse_rate: float = 1.0
        self.bin_type: int = BIN_NUMERICAL
        self.min_val: float = 0.0
        self.max_val: float = 0.0
        self.bin_upper_bound: np.ndarray = np.array([np.inf])
        self.bin_2_categorical: List[int] = []
        self.categorical_2_bin: Dict[int, int] = {}
        self.default_bin: int = 0
        self.most_freq_bin: int = 0

    def find_bin(self, values: np.ndarray, total_sample_cnt: int, max_bin: int,
                 min_data_in_bin: int = 3, min_split_data: int = 20,
                 use_missing: bool = True,
                 zero_as_missing: bool = False,
                 forced_bounds: Optional[Sequence[float]] = None,
                 bin_type: int = BIN_NUMERICAL) -> None:
        """Build the mapping from a value sample. ``values`` excludes zeros;
        ``total_sample_cnt - len(values)`` are implicit zeros;
        ``forced_bounds`` are the user's bounds for a numerical feature
        (reference: BinMapper::FindBin, bin.cpp:325)."""
        values = np.asarray(values, dtype=np.float64)
        nan_mask = np.isnan(values)
        na_cnt = int(nan_mask.sum())
        values = values[~nan_mask]
        if not use_missing:
            self.missing_type = MISSING_NONE
        elif zero_as_missing:
            self.missing_type = MISSING_ZERO
        else:
            self.missing_type = MISSING_NAN if na_cnt > 0 else MISSING_NONE

        self.bin_type = bin_type
        self.default_bin = 0
        zero_cnt = int(total_sample_cnt - len(values) - na_cnt)
        distinct, counts = _distinct_with_zero(values, zero_cnt)
        self.min_val = float(distinct[0])
        self.max_val = float(distinct[-1])

        if bin_type == BIN_CATEGORICAL:
            cnt_in_bin = self._find_bin_categorical(
                distinct, counts, total_sample_cnt, na_cnt, max_bin,
                min_data_in_bin)
        else:
            if self.missing_type == MISSING_NAN:
                eff_max_bin, eff_total = max_bin - 1, total_sample_cnt - na_cnt
            else:
                eff_max_bin, eff_total = max_bin, total_sample_cnt
            if forced_bounds:
                bounds = find_bin_with_predefined_bounds(
                    distinct, counts, eff_max_bin, eff_total,
                    min_data_in_bin, list(forced_bounds))
            else:
                bounds = find_bin_with_zero_as_one_bin(
                    distinct, counts, eff_max_bin, eff_total, min_data_in_bin)
            if self.missing_type == MISSING_ZERO and len(bounds) == 2:
                self.missing_type = MISSING_NONE
            if self.missing_type == MISSING_NAN:
                bounds.append(math.nan)
            self.bin_upper_bound = np.asarray(bounds)
            self.num_bin = len(bounds)
            # each distinct value lands in the first bin whose upper bound
            # is >= it (bounds ascend; the count loop of the reference)
            n_num = (self.num_bin - 1 if self.missing_type == MISSING_NAN
                     else self.num_bin)
            which = np.searchsorted(self.bin_upper_bound[:n_num - 1],
                                    distinct, side="left")
            cnt_in_bin = np.bincount(
                which, weights=counts, minlength=self.num_bin).astype(np.int64)
            if self.missing_type == MISSING_NAN:
                cnt_in_bin[-1] = na_cnt
            log.check(self.num_bin <= max_bin, "num_bin exceeds max_bin")

        self.is_trivial = self.num_bin <= 1
        if not self.is_trivial and self._need_filter(cnt_in_bin, total_sample_cnt,
                                                     min_split_data):
            self.is_trivial = True
        if not self.is_trivial:
            self.default_bin = int(self.value_to_bin(0.0))
            if bin_type == BIN_CATEGORICAL:
                log.check(self.default_bin > 0,
                          "categorical default_bin must be > 0")
            self.most_freq_bin = int(np.argmax(cnt_in_bin))
            self.sparse_rate = float(cnt_in_bin[self.default_bin]) / max(total_sample_cnt, 1)
            max_rate = float(cnt_in_bin[self.most_freq_bin]) / max(total_sample_cnt, 1)
            if self.most_freq_bin != self.default_bin and max_rate > 0.7:
                self.sparse_rate = max_rate
            else:
                self.most_freq_bin = self.default_bin
        else:
            self.sparse_rate = 1.0

    def _find_bin_categorical(self, distinct, counts, total_sample_cnt,
                              na_cnt, max_bin, min_data_in_bin):
        """Count-ordered categorical mapping; rare categories and negatives
        go to the NaN bin (reference: bin.cpp:424-497)."""
        vals_int: List[int] = []
        counts_int: List[int] = []
        for v, c in zip(distinct, counts):
            iv = int(v)
            if iv < 0:
                na_cnt += int(c)
                log.warning("Met negative value in categorical features, "
                            "converting to NaN")
            elif vals_int and iv == vals_int[-1]:
                counts_int[-1] += int(c)
            else:
                vals_int.append(iv)
                counts_int.append(int(c))
        self.num_bin = 0
        cnt_in_bin: List[int] = []
        rest_cnt = total_sample_cnt - na_cnt
        if rest_cnt > 0 and vals_int:
            order = np.argsort(np.asarray(counts_int), kind="stable")[::-1]
            vals_sorted = [vals_int[i] for i in order]
            cnts_sorted = [counts_int[i] for i in order]
            # bin 0 must not be category 0 (0 is the default value)
            if vals_sorted[0] == 0:
                if len(vals_sorted) == 1:
                    vals_sorted.append(vals_sorted[0] + 1)
                    cnts_sorted.append(0)
                vals_sorted[0], vals_sorted[1] = vals_sorted[1], vals_sorted[0]
                cnts_sorted[0], cnts_sorted[1] = cnts_sorted[1], cnts_sorted[0]
            cut_cnt = int((total_sample_cnt - na_cnt) * 0.99)
            eff_max_bin = min(len(vals_sorted), max_bin)
            self.categorical_2_bin = {}
            self.bin_2_categorical = []
            used_cnt = 0
            cur = 0
            while cur < len(vals_sorted) and (used_cnt < cut_cnt
                                              or self.num_bin < eff_max_bin):
                if cnts_sorted[cur] < min_data_in_bin and cur > 1:
                    break
                self.bin_2_categorical.append(vals_sorted[cur])
                self.categorical_2_bin[vals_sorted[cur]] = self.num_bin
                used_cnt += cnts_sorted[cur]
                cnt_in_bin.append(cnts_sorted[cur])
                self.num_bin += 1
                cur += 1
            if cur == len(vals_sorted) and na_cnt > 0:
                self.bin_2_categorical.append(-1)
                self.categorical_2_bin[-1] = self.num_bin
                cnt_in_bin.append(0)
                self.num_bin += 1
            self.missing_type = (MISSING_NONE if cur == len(vals_sorted)
                                 and na_cnt == 0 else MISSING_NAN)
            if cnt_in_bin:
                cnt_in_bin[-1] += total_sample_cnt - used_cnt
        return np.asarray(cnt_in_bin, dtype=np.int64)

    def _need_filter(self, cnt_in_bin: np.ndarray, total_cnt: int,
                     filter_cnt: int) -> bool:
        """True if no split on this feature could satisfy min_data_in_leaf
        on both sides (reference: NeedFilter, bin.cpp:54-76): a numerical
        feature at every boundary, a categorical one only with <= 2 bins,
        one bin at a time."""
        if self.bin_type != BIN_NUMERICAL and len(cnt_in_bin) > 2:
            return False
        left = (np.cumsum(cnt_in_bin[:-1]) if self.bin_type == BIN_NUMERICAL
                else np.asarray(cnt_in_bin[:-1]))
        return not bool(np.any((left >= filter_cnt)
                               & (total_cnt - left >= filter_cnt)))

    def value_to_bin(self, value) -> np.ndarray:
        """Vectorized value->bin (reference: BinMapper::ValueToBin, bin.h:472)."""
        scalar = np.isscalar(value)
        v = np.atleast_1d(np.asarray(value, dtype=np.float64))
        if self.bin_type == BIN_CATEGORICAL:
            # NaN reads as category 0 unless the NaN bin exists
            # (reference: bin.h:473-478); unmatched values take the last bin
            res = self._categories_to_bins(
                np.where(np.isnan(v) & (self.missing_type != MISSING_NAN),
                         0.0, v), self.num_bin - 1)
            return int(res[0]) if scalar else res
        n_search = self.num_bin - (1 if self.missing_type == MISSING_NAN else 0)
        if _native.lib() is not None and v.ndim == 1 and len(v) > 1024:
            res = _native.binarize_numerical(
                v, self.bin_upper_bound, n_search - 1, self.missing_type,
                self.num_bin)
            return int(res[0]) if scalar else res
        nan = np.isnan(v)
        vv = np.where(nan, 0.0, v)
        # first bin i with value <= bin_upper_bound[i]; bounds ascend and
        # the last searchable bound is +inf, so the result is < n_search
        out = np.searchsorted(self.bin_upper_bound[:n_search - 1], vv,
                              side="left")
        if self.missing_type == MISSING_NAN:
            out = np.where(nan, self.num_bin - 1, out)
        res = out.astype(np.int32)
        return int(res[0]) if scalar else res

    def _categories_to_bins(self, v: np.ndarray, other: int) -> np.ndarray:
        """Each value's category bin (the value cast to int) through a
        table over the category range, ``other`` where the category has
        no bin; NaN reads as category -1."""
        res = np.full(v.shape, other, dtype=np.int32)
        cats = np.asarray([c for c in self.categorical_2_bin if c >= 0],
                          np.int64)
        iv = np.where(np.isnan(v), -1, v).astype(np.int64)
        if len(cats):
            table = np.full(int(cats.max()) + 1, other, np.int32)
            table[cats] = [self.categorical_2_bin[int(c)] for c in cats]
            ok = (iv >= 0) & (iv < len(table))
            res[ok] = table[iv[ok]]
        if -1 in self.categorical_2_bin:
            res[iv == -1] = self.categorical_2_bin[-1]
        return res

    def value_to_bin_predict(self, value, sentinel: int) -> np.ndarray:
        """Prediction-time value->bin of a CATEGORICAL feature: NaN,
        negative and unseen categories map to ``sentinel``, a bin outside
        every node's bitset, so bin-space traversal routes them right, as
        the reference's CategoricalDecision does (tree.h:262-303)."""
        v = np.atleast_1d(np.asarray(value, dtype=np.float64))
        res = np.full(v.shape, sentinel, dtype=np.int32)
        ok = ~np.isnan(v) & (v >= 0)
        cats = np.asarray([c for c in self.categorical_2_bin if c >= 0],
                          np.int64)
        if len(cats):
            iv = np.where(ok, v, -1).astype(np.int64)
            table = np.full(int(cats.max()) + 1, sentinel, np.int32)
            table[cats] = [self.categorical_2_bin[int(c)] for c in cats]
            inside = (iv >= 0) & (iv < len(table))
            res[inside] = table[iv[inside]]
        return res

    @classmethod
    def from_thresholds(cls, thresholds, missing_type: int = MISSING_NONE
                        ) -> "BinMapper":
        """A numerical mapper built from a forest's split thresholds instead
        of a data sample (serve/packing.py).

        Traversal only needs every node's decision reproduced: with the
        sorted distinct thresholds as bin upper bounds, ``value_to_bin(v)
        <= value_to_bin(thr)`` holds exactly when ``v <= thr`` for every
        threshold of the set, so bin-space compares equal the host's
        value-space ones.  Under MISSING_ZERO the zero value gets its own
        bin (bounds at +-kZeroThreshold, reference: meta.h:53) so only
        "zero" rows take the default-left route; under MISSING_NAN the
        trailing NaN bin is appended like ``find_bin``'s."""
        m = cls()
        vals = np.unique(np.asarray(thresholds, dtype=np.float64))
        vals = vals[np.isfinite(vals)]
        if missing_type == MISSING_ZERO:
            vals = np.unique(np.concatenate(
                [vals, [-K_ZERO_THRESHOLD, K_ZERO_THRESHOLD]]))
        bounds = list(vals) + [math.inf]
        if missing_type == MISSING_NAN:
            bounds.append(math.nan)
        m.bin_upper_bound = np.asarray(bounds, dtype=np.float64)
        m.num_bin = len(bounds)
        m.missing_type = int(missing_type)
        m.bin_type = BIN_NUMERICAL
        m.is_trivial = False
        if len(vals):
            m.min_val, m.max_val = float(vals[0]), float(vals[-1])
        m.default_bin = int(m.value_to_bin(0.0))
        m.most_freq_bin = m.default_bin
        m.sparse_rate = 0.0
        return m

    @classmethod
    def categorical_from_categories(cls, categories) -> "BinMapper":
        """Model-derived CATEGORICAL mapper (the reference package's
        ``BinMapper.categorical_from_categories``): the bins are the
        category values the forest's bitsets reference, plus a trailing
        NaN/unseen bin that no bitset contains.  Bin 0 is not category 0
        (``_find_bin_categorical``'s convention)."""
        m = cls()
        cats = sorted({int(c) for c in categories if int(c) >= 0})
        if not cats:
            return m  # trivial: the model references no category
        if cats[0] == 0:
            if len(cats) == 1:
                cats.append(1)
            cats[0], cats[1] = cats[1], cats[0]
        cats.append(-1)  # NaN / unseen catch-all, never in a bitset
        m.bin_2_categorical = cats
        m.categorical_2_bin = {c: i for i, c in enumerate(cats)}
        m.num_bin = len(cats)
        m.bin_type = BIN_CATEGORICAL
        m.missing_type = MISSING_NAN
        m.is_trivial = False
        m.sparse_rate = 0.0
        m.min_val = float(min(c for c in cats if c >= 0))
        m.max_val = float(max(cats))
        m.default_bin = int(m.value_to_bin(0.0))
        m.most_freq_bin = m.default_bin
        return m

    def to_dict(self) -> dict:
        """The mapper's state, as the reference package's ``to_dict``."""
        return {
            "num_bin": self.num_bin, "missing_type": self.missing_type,
            "is_trivial": self.is_trivial, "sparse_rate": self.sparse_rate,
            "bin_type": self.bin_type, "min_val": self.min_val,
            "max_val": self.max_val,
            "bin_upper_bound": [float(x) for x in self.bin_upper_bound],
            "bin_2_categorical": list(self.bin_2_categorical),
            "default_bin": self.default_bin,
            "most_freq_bin": self.most_freq_bin,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "BinMapper":
        """Mapper from the reference package's ``BinMapper.to_dict()``
        state."""
        m = cls()
        m.num_bin = int(d["num_bin"])
        m.missing_type = int(d["missing_type"])
        m.is_trivial = bool(d["is_trivial"])
        m.sparse_rate = float(d["sparse_rate"])
        m.bin_type = int(d["bin_type"])
        m.min_val = float(d["min_val"])
        m.max_val = float(d["max_val"])
        m.bin_upper_bound = np.asarray(d["bin_upper_bound"], dtype=np.float64)
        m.bin_2_categorical = [int(x) for x in d.get("bin_2_categorical", [])]
        m.categorical_2_bin = {c: i for i, c in enumerate(m.bin_2_categorical)}
        m.default_bin = int(d["default_bin"])
        m.most_freq_bin = int(d["most_freq_bin"])
        return m

    def bin_to_value(self, bin_idx: int) -> float:
        """A numerical bin's representative threshold (its upper bound), a
        categorical bin's category."""
        if self.bin_type == BIN_CATEGORICAL:
            return float(self.bin_2_categorical[bin_idx])
        return float(self.bin_upper_bound[bin_idx])
