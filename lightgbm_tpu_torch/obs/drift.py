"""The model-quality and drift plane: reference profiles and streaming
sketches (counterpart of lightgbm_tpu/obs/drift.py, numpy like it, with
its sidecar format and ``drift_snapshot`` event).

- ``QualityProfile``: the reference distribution taken at training time,
  each feature's bin occupancy over the binned matrix (counted on the
  training device with ``torch.bincount``, then one copy to the host:
  :func:`device_occupancy`), the training raw-score histogram and the
  training AUC for binary labels.  ``Booster.save_model`` writes it beside
  the model as ``<model>.quality.json`` (``tpu_quality_profile``).
- ``DriftSketch``: the serving side's fixed-bucket histograms in the
  profile's bin space; integer adds under one lock, so sketches of
  replicas merge bit-exactly.
- ``DriftMonitor``: profile, sketch and cadence; every
  ``tpu_drift_check_s`` it scores the sketch against the profile (PSI and
  KS over equal-reference-mass groups of the fine bins), emits a
  ``drift_snapshot`` event and, past ``tpu_drift_psi_warn``, dumps the
  flight ring and latches a breach the registry's post-swap watch reads
  (a rollback signal only with ``tpu_serve_rollback_on_drift``).

``bin_features`` reproduces ``BinMapper.value_to_bin``'s numerical path
from the profile's searchable upper bounds, so a served raw row lands in
the bin its training row took; categorical features are left out of
feature drift.
"""
from __future__ import annotations

import json
import math
import os
import threading
import time
from typing import List, Optional

import numpy as np

from . import core
from .spans import flight_dump

PROFILE_SUFFIX = ".quality.json"

# prediction-histogram resolution: quantile edges of the training raw
# scores (equal-mass buckets make PSI sensitive at the distribution's
# bulk, where a shifted traffic mix actually moves mass)
PRED_BUCKETS = 32

# floor for PSI's log ratio — standard epsilon smoothing so an empty
# bucket on either side contributes a large-but-finite term
_PSI_EPS = 1e-6

# feature PSI/KS are scored on this many equal-reference-mass groups of
# the fine bins (decile-style), not the raw ~255-bin histograms: a
# sparse live sample leaves fine bins empty, and epsilon smoothing
# would read each empty bin as a large shift term — coarsening keeps
# PSI a traffic-shift signal at serve-realistic sample sizes
FEAT_PSI_BUCKETS = 16

# consecutive breach snapshots before a second flight dump (the monitor
# has its own cooldown beside the session's storm cooldown)
_DUMP_COOLDOWN_S = 60.0

# the monitor's hot path only APPENDS batch references; histogramming
# runs when this many rows are pending (or a cadence check / status
# read forces it) so the numpy fixed cost amortizes over many batches
_PEND_FLUSH_ROWS = 512


def profile_path(model_path: str) -> str:
    """Sidecar path convention: the profile lives beside the model file
    it describes, so registry deploys pick it up with no extra plumbing."""
    return str(model_path) + PROFILE_SUFFIX


def _knob(config, name: str, cast, default):
    """Config attr with LGBM_TPU_<NAME> env override (the leading
    ``tpu_`` of the param name folds into the prefix) — the serve-stack
    convention (serve/session.py _env_num)."""
    stem = name[4:] if name.startswith("tpu_") else name
    v = os.environ.get("LGBM_TPU_" + stem.upper())
    if v is not None:
        if cast is bool:  # bool("0") is True — parse the usual spellings
            return v.strip().lower() not in ("", "0", "false", "no", "off")
        try:
            return cast(v)
        except ValueError:
            pass
    return cast(getattr(config, name, default) if config is not None
                else default)


# ---------------------------------------------------------------------------
# distribution distances
# ---------------------------------------------------------------------------

def psi(p_counts, q_counts) -> float:
    """Population Stability Index between two aligned histograms:
    sum((p-q) * ln(p/q)) over normalized bucket masses, epsilon-smoothed.
    Rule of thumb: <0.1 stable, 0.1-0.25 moderate shift, >0.25 major."""
    p = np.asarray(p_counts, np.float64)
    q = np.asarray(q_counts, np.float64)
    ps, qs = p.sum(), q.sum()
    if ps <= 0 or qs <= 0:
        return 0.0
    p = np.maximum(p / ps, _PSI_EPS)
    q = np.maximum(q / qs, _PSI_EPS)
    return float(np.sum((p - q) * np.log(p / q)))


def coarsen(ref_counts, live_counts, buckets: int = FEAT_PSI_BUCKETS):
    """Regroup two aligned fine-bin histograms into ``buckets``
    contiguous groups of roughly equal REFERENCE mass (cuts come from
    the reference CDF, so both histograms regroup identically).  The
    fine bin space stays the sketch's storage format; scoring happens
    here, on the coarse view."""
    ref = np.asarray(ref_counts, np.float64)
    live = np.asarray(live_counts, np.float64)
    if len(ref) <= buckets:
        return ref, live
    total = ref.sum()
    if total <= 0:
        idx = np.linspace(0, len(ref), buckets + 1).astype(np.int64)
    else:
        cdf = np.cumsum(ref)
        targets = total * np.arange(1, buckets) / buckets
        cuts = np.searchsorted(cdf, targets, side="left") + 1
        idx = np.concatenate([[0], cuts, [len(ref)]])
    idx = np.unique(np.clip(idx, 0, len(ref)))
    if idx[-1] != len(ref):
        idx = np.append(idx, len(ref))
    return (np.add.reduceat(ref, idx[:-1]),
            np.add.reduceat(live, idx[:-1]))


def ks(p_counts, q_counts) -> float:
    """Kolmogorov-Smirnov statistic on aligned histograms: the max CDF
    gap.  Complements PSI — KS catches a concentrated shift PSI's
    log-ratio smears across buckets."""
    p = np.asarray(p_counts, np.float64)
    q = np.asarray(q_counts, np.float64)
    ps, qs = p.sum(), q.sum()
    if ps <= 0 or qs <= 0:
        return 0.0
    return float(np.max(np.abs(np.cumsum(p / ps) - np.cumsum(q / qs))))


# ---------------------------------------------------------------------------
# reference-profile capture (train / ingest side)
# ---------------------------------------------------------------------------

def init_occupancy(ds) -> List[np.ndarray]:
    """One int64 count vector per used (inner) feature, sized by the
    feature's BinMapper — the accumulator ``accumulate_occupancy``
    fills.  Streaming ingestion allocates this before pass 2."""
    return [np.zeros(ds.inner_to_mapper(i).num_bin, np.int64)
            for i in range(ds.num_features)]


def accumulate_occupancy(ds, acc: List[np.ndarray], row0: int,
                         nrows: int) -> None:
    """Fold rows ``[row0, row0+nrows)`` of the already-binned ``X_bin``
    into ``acc``.  With EFB the physical column is decoded back to
    feature bins (inverse of io/bundling.py encode_column): a value in
    this member's ``[offset, offset+num_bin)`` range is the member's
    bin + offset, anything else (bin 0 = all-default, or another
    member's range) reads as the member's default bin.  Bundle
    conflicts make this an approximation bounded by the EFB conflict
    budget — the same bound training itself accepts."""
    if nrows <= 0 or ds.X_bin is None:
        return
    X = ds.X_bin[row0:row0 + nrows]
    bundle = ds.bundle
    for i in range(ds.num_features):
        nb = len(acc[i])
        if bundle is not None:
            col = X[:, int(bundle.feat2phys[i])].astype(np.int64)
            if bundle.needs_fix[i]:
                off = int(bundle.feat_offset[i])
                db = int(ds.inner_to_mapper(i).default_bin)
                fb = np.where((col >= off) & (col < off + nb),
                              col - off, db)
            else:
                fb = col
        else:
            fb = X[:, i].astype(np.int64)
        acc[i] += np.bincount(fb, minlength=nb)[:nb]


def compute_occupancy(ds, chunk_rows: int = 65536) -> List[np.ndarray]:
    """Whole-dataset bin occupancy, chunked so a memmap-backed ``X_bin``
    streams instead of materializing."""
    acc = init_occupancy(ds)
    for row0 in range(0, int(ds.num_data), chunk_rows):
        accumulate_occupancy(ds, acc, row0,
                             min(chunk_rows, int(ds.num_data) - row0))
    return acc


def device_occupancy(ds, bins) -> List[np.ndarray]:
    """Whole-dataset bin occupancy counted on ``bins``'s device:
    ``bins`` is the dataset's row-major physical bin matrix there (uint8,
    or int32 for wider bins); each feature's column is decoded out of its
    EFB bundle as :func:`accumulate_occupancy` decodes it, counted with
    ``torch.bincount``, and the counts of every feature come to the host
    in one copy.  No host fallback: the count runs where ``bins`` is."""
    import torch
    if ds.num_features == 0:
        return []
    bundle = ds.bundle
    parts, sizes = [], []
    for i in range(ds.num_features):
        nb = int(ds.inner_to_mapper(i).num_bin)
        if bundle is not None:
            col = bins[:, int(bundle.feat2phys[i])].long()
            if bundle.needs_fix[i]:
                off = int(bundle.feat_offset[i])
                db = int(ds.inner_to_mapper(i).default_bin)
                col = torch.where((col >= off) & (col < off + nb),
                                  col - off, torch.full_like(col, db))
        else:
            col = bins[:, i].long()
        parts.append(torch.bincount(col, minlength=nb)[:nb])
        sizes.append(nb)
    counts = torch.cat(parts).cpu().numpy().astype(np.int64)
    return list(np.split(counts, np.cumsum(sizes)[:-1]))


def _pred_histogram(scores: np.ndarray):
    """Equal-mass histogram of raw scores with TIE-ROBUST edges: cuts
    fall at midpoints BETWEEN distinct adjacent score values, never on a
    value itself.  GBDT margins are heavily discrete (leaf-value sums),
    and training-time accumulated scores differ from serve-time
    recomputed ones by float noise — an edge sitting exactly on a tie
    clump would flip the whole clump across buckets for a 1e-7
    difference and read as drift.  Counts use the same
    ``searchsorted(side='left')`` the sketch uses."""
    s = np.asarray(scores, np.float64).ravel()
    s = s[np.isfinite(s)]
    if s.size == 0:
        return [], [0]
    u, uc = np.unique(s, return_counts=True)
    if len(u) < 2:
        return [], [int(s.size)]
    cum = np.cumsum(uc)
    targets = s.size * np.arange(1, PRED_BUCKETS) / PRED_BUCKETS
    cut = np.searchsorted(cum, targets, side="left")
    cut = np.unique(np.clip(cut, 0, len(u) - 2))
    edges = (u[cut] + u[cut + 1]) / 2.0
    counts = np.bincount(np.searchsorted(edges, s, side="left"),
                         minlength=len(edges) + 1)
    return [float(x) for x in edges], [int(x) for x in counts]


def _binary_auc(scores: np.ndarray, label: np.ndarray) -> Optional[float]:
    """Compact tie-aware ROC AUC for binary labels (the quality
    baseline; metric/basic.py AUCMetric is the full weighted version —
    this is the unweighted rank statistic, stdlib-cheap)."""
    y = np.asarray(label, np.float64).ravel()
    s = np.asarray(scores, np.float64).ravel()
    mask = np.isfinite(s) & np.isfinite(y)
    y, s = y[mask], s[mask]
    pos = y > 0
    n_pos, n_neg = int(pos.sum()), int((~pos).sum())
    if n_pos == 0 or n_neg == 0:
        return None
    # rank with tie midpoints
    order = np.argsort(s, kind="mergesort")
    ranks = np.empty(len(s), np.float64)
    ranks[order] = np.arange(1, len(s) + 1, dtype=np.float64)
    sv = s[order]
    # average ranks over tie runs
    start = 0
    for i in range(1, len(sv) + 1):
        if i == len(sv) or sv[i] != sv[start]:
            if i - start > 1:
                ranks[order[start:i]] = 0.5 * (start + 1 + i)
            start = i
    return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2.0)
                 / (n_pos * n_neg))


class QualityProfile:
    """The persisted reference distribution — see module docstring.

    ``features``: list of per-inner-feature records
    ``{feature, name, categorical, num_bin, edges, nan_bin, counts}``
    where ``edges`` are the searchable upper bounds replicating
    ``value_to_bin`` and ``nan_bin`` is the NaN destination bin (-1
    when the feature has no NaN bin).  ``pred``:
    ``{edges, counts, mean, std}`` of the training raw margin.
    ``meta``: rows / train_auc / created timestamp.
    """

    FORMAT_VERSION = 1

    def __init__(self, features: List[dict], pred: dict, meta: dict):
        self.features = features
        self.pred = pred
        self.meta = meta

    # -- capture ------------------------------------------------------
    @classmethod
    def from_training(cls, ds, raw_score=None, label=None,
                      occupancy: Optional[List[np.ndarray]] = None
                      ) -> "QualityProfile":
        """Build the profile from a constructed ``BinnedDataset`` plus
        (optionally) the training raw scores.  ``occupancy`` short-cuts
        the X_bin scan when ingestion already accumulated it
        (``ds.quality_occupancy`` from ingest/stream.py pass 2)."""
        from ..io.binning import BIN_NUMERICAL, MISSING_NAN
        if occupancy is None:
            occupancy = getattr(ds, "quality_occupancy", None)
        if occupancy is None:
            occupancy = compute_occupancy(ds)
        features = []
        for i in range(ds.num_features):
            m = ds.inner_to_mapper(i)
            orig = int(ds.real_feature_idx[i])
            rec = {
                "feature": orig,
                "name": (ds.feature_names[orig]
                         if orig < len(ds.feature_names)
                         else f"Column_{orig}"),
                "categorical": m.bin_type != BIN_NUMERICAL,
                "num_bin": int(m.num_bin),
                "counts": [int(x) for x in occupancy[i]],
            }
            if m.bin_type == BIN_NUMERICAL:
                n_search = m.num_bin - (1 if m.missing_type == MISSING_NAN
                                        else 0)
                rec["edges"] = [float(x)
                                for x in m.bin_upper_bound[:n_search - 1]]
                rec["nan_bin"] = (m.num_bin - 1
                                  if m.missing_type == MISSING_NAN else -1)
            features.append(rec)

        pred = {"edges": [], "counts": [0], "mean": None, "std": None}
        meta = {"rows": int(ds.num_data),
                "num_features": int(ds.num_features),
                "train_auc": None,
                "created_unix": round(time.time(), 3)}
        if raw_score is not None:
            s = np.asarray(raw_score, np.float64)
            s = s[:, 0] if s.ndim == 2 else s.ravel()
            edges, counts = _pred_histogram(s)
            fin = s[np.isfinite(s)]
            pred = {"edges": edges, "counts": counts,
                    "mean": float(fin.mean()) if fin.size else None,
                    "std": float(fin.std()) if fin.size else None}
            if label is not None:
                lab = np.asarray(label, np.float64).ravel()
                if lab.size == s.size and set(np.unique(lab)) <= {0.0, 1.0}:
                    meta["train_auc"] = _binary_auc(s, lab)
        return cls(features, pred, meta)

    # -- persistence --------------------------------------------------
    def to_dict(self) -> dict:
        return {"format_version": self.FORMAT_VERSION,
                "features": self.features, "pred": self.pred,
                "meta": self.meta}

    @classmethod
    def from_dict(cls, d: dict) -> "QualityProfile":
        return cls(list(d.get("features") or []),
                   dict(d.get("pred") or {"edges": [], "counts": [0]}),
                   dict(d.get("meta") or {}))

    def save(self, path: str) -> str:
        with open(path, "w") as fh:
            json.dump(self.to_dict(), fh)
        return path

    @classmethod
    def load(cls, path: str) -> "QualityProfile":
        with open(path) as fh:
            return cls.from_dict(json.load(fh))

    # -- serve-side binning ------------------------------------------
    def numeric_records(self) -> List[dict]:
        return [r for r in self.features if not r.get("categorical")]


def bin_features(X, records: List[dict]) -> List[np.ndarray]:
    """Raw request rows -> per-record feature bins, replicating
    ``BinMapper.value_to_bin``'s numerical path exactly (NaN masked to
    0.0 for the search, ``searchsorted(edges, v, side='left')``, then
    NaN routed to the profile's ``nan_bin`` when one exists)."""
    X = np.asarray(X, np.float64)
    out = []
    for rec in records:
        v = X[:, int(rec["feature"])]
        nan = np.isnan(v)
        vv = np.where(nan, 0.0, v)
        b = np.searchsorted(np.asarray(rec["edges"], np.float64), vv,
                            side="left")
        nb = int(rec["nan_bin"])
        if nb >= 0:
            b = np.where(nan, nb, b)
        out.append(b.astype(np.int64))
    return out


# ---------------------------------------------------------------------------
# serve-side streaming sketch
# ---------------------------------------------------------------------------

class DriftSketch:
    """Fixed-bucket live histograms in the profile's bin space.

    Buckets are fixed at construction (from the profile), updates are
    integer bumps under one lock, and ``merge`` is elementwise integer
    addition — so merging per-replica sketches equals the
    single-accumulator oracle bit-exactly regardless of interleaving,
    the ``ServeMetrics`` contract."""

    def __init__(self, profile: QualityProfile):
        self.records = profile.numeric_records()
        self._nbins = [int(r["num_bin"]) for r in self.records]
        self.feat_counts = [np.zeros(nb, np.int64) for nb in self._nbins]
        self.pred_edges = np.asarray(profile.pred.get("edges") or [],
                                     np.float64)
        self.pred_counts = np.zeros(len(self.pred_edges) + 1, np.int64)
        self.feat_rows = 0
        self.pred_rows = 0
        self._lock = threading.Lock()

    def observe_features(self, X) -> int:
        """Bin a sampled batch of raw rows and bump the counts.  The
        binning runs OUTSIDE the lock; only the adds hold it."""
        X = np.asarray(X, np.float64)
        if X.ndim == 1:
            X = X.reshape(1, -1)
        if X.shape[0] == 0 or not self.records:
            return 0
        bins = bin_features(X, self.records)
        adds = [np.bincount(np.clip(b, 0, nb - 1), minlength=nb)[:nb]
                for b, nb in zip(bins, self._nbins)]
        with self._lock:
            for c, a in zip(self.feat_counts, adds):
                c += a
            self.feat_rows += int(X.shape[0])
        return int(X.shape[0])

    def observe_preds(self, scores) -> int:
        s = np.asarray(scores, np.float64).ravel()
        if s.size == 0:
            return 0
        if self.pred_edges.size:
            b = np.searchsorted(self.pred_edges, s, side="left")
        else:
            b = np.zeros(s.size, np.int64)
        add = np.bincount(b, minlength=len(self.pred_counts))
        add = add[:len(self.pred_counts)]
        with self._lock:
            self.pred_counts += add
            self.pred_rows += int(s.size)
        return int(s.size)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "feat_rows": int(self.feat_rows),
                "pred_rows": int(self.pred_rows),
                "feat_counts": [c.copy() for c in self.feat_counts],
                "pred_counts": self.pred_counts.copy(),
            }

    def merge(self, other: "DriftSketch") -> None:
        """Fold another replica's sketch into this one (bit-exact:
        integer adds commute and associate)."""
        snap = other.snapshot()
        with self._lock:
            for c, a in zip(self.feat_counts, snap["feat_counts"]):
                c += a
            self.pred_counts += snap["pred_counts"]
            self.feat_rows += snap["feat_rows"]
            self.pred_rows += snap["pred_rows"]


# ---------------------------------------------------------------------------
# the monitor: profile + sketch + cadence + breach latch
# ---------------------------------------------------------------------------

class DriftMonitor:
    """One per served model version (built by the replica router and
    shared across its replica sessions, like ``ServeMetrics``)."""

    def __init__(self, profile: QualityProfile, config=None, *,
                 source: str = ""):
        self.profile = profile
        self.sketch = DriftSketch(profile)
        self.source = source
        self.sample_rate = _knob(config, "tpu_drift_sample_rate",
                                 float, 0.05)
        self.check_s = _knob(config, "tpu_drift_check_s", float, 30.0)
        self.min_rows = _knob(config, "tpu_drift_min_rows", int, 200)
        self.psi_warn = _knob(config, "tpu_drift_psi_warn", float, 0.25)
        # fleet identity — stamped by the router like session identity
        self.model_name = "default"
        self.model_version = 0
        self.scores: Optional[dict] = None
        self.breach: Optional[dict] = None
        self.breach_count = 0
        self.checks = 0
        self._acc = 0.0              # deterministic sampling accumulator
        self._pend_s: list = []      # score batches awaiting histogram
        self._pend_X: list = []      # sampled feature batches awaiting bin
        self._pend_rows = 0
        self._paused = False         # canary gate: synthetic probes
        self._last_check_t = time.monotonic()
        self._last_dump_t = -math.inf
        self._lock = threading.Lock()

    # -- construction -------------------------------------------------
    @classmethod
    def maybe_load(cls, model, config=None) -> Optional["DriftMonitor"]:
        """Arm drift monitoring when (a) the knob is on, (b) the model
        came from a file path, and (c) the ``.quality.json`` sidecar is
        beside it.  Anything else -> None (the session's hot path takes
        one ``is None`` branch and nothing more)."""
        if not _knob(config, "tpu_drift", bool, True):
            return None
        if not isinstance(model, str):
            return None
        path = profile_path(model)
        if not os.path.isfile(path):
            return None
        try:
            return cls(QualityProfile.load(path), config, source=path)
        except (ValueError, OSError) as exc:  # corrupt sidecar: serve on
            from ..utils import log
            log.warning("drift: failed to load %s (%s) — monitoring off",
                        path, exc)
            return None

    # -- hot path -----------------------------------------------------
    def observe(self, raw_rows, raw_scores) -> None:
        """Called once per executed serve batch with the raw feature
        rows and the raw margin scores.  Prediction histogram every
        response; feature rows through the deterministic
        batch-granularity sampler (credit accrues at ``sample_rate``
        per row; a batch is taken when the credit covers it — at rate
        1.0 every batch).  ``raw_rows`` may be one [n, P] array, a list
        of per-request arrays (concatenated only when the sampler takes
        the batch — the skipped-batch cost is a size sum), or None.

        This path only COPIES and APPENDS: the histogramming happens in
        ``flush`` every ``_PEND_FLUSH_ROWS`` pending rows (or when a
        cadence check / status read forces it), so the per-batch serve
        cost is a couple of small allocations, not a numpy call chain.
        The copies decouple the sketch from callers that mutate their
        result arrays after the fact."""
        if self._paused:
            return
        n = 0
        if isinstance(raw_rows, (list, tuple)):
            for r in raw_rows:
                if r is not None:
                    n += len(r)
        elif raw_rows is not None:
            n = len(raw_rows)
        take = False
        if n and self.sample_rate > 0.0:
            self._acc += n * self.sample_rate
            if self._acc >= n:
                self._acc -= n
                take = True
        if raw_scores is None and not take:
            return
        # copies, made outside the lock: the buffer must not see a
        # caller mutating its result/input arrays after this returns
        s = np.array(raw_scores, np.float64) \
            if raw_scores is not None else None
        if take:
            if isinstance(raw_rows, (list, tuple)):
                X = [np.array(r) for r in raw_rows if r is not None]
            else:
                X = np.array(raw_rows)
        with self._lock:
            if s is not None:
                self._pend_s.append(s)
                self._pend_rows += n or s.size
            if take:
                self._pend_X.append(X)
                self._pend_rows += n
            due = self._pend_rows >= _PEND_FLUSH_ROWS
        if due:
            self.flush()

    def flush(self) -> None:
        """Drain the pending batch buffers into the sketch.  The swap is
        atomic under the lock; shaping/concatenation/binning all run
        outside it.  Integer adds commute, so flush order across
        threads never changes the resulting counts."""
        with self._lock:
            if not self._pend_s and not self._pend_X:
                return
            ps, px = self._pend_s, self._pend_X
            self._pend_s, self._pend_X = [], []
            self._pend_rows = 0
            # capture the sketch with the buffers: a concurrent
            # reset_window swaps ``self.sketch``, and these rows belong
            # to the window they were observed in, not the fresh one
            sketch = self.sketch
        scores = []
        for s in ps:
            s = s[:, 0] if s.ndim == 2 else s.ravel()
            if s.size:
                scores.append(s)
        if scores:
            sketch.observe_preds(
                np.concatenate(scores) if len(scores) > 1 else scores[0])
        rows = []
        for batch in px:
            if isinstance(batch, (list, tuple)):
                rows.extend(np.asarray(r) for r in batch if r is not None)
            else:
                rows.append(np.asarray(batch))
        rows = [r.reshape(1, -1) if r.ndim == 1 else r for r in rows]
        rows = [r for r in rows if r.ndim == 2 and r.shape[0]]
        if rows:
            sketch.observe_features(
                np.concatenate(rows, axis=0) if len(rows) > 1 else rows[0])

    def pause(self) -> None:
        """Stop observing/checking: the canary gate pushes synthetic
        probe traffic through the real predict path, and those rows
        must neither seed the sketch nor trip a (cooldown-consuming)
        breach dump before the version has served a single real row."""
        self._paused = True

    def resume(self) -> None:
        self._paused = False

    def reset_window(self) -> None:
        """Drop the live window: pending buffers, sketch counts, the
        last scores, and any latched breach.  The registry calls this
        when a version goes live (or is restored by a rollback) so the
        serving episode is scored from an empty window."""
        with self._lock:
            self._pend_s, self._pend_X = [], []
            self._pend_rows = 0
            self._acc = 0.0
            self.sketch = DriftSketch(self.profile)
            self.scores = None
            self.breach = None
            self._last_check_t = time.monotonic()

    # -- cadence ------------------------------------------------------
    def compute_scores(self, snap: Optional[dict] = None) -> dict:
        """Score the sketch against the profile: per-feature PSI/KS
        (numerical features only), prediction PSI/KS, and the
        aggregates the breach gate reads."""
        snap = snap or self.sketch.snapshot()
        per_feature = []
        for rec, live in zip(self.sketch.records, snap["feat_counts"]):
            rc, lc = coarsen(rec["counts"], live)
            per_feature.append({
                "feature": rec["feature"], "name": rec["name"],
                "psi": round(psi(rc, lc), 6),
                "ks": round(ks(rc, lc), 6),
            })
        feat_psi = [f["psi"] for f in per_feature]
        pred_ref = np.asarray(self.profile.pred.get("counts") or [0],
                              np.float64)
        if len(pred_ref) == len(snap["pred_counts"]):
            # same equal-reference-mass regrouping the features get: a
            # small live sample over the 32 fine buckets reads ~0.5 PSI
            # of pure noise (several near-empty buckets), and an early
            # cadence check must not breach on that
            prc, plc = coarsen(pred_ref, snap["pred_counts"])
            p_psi, p_ks = psi(prc, plc), ks(prc, plc)
        else:
            p_psi = p_ks = 0.0
        worst = max(per_feature, key=lambda f: f["psi"], default=None)
        return {
            "feat_rows": snap["feat_rows"],
            "pred_rows": snap["pred_rows"],
            "psi_max": round(max(feat_psi), 6) if feat_psi else 0.0,
            "psi_mean": round(float(np.mean(feat_psi)), 6)
            if feat_psi else 0.0,
            "ks_max": round(max((f["ks"] for f in per_feature),
                                default=0.0), 6),
            "pred_psi": round(p_psi, 6),
            "pred_ks": round(p_ks, 6),
            "worst_feature": (worst["name"] if worst else None),
            "per_feature": per_feature,
        }

    def maybe_check(self, now: Optional[float] = None,
                    force: bool = False) -> Optional[dict]:
        """Cadence gate: score + emit + breach-check when due.  Returns
        the fresh scores dict, or None when not due / not enough rows.
        Cheap when idle — one monotonic read and a compare."""
        if self._paused:
            return None
        now = time.monotonic() if now is None else now
        with self._lock:
            if not force and now - self._last_check_t < self.check_s:
                return None
            self._last_check_t = now
        self.flush()
        snap = self.sketch.snapshot()
        if not force and snap["feat_rows"] < self.min_rows \
                and snap["pred_rows"] < self.min_rows:
            return None
        scores = self.compute_scores(snap)
        self.checks += 1
        breach_kinds = []
        if scores["feat_rows"] >= self.min_rows \
                and scores["psi_max"] > self.psi_warn:
            breach_kinds.append("feature_psi")
        if scores["pred_rows"] >= self.min_rows \
                and scores["pred_psi"] > self.psi_warn:
            breach_kinds.append("pred_psi")
        breached = bool(breach_kinds)
        core.event("drift_snapshot",
                   model=self.model_name,
                   version=int(self.model_version),
                   feat_rows=int(scores["feat_rows"]),
                   pred_rows=int(scores["pred_rows"]),
                   psi_max=scores["psi_max"],
                   psi_mean=scores["psi_mean"],
                   ks_max=scores["ks_max"],
                   pred_psi=scores["pred_psi"],
                   pred_ks=scores["pred_ks"],
                   worst_feature=scores["worst_feature"] or "",
                   breach=breached)
        if breached:
            self.breach_count += 1
            self.breach = {
                "kinds": breach_kinds,
                "psi_max": scores["psi_max"],
                "pred_psi": scores["pred_psi"],
                "threshold": self.psi_warn,
                "worst_feature": scores["worst_feature"],
                "at_unix": round(time.time(), 3),
            }
            if now - self._last_dump_t >= _DUMP_COOLDOWN_S:
                self._last_dump_t = now
                flight_dump(f"drift_psi:{self.model_name}",
                            extra={"drift": {k: v for k, v in
                                             scores.items()
                                             if k != "per_feature"},
                                   "breach": self.breach})
        else:
            self.breach = None
        self.scores = scores
        return scores

    # -- introspection ------------------------------------------------
    def status(self) -> dict:
        """The ``GET /drift`` / ``stats()`` view: thresholds, live row
        counts, last scores, breach latch."""
        self.flush()
        snap = self.sketch.snapshot()
        out = {
            "armed": True,
            "model": self.model_name,
            "version": int(self.model_version),
            "source": self.source,
            "sample_rate": self.sample_rate,
            "check_s": self.check_s,
            "min_rows": self.min_rows,
            "psi_warn": self.psi_warn,
            "feat_rows": snap["feat_rows"],
            "pred_rows": snap["pred_rows"],
            "checks": self.checks,
            "breaches": self.breach_count,
            "breach": self.breach,
            "reference_rows": self.profile.meta.get("rows"),
            "train_auc": self.profile.meta.get("train_auc"),
        }
        if self.scores is not None:
            out["scores"] = {k: v for k, v in self.scores.items()
                             if k != "per_feature"}
        return out
