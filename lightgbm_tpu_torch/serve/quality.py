"""Rolling label-quality tracking of a served model (counterpart of
lightgbm_tpu/serve/quality.py, with its ``quality_window`` event).

Labeled rows fed to :meth:`QualityTracker.add` (the online loop's label
stream, when it is ported) are scored by the served model, and every
``tpu_quality_window`` rows make one ``quality_window`` event: the
window's AUC, an NDCG@10 over the window as one query, and the expected
calibration error.  When the model's quality profile has a training AUC
and a window's AUC falls more than ``tpu_quality_drop_warn`` below it,
the tracker dumps the flight ring and latches a breach on the registry
(``note_quality_breach``), which the post-swap watch folds into its
verdict (a rollback only with ``tpu_serve_rollback_on_drift``).

numpy; the model enters only through ``predict_fn``.
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np

from .. import obs
from ..obs.drift import QualityProfile, _binary_auc, _knob
from ..utils import log


def _sigmoid(s: np.ndarray) -> np.ndarray:
    return 1.0 / (1.0 + np.exp(-np.clip(s, -60.0, 60.0)))


def _calibration_error(scores: np.ndarray, label: np.ndarray,
                       bins: int = 10) -> Optional[float]:
    """Expected calibration error of sigmoid(score) vs binary labels:
    |mean predicted - observed rate| averaged over equal-width
    probability bins, weighted by bin mass."""
    p = _sigmoid(np.asarray(scores, np.float64).ravel())
    y = np.asarray(label, np.float64).ravel()
    if p.size == 0 or p.size != y.size:
        return None
    idx = np.clip((p * bins).astype(np.int64), 0, bins - 1)
    n = np.bincount(idx, minlength=bins).astype(np.float64)
    conf = np.bincount(idx, weights=p, minlength=bins)
    acc = np.bincount(idx, weights=y, minlength=bins)
    mask = n > 0
    if not mask.any():
        return None
    return float(np.sum(np.abs(conf[mask] - acc[mask])) / p.size)


def _window_ndcg(scores: np.ndarray, label: np.ndarray,
                 k: int = 10) -> Optional[float]:
    """NDCG@k treating the whole window as one query (gain 2^y - 1):
    a top-of-ranking quality signal even without query structure —
    degenerate (None) when no row has positive gain."""
    s = np.asarray(scores, np.float64).ravel()
    y = np.asarray(label, np.float64).ravel()
    if s.size == 0 or s.size != y.size:
        return None
    gain = np.power(2.0, y) - 1.0
    if gain.sum() <= 0:
        return None
    disc = 1.0 / np.log2(np.arange(2, min(k, s.size) + 2))
    order = np.argsort(-s, kind="mergesort")
    dcg = float(np.sum(gain[order[:len(disc)]] * disc))
    ideal = np.sort(gain)[::-1]
    idcg = float(np.sum(ideal[:len(disc)] * disc))
    return dcg / idcg if idcg > 0 else None


class QualityTracker:
    """Windowed quality evaluation of a served model against its
    delayed labels.  One per online loop; thread-safe only in the
    loop's single-ingest-thread sense (matching ``OnlineLoop``)."""

    def __init__(self, predict_fn, profile: Optional[QualityProfile],
                 config=None, *, registry=None, model_name: str = "default"):
        self.predict_fn = predict_fn
        self.profile = profile
        self.registry = registry
        self.model_name = model_name
        self.window = max(int(_knob(config, "tpu_quality_window",
                                    int, 512)), 1)
        self.drop_warn = float(_knob(config, "tpu_quality_drop_warn",
                                     float, 0.05))
        self.auc_ref = (profile.meta.get("train_auc")
                        if profile is not None else None)
        self._X: list = []
        self._y: list = []
        self._buffered = 0
        self.windows = 0
        self.rows = 0
        self.breaches = 0
        self.last: Optional[dict] = None

    # -- feed ---------------------------------------------------------
    def add(self, X, y) -> None:
        """Bank labeled rows; evaluates one window per ``window`` rows.
        Scoring failures degrade to a warning — quality tracking must
        never take the ingest path down."""
        X = np.asarray(X)
        y = np.asarray(y, np.float64).ravel()
        if X.ndim == 1:
            X = X.reshape(1, -1)
        if X.shape[0] == 0 or X.shape[0] != y.size:
            return
        self._X.append(X)
        self._y.append(y)
        self._buffered += int(X.shape[0])
        self.rows += int(X.shape[0])
        while self._buffered >= self.window:
            Xa = np.concatenate(self._X, axis=0)
            ya = np.concatenate(self._y)
            Xw, yw = Xa[:self.window], ya[:self.window]
            rest_X, rest_y = Xa[self.window:], ya[self.window:]
            self._X = [rest_X] if rest_X.shape[0] else []
            self._y = [rest_y] if rest_y.shape[0] else []
            self._buffered = int(rest_X.shape[0])
            try:
                self._evaluate(Xw, yw)
            except Exception as exc:  # noqa: BLE001 — never break ingest
                log.warning("quality window evaluation failed: %s", exc)

    # -- evaluation ---------------------------------------------------
    def _evaluate(self, X: np.ndarray, y: np.ndarray) -> None:
        scores = np.asarray(self.predict_fn(X), np.float64)
        scores = scores[:, 0] if scores.ndim == 2 else scores.ravel()
        version = self._served_version()
        auc = _binary_auc(scores, y) \
            if set(np.unique(y)) <= {0.0, 1.0} else None
        cal = _calibration_error(scores, y) if auc is not None else None
        ndcg = _window_ndcg(scores, y)
        delta = (round(self.auc_ref - auc, 6)
                 if auc is not None and self.auc_ref is not None else None)
        breached = delta is not None and delta > self.drop_warn
        self.windows += 1
        rec = {"rows": int(X.shape[0]), "version": version,
               "auc": None if auc is None else round(auc, 6),
               "auc_ref": (None if self.auc_ref is None
                           else round(self.auc_ref, 6)),
               "auc_delta": delta,
               "cal_err": None if cal is None else round(cal, 6),
               "ndcg": None if ndcg is None else round(ndcg, 6),
               "breach": breached,
               "at_unix": round(time.time(), 3)}
        self.last = rec
        ev = {k: v for k, v in rec.items()
              if v is not None and k != "at_unix"}
        ev.setdefault("breach", False)
        obs.event("quality_window", model=self.model_name, **ev)
        if breached:
            self.breaches += 1
            obs.flight_dump(f"quality_drop:{self.model_name}",
                            extra={"quality": rec,
                                   "threshold": self.drop_warn})
            if self.registry is not None and hasattr(self.registry,
                                                     "note_quality_breach"):
                self.registry.note_quality_breach(self.model_name, rec)

    def _served_version(self) -> int:
        if self.registry is None:
            return 0
        try:
            ent = self.registry._models.get(self.model_name)
            return int(ent.live.version) if ent and ent.live else 0
        except Exception:  # noqa: BLE001
            return 0

    # -- introspection ------------------------------------------------
    def stats(self) -> dict:
        out = {"window": self.window, "drop_warn": self.drop_warn,
               "rows": self.rows, "windows": self.windows,
               "buffered": self._buffered, "breaches": self.breaches,
               "auc_ref": self.auc_ref}
        if self.last is not None:
            out["last"] = self.last
        return out
