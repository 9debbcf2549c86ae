"""Aggregation across ranks: straggler detection and the reconciliation
of measured times with the port's cost functions (counterpart of
lightgbm_tpu/obs/ranks.py).

- :class:`StragglerDetector`, the JAX package's streak logic as it is:
  over a ``[ranks, phases]`` matrix of per-iteration walls, a rank whose
  phase wall exceeds the ranks' median by ``tpu_straggler_factor`` for
  ``tpu_straggler_iters`` consecutive iterations is a straggler.
- :class:`RankAggregator` sums this rank's phase seconds and, on the
  fingerprint cadence, exchanges the window's sums over
  ``parallel/distributed.py train_stats_exchange`` (a gloo all-gather of
  a few floats, or the fleet's host transport).  Rank 0 runs the
  detector, emits the ``straggler`` event naming the slow rank and dumps
  the flight ring.  In one process the exchange returns None and nothing
  else happens.
- :class:`Reconciler` holds an iteration's measured phase walls against
  the port's own cost functions: ``ops/hist_wave.py hist_wave_cost`` (K1),
  ``ops/hist_channels.py hist_channels_cost`` (K2),
  ``core/splitter.py partition_cost``, ``ops/rank.py rank_pair_cost`` and
  ``ops/treeshap.py shap_cost``, over the card's peaks
  (``obs/profile.py device_peaks``).  The result is the
  ``reconciliation`` event's ``units``: measured over modelled seconds a
  unit.

All of it is host arithmetic; the exchange rides the fingerprint tick.
``obs/board.py`` renders the skew table and the last reconciliation.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence

from . import core

# the phases watched: the device-bound legs a slow host shows first (the
# valid-set scoring leg depends on the run, so skew there is config)
PHASES = ("boosting (grad/hess)", "tree growth")

# below this per-iteration median (seconds) a phase is noise
_MIN_MEDIAN_S = 1e-4


def _median(xs: Sequence[float]) -> float:
    s = sorted(xs)
    n = len(s)
    if not n:
        return 0.0
    m = n // 2
    return s[m] if n % 2 else 0.5 * (s[m - 1] + s[m])


class StragglerDetector:
    """Streak logic over per-rank, per-phase iteration walls.

    ``update(means, window_iters, iteration)`` takes the ranks' mean
    per-iteration walls over the window just exchanged
    (``means[rank][phase]`` seconds) and the iterations the window
    covered, and returns the breaches that crossed the threshold on this
    update (a streak reports once; a recovery resets it)."""

    def __init__(self, factor: float, iters: int,
                 phases: Sequence[str] = PHASES):
        self.factor = float(factor)
        self.iters = max(int(iters), 1)
        self.phases = tuple(phases)
        self._streak: Dict[tuple, int] = {}   # (rank, phase) -> iters
        self._emitted: set = set()            # streaks already reported

    def update(self, means: Sequence[Sequence[float]], window_iters: int,
               iteration: int) -> List[dict]:
        breaches = []
        window_iters = max(int(window_iters), 1)
        for pi, phase in enumerate(self.phases):
            col = [float(row[pi]) for row in means]
            med = _median(col)
            if med < _MIN_MEDIAN_S:
                for r in range(len(col)):
                    self._streak.pop((r, phase), None)
                    self._emitted.discard((r, phase))
                continue
            for r, wall in enumerate(col):
                key = (r, phase)
                if wall > self.factor * med:
                    streak = self._streak.get(key, 0) + window_iters
                    self._streak[key] = streak
                    if streak >= self.iters and key not in self._emitted:
                        self._emitted.add(key)
                        breaches.append({
                            "rank": r,
                            "phase": phase,
                            "iteration": int(iteration),
                            "ratio": round(wall / med, 4),
                            "median_s": round(med, 6),
                            "rank_s": round(wall, 6),
                            "consecutive": int(streak),
                            "breach": True,
                        })
                else:
                    self._streak.pop(key, None)
                    self._emitted.discard(key)
        return breaches


# the board's skew table: the last exchanged per-rank walls, written by
# the training thread, read by the board's HTTP thread
_skew_lock = threading.Lock()
_skew: dict = {}


def skew_table() -> dict:
    """The last exchange: ``{"iteration", "window_iters", "ranks": {rank:
    {phase: s/iter}}, "stragglers"}``; empty before the first exchange
    across ranks."""
    with _skew_lock:
        return dict(_skew)


def _reset_skew() -> None:
    with _skew_lock:
        _skew.clear()


core._register_reset(_reset_skew)


class RankAggregator:
    """This rank's phase walls, exchanged and checked on the fingerprint
    cadence."""

    def __init__(self, factor: float = 2.0, iters: int = 3,
                 phases: Sequence[str] = PHASES):
        self.phases = tuple(phases)
        self.detector = StragglerDetector(factor, iters, self.phases)
        self._win = [0.0] * len(self.phases)
        self._win_iters = 0

    def accumulate(self, phase_s: dict) -> None:
        """Add one iteration's phase seconds to the open window."""
        for i, p in enumerate(self.phases):
            self._win[i] += float(phase_s.get(p, 0.0) or 0.0)
        self._win_iters += 1

    def exchange(self, iteration: int) -> Optional[List[dict]]:
        """Exchange the open window across ranks (a collective: every rank
        calls it on the same iterations).  Returns the breaches, None in
        one process or with an empty window."""
        if not self._win_iters:
            return None
        vec = list(self._win) + [float(self._win_iters)]
        self._win = [0.0] * len(self.phases)
        self._win_iters = 0
        from ..parallel.distributed import rank, train_stats_exchange
        mat = train_stats_exchange(vec)
        if mat is None:
            return None
        rows = [[float(v) for v in row] for row in mat]
        means = [[w / max(row[-1], 1.0) for w in row[:-1]] for row in rows]
        window_iters = int(max(r[-1] for r in rows))
        table = {r: {p: round(means[r][pi], 6)
                     for pi, p in enumerate(self.phases)}
                 for r in range(len(means))}
        breaches = self.detector.update(means, window_iters, iteration)
        with _skew_lock:
            _skew.clear()
            _skew.update(iteration=int(iteration),
                         window_iters=window_iters, ranks=table,
                         stragglers=list(breaches))
        if rank() != 0:
            return breaches
        for b in breaches:
            core.event("straggler", **b)
            from . import spans
            if spans.flight_enabled():
                spans.flight_dump(
                    f"straggler:rank{b['rank']}",
                    extra={"straggler": b, "skew": table})
        return breaches


class Reconciler:
    """An iteration's measured phase walls against the port's cost
    functions: the ``reconciliation`` event's ``units``, each with
    ``measured_s``, ``modeled_s`` and their ``ratio`` (far above 1: the
    unit runs far from its bound).  A unit whose inputs are missing is
    left out."""

    def __init__(self):
        self._peaks = None

    def _bound(self, ops: float, nbytes: float) -> float:
        from .profile import device_peaks, roofline_seconds
        if self._peaks is None:
            self._peaks = device_peaks()
        return roofline_seconds(ops, nbytes, self._peaks)

    @staticmethod
    def _unit(measured: float, modeled: float) -> Optional[dict]:
        if modeled <= 0 or measured < 0:
            return None
        return {"measured_s": round(measured, 6),
                "modeled_s": round(modeled, 6),
                "ratio": round(measured / modeled, 4)}

    def score(self, *, phase_s: dict, iter_s: float, N: int,
              kern_rows=None, waves=None, wave_cost_args=None,
              channels_cost_args=None, k2_launches: int = 0,
              splits: int = 0, part_batched: bool = False,
              rank_sizes=None) -> Optional[dict]:
        """``wave_cost_args`` = (F, B, packed, fused, quant) of K1 on the
        wave path (``waves`` launches over ``kern_rows`` slotted rows);
        ``channels_cost_args`` = (F, B, C) of K2 on the serial grower
        (``k2_launches`` leaf histograms of N rows)."""
        units = {}
        growth = float(phase_s.get("tree growth", iter_s) or 0.0)
        modeled_growth = 0.0
        if kern_rows and waves and wave_cost_args:
            from ..ops.hist_wave import hist_wave_cost
            F, B, packed, fused, quant = wave_cost_args
            ops, nbytes = hist_wave_cost(N, F, B, kern_rows / waves,
                                         packed=packed, fused=fused,
                                         quant=quant)
            modeled = self._bound(ops * waves, nbytes * waves)
            modeled_growth += modeled
            u = self._unit(growth, modeled)
            if u:
                units["hist_wave"] = u
        if k2_launches and channels_cost_args:
            from ..ops.hist_channels import hist_channels_cost
            F, B, C = channels_cost_args
            ops, nbytes = hist_channels_cost(N, F, B, C)
            modeled = self._bound(ops * k2_launches, nbytes * k2_launches)
            modeled_growth += modeled
            u = self._unit(growth, modeled)
            if u:
                units["hist_channels"] = u
        if splits > 0:
            from ..core.splitter import partition_cost
            ops, nbytes = partition_cost(int(N), splits=int(splits),
                                         batched=bool(part_batched),
                                         waves=int(waves or 1))
            modeled = self._bound(ops, nbytes)
            modeled_growth += modeled
            u = self._unit(growth, modeled)
            if u:
                units["partition"] = u
        if modeled_growth > 0:
            # the growth phase against the sum of its units' bounds
            u = self._unit(growth, modeled_growth)
            if u:
                units["tree_growth"] = u
        if rank_sizes is not None and len(rank_sizes):
            from ..ops.rank import rank_pair_cost
            # chunk_elems=1: the port's blocks, no padding queries
            ops, nbytes = rank_pair_cost(rank_sizes, 1)
            boosting = float(phase_s.get("boosting (grad/hess)", 0.0) or 0.0)
            u = self._unit(boosting, self._bound(ops, nbytes))
            if u:
                units["rank_pair"] = u
        return units or None

    def score_shap(self, measured_s: float, *, N: int, T: int, L: int,
                   P: int, F: int, K: int = 1) -> Optional[dict]:
        """A TreeSHAP pass against ``ops/treeshap.py shap_cost``."""
        from ..ops.treeshap import shap_cost
        ops, nbytes = shap_cost(N, T, L, P, F, K)
        return self._unit(float(measured_s), self._bound(ops, nbytes))

    def score_measured(self, rows) -> Optional[dict]:
        """``kernel_measured`` rows (``obs/xprof.py``) as ``units``: one a
        kernel with a bound, the profiler's device time over it."""
        units = {}
        for row in rows or ():
            model_ms = row.get("model_ms")
            if not model_ms:
                continue
            u = self._unit(float(row.get("measured_ms", 0.0)) / 1e3,
                           float(model_ms) / 1e3)
            if u:
                units[row.get("kernel", "?")] = u
        return units or None
