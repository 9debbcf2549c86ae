"""Model registry: named versions, canary-gated hot swap, rollback
(counterpart of lightgbm_tpu/serve/registry.py).

A model push is a governed transition, not a file overwrite:

1. **load beside** — the candidate version packs its own
   ``ReplicaRouter`` (its own device forests, batchers, metrics) while
   the live version keeps serving.
2. **canary gate** — before traffic shifts the candidate must pass (a)
   *parity*: device predictions on a pinned probe set match the
   candidate's own host walk (``atol`` 1e-5; the host walk checks the
   answer and never gives one), (b) *finite outputs*, (c) a *latency
   probe*: p99 over ``tpu_serve_canary_probes`` one-row predicts, gated
   on ``tpu_serve_canary_p99_ms`` when that is > 0, and (d) the session
   not degraded.  A gate failure closes the candidate and leaves the old
   version serving.
3. **atomic flip** — the live pointer swaps under the registry lock.
   In-flight tickets hold the version that issued them, so they complete
   against the old forests: no dropped request, and every answer comes
   from exactly one version.
4. **instant rollback** — the previous version stays resident;
   ``rollback()`` is another pointer flip.  After a swap the registry
   watches the new version's ``ServeMetrics`` (fresh per version) for
   ``tpu_serve_rollback_watch_s``: a failed-request rate over
   ``tpu_serve_rollback_error_rate``, ``tpu_serve_rollback_degraded``
   degraded transitions or an SLO burn over
   ``tpu_serve_rollback_slo_burn`` rolls back automatically.

A live version's drift breach (its router's ``DriftMonitor``) and a
quality breach latched by ``serve/quality.py`` (``note_quality_breach``)
annotate the post-swap watch's report, and roll back only with
``tpu_serve_rollback_on_drift``; the canary's probe rows never reach the
monitor, and a version going live starts from an empty window.  The
online-loop provider waits for item 6.  Fault points: ``serve_swap``
before the flip, ``serve_canary`` inside the gate.  Transitions are
telemetry events, also kept in ``events``.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

import numpy as np

from .. import obs
from ..config import Config
from ..robust import faults
from ..utils import log
from .metrics import ServeMetrics, percentile
from .router import ReplicaRouter
from .session import _env_num

_CANARY_SEED = 17          # the pinned probe set is deterministic
_CANARY_ATOL = 1e-5        # device-vs-host parity tolerance (f32 forest)
_POSTSWAP_MIN_REQUESTS = 4  # an error rate needs a denominator


class UnknownModelError(KeyError):
    """The requested model name is not registered."""


class SwapRejected(RuntimeError):
    """The canary gate (or an injected swap fault) refused the flip; the
    previous version is still serving."""

    def __init__(self, msg: str, report: dict):
        super().__init__(msg)
        self.report = report


class _Version:
    """One resident model version: a router and its lifecycle state."""

    __slots__ = ("version", "router", "source", "state", "created_t",
                 "canary", "baseline", "watch_until")

    def __init__(self, version: int, router: ReplicaRouter, source: str):
        self.version = version
        self.router = router
        self.source = source
        self.state = "canary"          # canary|live|previous|retired
        self.created_t = time.time()
        self.canary: Optional[dict] = None
        self.baseline: Optional[dict] = None   # metrics at flip time
        self.watch_until: Optional[float] = None

    def row(self) -> dict:
        try:
            resident = int(self.router.resident_bytes())
        except Exception:  # noqa: BLE001 — a torn-down router lists None
            resident = None
        return {"version": self.version, "state": self.state,
                "source": self.source,
                "created_t": round(self.created_t, 1),
                "canary": self.canary, "resident_bytes": resident}


class _Entry:
    """All versions of one model name."""

    def __init__(self, name: str):
        self.name = name
        self.live: Optional[_Version] = None
        self.previous: Optional[_Version] = None
        self.history: List[dict] = []   # retired and rejected versions
        self.next_version = 1
        self.swaps = 0
        self.swaps_rejected = 0
        self.rollbacks = 0
        self.swap_lock = threading.Lock()  # one swap at a time per model
        # the latest rolling-quality breach of the live version (serve/
        # quality.py); cleared whenever the live version changes
        self.quality_breach: Optional[dict] = None


class ModelRegistry:
    """Named model versions with canary-gated zero-downtime swaps."""

    def __init__(self, config=None, n_replicas: Optional[int] = None,
                 **session_kw):
        if isinstance(config, dict):
            config = Config.from_params(config)
        cfg = config if config is not None else Config()
        self.config = config
        self.n_replicas = int(
            n_replicas if n_replicas is not None else _env_num(
                "LGBM_TPU_SERVE_REPLICAS", int, cfg.tpu_serve_replicas))
        self._session_kw = session_kw
        self._models: Dict[str, _Entry] = {}
        self._default: Optional[str] = None
        self._lock = threading.Lock()
        self.canary_rows = int(cfg.tpu_serve_canary_rows or 64)
        self.canary_probes = int(cfg.tpu_serve_canary_probes or 16)
        self.canary_p99_ms = float(cfg.tpu_serve_canary_p99_ms or 0.0)
        self.rollback_watch_s = float(_env_num(
            "LGBM_TPU_SERVE_ROLLBACK_WATCH_S", float,
            cfg.tpu_serve_rollback_watch_s))
        self.rollback_error_rate = float(
            cfg.tpu_serve_rollback_error_rate or 0.5)
        self.rollback_degraded = int(cfg.tpu_serve_rollback_degraded or 2)
        self.rollback_slo_burn = float(cfg.tpu_serve_rollback_slo_burn or 0.0)
        self.swap_warmup = bool(cfg.tpu_serve_swap_warmup)
        self.slo_p99_ms = float(cfg.tpu_serve_slo_p99_ms or 0.0)
        # drift and quality breaches roll back only on this opt-in
        self.rollback_on_drift = bool(_env_num(
            "LGBM_TPU_SERVE_ROLLBACK_ON_DRIFT", int,
            int(cfg.tpu_serve_rollback_on_drift)))
        # multi-tenant forest arena (serve/arena.py): registered names
        # win; names only the arena knows route there
        self.arena = None
        self.events: list = []

    def attach_arena(self, arena) -> "ModelRegistry":
        """Serve a ``ForestArena``'s tenants through the fleet surface
        (HTTP routing, /models, /metrics).  Returns self."""
        self.arena = arena
        return self

    def _event(self, name: str, **fields) -> None:
        self.events.append(dict(fields, event=name, t=time.time()))
        obs.event(name, **fields)

    @staticmethod
    def _fresh_window(ver) -> None:
        """A version going live is scored from an empty drift window (the
        canary's probes and pre-swap traffic are not its serving run)."""
        if ver.router.drift is not None:
            ver.router.drift.reset_window()

    # ------------------------------------------------------------------
    def _build_version(self, entry: _Entry, model) -> _Version:
        vnum = entry.next_version
        entry.next_version += 1
        router = ReplicaRouter(
            model, n_replicas=self.n_replicas, config=self.config,
            name=entry.name, version=vnum,
            metrics=ServeMetrics(slo_p99_ms=self.slo_p99_ms),
            **self._session_kw)
        return _Version(vnum, router, model if isinstance(model, str)
                        else type(model).__name__)

    def add_model(self, name: str, model, canary: bool = True) -> dict:
        """Register and serve the first version of ``name``.  The canary
        gate runs for an initial deploy too."""
        with self._lock:
            if name in self._models:
                raise ValueError(
                    f"model {name!r} already registered; use swap()")
            entry = self._models[name] = _Entry(name)
            if self._default is None:
                self._default = name
        try:
            ver = self._build_version(entry, model)
        except BaseException:
            self._forget(name)
            raise
        if canary:
            report = self.canary_gate(ver.router)
            ver.canary = report
            if not report["ok"]:
                ver.router.close()
                self._forget(name)
                raise SwapRejected(
                    f"initial deploy of {name!r} failed the canary gate: "
                    f"{report.get('error') or report['checks']}", report)
        self._fresh_window(ver)
        with self._lock:
            ver.state = "live"
            entry.live = ver
        self._event("serve_swap", model=name, ok=True,
                    to_version=ver.version, initial=True)
        log.info("registry: model %r v%d live (%d replica(s))", name,
                 ver.version, self.n_replicas)
        return {"ok": True, "model": name, "version": ver.version,
                "canary": ver.canary}

    def _forget(self, name: str) -> None:
        with self._lock:
            self._models.pop(name, None)
            if self._default == name:
                self._default = next(iter(self._models), None)

    # ------------------------------------------------------------------
    def canary_gate(self, router) -> dict:
        """Validate a candidate router before it takes traffic.  Returns
        ``{"ok": bool, "checks": {...}, "p99_ms": float}``; never raises
        (an exception inside the gate is a failed gate)."""
        sess = router.session
        checks: Dict[str, bool] = {}
        p99 = None
        t0 = time.perf_counter()
        if router.drift is not None:
            router.drift.pause()    # probe rows must not feed the sketch
        try:
            faults.check("serve_canary")
            rng = np.random.default_rng(_CANARY_SEED)
            X = rng.normal(size=(self.canary_rows, sess.num_features))
            X[rng.random(X.shape) < 0.05] = np.nan
            # chunked to the batch cap, as predict() does
            dev = np.concatenate(
                [sess._run_device(sess.space.bin_matrix(
                    X[lo:lo + sess.max_batch]))[0]
                 for lo in range(0, X.shape[0], sess.max_batch)])
            checks["finite"] = bool(np.isfinite(dev).all())
            host = sess._run_host(X)
            checks["parity"] = bool(np.allclose(dev, host, atol=_CANARY_ATOL,
                                                rtol=_CANARY_ATOL))
            # p99 probe: one-row predicts through the real sync path
            lats = []
            for _ in range(max(self.canary_probes, 1)):
                t = time.perf_counter()
                sess.predict(X[:1], raw_score=True)
                lats.append((time.perf_counter() - t) * 1e3)
            p99 = percentile(sorted(lats), 0.99)
            checks["latency"] = (p99 <= self.canary_p99_ms
                                 if self.canary_p99_ms > 0 else True)
            checks["not_degraded"] = not sess._degraded
        except Exception as exc:  # noqa: BLE001 — a failed gate, not a crash
            checks["gate"] = False
            if router.drift is not None:
                router.drift.resume()
            report = {"ok": False, "checks": dict(checks), "p99_ms": p99,
                      "error": f"{type(exc).__name__}: {exc}",
                      "ms": round((time.perf_counter() - t0) * 1e3, 1)}
            self._event("serve_canary", model=router.name or "?",
                        version=int(router.version or 0), ok=False,
                        checks=dict(checks))
            return report
        if router.drift is not None:
            router.drift.resume()
        ok = all(checks.values())
        report = {"ok": ok, "checks": checks, "p99_ms": p99,
                  "ms": round((time.perf_counter() - t0) * 1e3, 1)}
        self._event("serve_canary", model=router.name or "?",
                    version=int(router.version or 0), ok=ok, checks=checks)
        return report

    # ------------------------------------------------------------------
    def swap(self, name: str, model) -> dict:
        """Canary-gated hot swap: pack ``model`` beside the live version,
        gate it, flip atomically, keep the old version resident for
        rollback, arm the post-swap watch.  Raises :class:`SwapRejected`
        when the gate (or an injected fault) refuses; the old version
        keeps serving."""
        entry = self._entry(name)
        with entry.swap_lock:
            t0 = time.perf_counter()
            ver = None
            try:
                faults.check("serve_swap")
                ver = self._build_version(entry, model)
                report = self.canary_gate(ver.router)
                ver.canary = report
                if not report["ok"]:
                    raise SwapRejected(
                        f"swap of {name!r} rejected by the canary gate: "
                        f"{report.get('error') or report['checks']}", report)
                if self.swap_warmup:
                    # run every bucket before the flip, while the old
                    # version still serves
                    report["warmed_buckets"] = ver.router.warmup()
            except SwapRejected as exc:
                self._reject(entry, ver, exc.report, t0)
                raise
            except Exception as exc:  # noqa: BLE001 — injected or packing
                report = {"ok": False, "checks": {},
                          "error": f"{type(exc).__name__}: {exc}"}
                self._reject(entry, ver, report, t0)
                raise SwapRejected(
                    f"swap of {name!r} failed before the flip: "
                    f"{type(exc).__name__}: {exc}", report) from exc
            self._fresh_window(ver)
            # ---- atomic flip ----------------------------------------
            with self._lock:
                old = entry.live
                retired = entry.previous
                entry.previous = old
                if old is not None:
                    old.state = "previous"
                ver.state = "live"
                ver.baseline = ver.router.metrics.snapshot()
                if self.rollback_watch_s > 0:
                    ver.watch_until = time.monotonic() + self.rollback_watch_s
                entry.live = ver
                entry.swaps += 1
                entry.quality_breach = None
            if retired is not None:
                # the version two pushes back leaves the fleet
                retired.state = "retired"
                entry.history.append(retired.row())
                retired.router.close()
            ms = round((time.perf_counter() - t0) * 1e3, 1)
            self._event("serve_swap", model=name, ok=True,
                        from_version=(old.version if old else 0),
                        to_version=ver.version, ms=ms)
            log.info("registry: %r v%s -> v%d live (canary p99 %.3g ms, %s)",
                     name, old.version if old else "-", ver.version,
                     ver.canary.get("p99_ms") or 0,
                     f"{self.rollback_watch_s:g} s health watch"
                     if self.rollback_watch_s else "no health watch")
            if ver.watch_until is not None:
                self._start_watch(name, ver)
            return {"ok": True, "model": name,
                    "from_version": old.version if old else None,
                    "to_version": ver.version, "canary": ver.canary,
                    "ms": ms}

    def _reject(self, entry: _Entry, ver: Optional[_Version],
                report: dict, t0: float) -> None:
        with self._lock:
            entry.swaps_rejected += 1
        if ver is not None:
            ver.state = "rejected"
            entry.history.append(ver.row())
            ver.router.close()
        self._event("serve_swap", model=entry.name, ok=False,
                    to_version=ver.version if ver else 0,
                    ms=round((time.perf_counter() - t0) * 1e3, 1))
        log.warning("registry: swap of %r rejected (%s); the previous "
                    "version keeps serving", entry.name,
                    report.get("error") or report.get("checks"))

    # ------------------------------------------------------------------
    def rollback(self, name: str, reason: str = "manual") -> dict:
        """Flip back to the resident previous version at once; the bad
        version is closed."""
        entry = self._entry(name)
        with self._lock:
            if entry.previous is None:
                raise RuntimeError(
                    f"model {name!r} has no previous version resident")
            bad = entry.live
            entry.live = entry.previous
            entry.live.state = "live"
            entry.live.watch_until = None
            entry.previous = None
            entry.rollbacks += 1
            entry.quality_breach = None
        bad.state = "rolled_back"
        entry.history.append(bad.row())
        self._fresh_window(entry.live)
        self._event("serve_rollback", model=name, from_version=bad.version,
                    to_version=entry.live.version, reason=reason)
        log.warning("registry: rolled back %r v%d -> v%d (%s)", name,
                    bad.version, entry.live.version, reason)
        bad.router.close()
        return {"ok": True, "model": name, "from_version": bad.version,
                "to_version": entry.live.version, "reason": reason}

    # ------------------------------------------------------------------
    def check_postswap(self, name: str) -> Optional[dict]:
        """One post-swap health evaluation of the live version against
        its flip-time baseline: the rollback report when a threshold
        tripped (and the rollback ran), else a ``watching``/``clear``
        status.  Callable directly, as the tests do."""
        entry = self._entry(name)
        with self._lock:
            ver = entry.live
            if (ver is None or ver.baseline is None
                    or entry.previous is None):
                return None
            watching = (ver.watch_until is not None
                        and time.monotonic() < ver.watch_until)
        snap = ver.router.metrics.snapshot()
        base = ver.baseline
        ok_d = snap["ok"] - base["ok"]
        failed_d = snap["failed"] - base["failed"]
        total = ok_d + failed_d
        deg_d = snap["degraded_transitions"] - base["degraded_transitions"]
        burn = snap.get("slo_burn")
        reason = None
        if (total >= _POSTSWAP_MIN_REQUESTS
                and failed_d / total > self.rollback_error_rate):
            reason = (f"error_rate {failed_d}/{total} > "
                      f"{self.rollback_error_rate:g}")
        elif deg_d >= self.rollback_degraded:
            reason = (f"degraded_transitions {deg_d} >= "
                      f"{self.rollback_degraded}")
        elif (self.rollback_slo_burn > 0 and burn is not None
                and burn > self.rollback_slo_burn):
            reason = f"slo_burn {burn:g} > {self.rollback_slo_burn:g}"
        # the drift and quality breaches annotate the report, and roll
        # back only on the tpu_serve_rollback_on_drift opt-in
        drift_mon = ver.router.drift
        drift_breach = drift_mon.breach if drift_mon is not None else None
        quality_breach = entry.quality_breach
        if reason is None and self.rollback_on_drift:
            if drift_breach is not None:
                worst = max(float(drift_breach.get("psi_max") or 0.0),
                            float(drift_breach.get("pred_psi") or 0.0))
                reason = (f"drift_psi {worst:g} > "
                          f"{drift_breach.get('threshold'):g}")
            elif quality_breach is not None:
                reason = (f"quality_drop auc_delta "
                          f"{quality_breach.get('auc_delta')}")
        if reason is not None:
            return self.rollback(name, reason=f"auto: {reason}")
        out = {"ok": True, "status": "watching" if watching else "clear",
               "requests": total, "failed": failed_d,
               "degraded_transitions": deg_d, "slo_burn": burn}
        if drift_breach is not None:
            out["drift_breach"] = drift_breach
        if quality_breach is not None:
            out["quality_breach"] = quality_breach
        return out

    def note_quality_breach(self, name: Optional[str], info: dict) -> None:
        """Latch a rolling-quality breach (``serve/quality.py``) for the
        post-swap watch.  An unknown name is ignored: the quality tracker
        never takes its feed down."""
        try:
            entry = self._entry(name)
        except UnknownModelError:
            return
        entry.quality_breach = dict(info)
        log.warning("registry: quality breach latched on %r (%s)",
                    entry.name, info.get("auc_delta"))

    def _start_watch(self, name: str, ver: _Version) -> None:
        """Background post-swap watcher: polls ``check_postswap`` until
        the window closes, the version is replaced or a rollback fires.
        A daemon thread: a hung fleet never blocks process exit."""
        interval = max(min(self.rollback_watch_s / 10.0, 2.0), 0.05)

        def watch():
            while True:
                time.sleep(interval)
                entry = self._models.get(name)
                if entry is None or entry.live is not ver:
                    return
                if (ver.watch_until is None
                        or time.monotonic() >= ver.watch_until):
                    return
                try:
                    out = self.check_postswap(name)
                except Exception as exc:  # noqa: BLE001 — die quietly
                    log.warning("registry: post-swap watch of %r failed "
                                "(%s: %s)", name, type(exc).__name__, exc)
                    return
                if out is not None and out.get("reason"):
                    return

        threading.Thread(target=watch, daemon=True,
                         name=f"lgbm-swap-watch-{name}").start()

    # ------------------------------------------------------------------
    def _entry(self, name: Optional[str]) -> _Entry:
        key = name or self._default
        if key is None or key not in self._models:
            raise UnknownModelError(name or "<default>")
        return self._models[key]

    def resolve(self, name: Optional[str]) -> _Version:
        """The live version serving ``name`` (None: the default model)."""
        entry = self._entry(name)
        with self._lock:
            ver = entry.live
        if ver is None:
            raise UnknownModelError(name or "<default>")
        return ver

    @property
    def default(self) -> Optional[str]:
        return self._default

    def models(self) -> List[dict]:
        """One row per registered model (GET /models)."""
        with self._lock:
            entries = list(self._models.values())
        return [{
            "name": e.name,
            "default": e.name == self._default,
            "live_version": e.live.version if e.live else None,
            "previous_version": e.previous.version if e.previous else None,
            "swaps": e.swaps,
            "swaps_rejected": e.swaps_rejected,
            "rollbacks": e.rollbacks,
            # live plus rollback-held device bytes
            "resident_bytes": sum(int(v.router.resident_bytes())
                                  for v in (e.live, e.previous)
                                  if v is not None),
            "drift": (e.live.router.drift.status()
                      if e.live and e.live.router.drift is not None
                      else None),
            "quality_breach": e.quality_breach,
            "versions": ([e.live.row()] if e.live else [])
            + ([e.previous.row()] if e.previous else []) + e.history[-4:],
        } for e in entries]

    def submit(self, X, model: Optional[str] = None, **kw):
        # registered versions shadow arena tenants of the same name
        if (self.arena is not None and model is not None
                and model not in self._models and self.arena.has(model)):
            return self.arena.submit(X, model=model, **kw)
        return self.resolve(model).router.submit(X, **kw)

    def submit_explain(self, X, model: Optional[str] = None, **kw):
        return self.resolve(model).router.submit_explain(X, **kw)

    def result(self, ticket, timeout: Optional[float] = None):
        # a RoutedTicket carries its issuing router, so a ticket submitted
        # before a flip completes against the version that issued it;
        # arena tickets redeem against the arena
        router = getattr(ticket, "router", None)
        if router is None and self.arena is not None:
            return self.arena.result(ticket, timeout)
        return router.result(ticket, timeout)

    def stats(self) -> dict:
        with self._lock:
            live = {name: (e.live.router if e.live else None)
                    for name, e in self._models.items()}
        return {m["name"]: dict(
            m, live=(live[m["name"]].stats()
                     if live.get(m["name"]) is not None else None))
            for m in self.models() if m["name"] in live}

    def close(self) -> None:
        with self._lock:
            entries = list(self._models.values())
            self._models.clear()
            self._default = None
            arena, self.arena = self.arena, None
        for e in entries:
            for v in (e.live, e.previous):
                if v is not None:
                    v.router.close()
        if arena is not None:
            arena.close()

    def __enter__(self) -> "ModelRegistry":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
