"""Replica router: N ``PredictorSession`` replicas behind one surface
(counterpart of lightgbm_tpu/serve/router.py).

One session is one batcher thread and one degradation state, a single
point of failure.  The router fronts ``n_replicas`` sessions packed from
the same model version, so a wedged replica costs capacity, not
availability:

- **placement** — replica i lives on
  ``cuda:(i % torch.cuda.device_count())``; on one card every replica
  shares ``cuda:0`` (as the JAX package's replicas share its one device),
  each with its own forest copy and batcher thread; CPU sessions all live
  on the CPU.
- **health-based routing** — submits go to the routable replica with the
  shallowest batcher queue; draining and breaker-open replicas are
  skipped.
- **per-replica circuit breakers** — ``robust/watchdog.py CircuitBreaker``.
  A replica whose dispatch fails trips its breaker and drops out of the
  routing set; after the backoff one half-open probe request is let
  through, and a success closes the breaker again.  A degraded session
  refuses work at submit (``DeviceFailed``), which counts as such a
  failure.
- **failover** — a submit that fails on one replica is retried on the
  next routable one before the caller sees an error; only when every
  replica rejects does the router raise (an all-overloaded fleet raises
  ``ServeOverloadError``, a fleet with none routable
  ``NoReplicaAvailable``).  A request whose device batch failed after it
  was queued fails with ``DeviceFailed``: it is not run again.
- **draining** — ``drain(i)`` takes a replica out of the routing set
  without killing its in-flight work.

The router duck-types the session surface the HTTP front end consumes
(``submit``/``submit_explain``/``result``/``predict``/``explain``/
``stats``/``metrics``/``warmup``/``close``).  All replicas of one version
share one ``ServeMetrics`` and one ``DriftMonitor`` (``drift``, armed by
the model file's quality sidecar), so one sketch covers the version's
traffic.  Fleet transitions are telemetry events, also kept in
``events``.  Every dispatch passes the fault points
``serve_replica`` and ``serve_replica_{i}`` (``robust/faults.py``).
"""
from __future__ import annotations

import itertools
import threading
import time
from concurrent.futures import TimeoutError as _FutureTimeout
from typing import List, Optional

import numpy as np
import torch

from .. import obs
from ..robust import faults
from ..robust.watchdog import CircuitBreaker
from ..utils import log
from .batcher import DeadlineExceeded, ServeOverloadError
from .metrics import ServeMetrics, percentile
from .session import PredictorSession, Ticket


class NoReplicaAvailable(ServeOverloadError):
    """Every replica is breaker-open or draining: the fleet has no
    routable capacity.  A ``ServeOverloadError``, so the HTTP edge maps it
    to 503 with ``Retry-After``."""


class RoutedTicket:
    """A session ticket plus the fleet identity that resolves it: the
    replica that runs it and the model version it answers from."""

    __slots__ = ("inner", "replica", "model", "version", "router")

    def __init__(self, inner: Ticket, replica: "Replica",
                 model: Optional[str], version: Optional[int],
                 router: Optional["ReplicaRouter"] = None):
        self.inner = inner
        self.replica = replica
        self.model = model
        self.version = version
        self.router = router

    @property
    def rows(self) -> int:
        return self.inner.rows

    @property
    def parts(self):
        return self.inner.parts

    @property
    def kind(self) -> str:
        return self.inner.kind


class Replica:
    """One session, its breaker and its drain flag."""

    def __init__(self, idx: int, session: PredictorSession,
                 breaker: CircuitBreaker):
        self.idx = idx
        self.session = session
        self.breaker = breaker
        self.draining = False

    @property
    def routable(self) -> bool:
        return not self.draining and self.breaker.allow()

    def stats_row(self) -> dict:
        st = self.session.stats()
        return {
            "replica": f"r{self.idx}",
            "device": st["device"],
            "healthy": (not self.draining
                        and self.breaker.state == "closed"
                        and not st["degraded"]),
            "draining": self.draining,
            "degraded": st["degraded"],
            "explain_degraded": st["explain_degraded"],
            "breaker": self.breaker.snapshot(),
            "queue_rows": st["queue_rows"],
            "requests": st["requests"],
            "batches": st["batches"],
            "buckets": st["buckets"],
            "uptime_s": st["uptime_s"],
        }


def replica_devices(n: int, device) -> list:
    """Replica i's device: ``cuda:i % device_count`` for a CUDA fleet,
    else ``device`` for every replica."""
    device = torch.device(device)
    if device.type != "cuda":
        return [device] * n
    count = max(torch.cuda.device_count(), 1)
    return [torch.device(f"cuda:{i % count}") for i in range(n)]


class ReplicaRouter:
    """Health-routed fleet of replicas serving one model version."""

    def __init__(self, model, n_replicas: int = 2, config=None,
                 name: Optional[str] = None,
                 version: Optional[int] = None,
                 metrics: Optional[ServeMetrics] = None,
                 sessions: Optional[List[PredictorSession]] = None,
                 **session_kw):
        self.name = name
        self.version = version
        # the model source and build inputs, so restart_replica can boot a
        # replacement (caller-built session lists have no source)
        self._model_src = model if sessions is None else None
        self._config = config
        self._session_kw = dict(session_kw)
        if sessions is None:
            n = max(int(n_replicas), 1)
            base = self._session_kw.pop("device", None)
            if base is None:
                base = getattr(config, "device_type", None) or "cuda"
            from ..basic import resolve_device
            devices = replica_devices(n, resolve_device(base))
            from ..obs.drift import DriftMonitor
            shared_drift = DriftMonitor.maybe_load(model, config)
            sessions = []
            try:
                for i in range(n):
                    sessions.append(PredictorSession(
                        model, config=config, metrics=metrics,
                        device=devices[i], drift=shared_drift,
                        **self._session_kw))
            except BaseException:
                for s in sessions:
                    s.close()
                raise
        if not sessions:
            raise ValueError("router needs at least one replica")
        # replicas share the first session's metrics unless the caller
        # gave one (the registry gives each version a fresh instance)
        self.metrics = metrics if metrics is not None \
            else sessions[0].metrics
        cfg = sessions[0].config
        self._trip = int(cfg.tpu_serve_breaker_trip or 3)
        self._backoff = float(cfg.tpu_serve_breaker_backoff_s or 0.5)
        # one monitor for the version: replica 0's (sessions built by the
        # caller may each have armed their own)
        self.drift = sessions[0]._drift
        self.replicas = []
        for i, s in enumerate(sessions):
            s.model_name = self.name
            s.model_version = self.version
            s.replica_id = f"r{i}"
            s.metrics = self.metrics
            s._drift = self.drift
            self.replicas.append(Replica(i, s, self._breaker(i)))
        if self.drift is not None:
            self.drift.model_name = self.name or "default"
            self.drift.model_version = int(self.version or 0)
        self._rr = itertools.count()
        self._lock = threading.Lock()
        self.failovers = 0
        self.events: list = []
        self._t_start = time.time()

    def _event(self, name: str, **fields) -> None:
        self.events.append(dict(fields, event=name, t=time.time()))
        obs.event(name, **fields)

    def _breaker(self, idx: int) -> CircuitBreaker:
        return CircuitBreaker(trip_after=self._trip,
                              backoff_base_s=self._backoff, seed=idx)

    # ---- session-surface passthroughs --------------------------------
    @property
    def session(self) -> PredictorSession:
        """The first replica's session (canary and introspection)."""
        return self.replicas[0].session

    def __getattr__(self, item):
        # static model facts (num_features, num_tpi, num_trees, max_batch,
        # explain_enabled, ...) are the same on every replica
        if "replicas" not in self.__dict__:   # guard __init__ recursion
            raise AttributeError(item)
        return getattr(self.replicas[0].session, item)

    def warmup(self) -> int:
        return sum(r.session.warmup() for r in self.replicas)

    def warmup_explain(self) -> int:
        return sum(r.session.warmup_explain() for r in self.replicas)

    # ---- routing ------------------------------------------------------
    def _candidates(self) -> List[Replica]:
        """Routable replicas, shallowest queue first (round-robin among
        equals).  A replica whose breaker just went half-open sorts first:
        its one probe request must reach it, or a healthier sibling takes
        every request and the breaker never closes."""
        rot = next(self._rr) % max(len(self.replicas), 1)
        order = self.replicas[rot:] + self.replicas[:rot]
        avail = [r for r in order if r.routable]
        avail.sort(key=lambda r: (0 if r.breaker.state == "half_open"
                                  else 1, r.session._batcher.queue_rows))
        return avail

    def _dispatch(self, kind: str, X, **kw) -> RoutedTicket:
        priority = str(kw.get("priority") or "normal")
        cands = self._candidates()
        if not cands:
            self.metrics.count_shed(priority)
            raise NoReplicaAvailable(
                f"no routable replica ({len(self.replicas)} total, all "
                "breaker-open or draining)", priority=priority)
        last_exc: Optional[BaseException] = None
        for rep in cands:
            try:
                faults.check("serve_replica")
                faults.check(f"serve_replica_{rep.idx}")
                fn = (rep.session.submit if kind == "predict"
                      else rep.session.submit_explain)
                ticket = fn(X, **kw)
                rep.breaker.record_ok()
                return RoutedTicket(ticket, rep, self.name, self.version,
                                    router=self)
            except ServeOverloadError as exc:
                # a full queue on one replica is load, not sickness: no
                # breaker strike, spill to the next replica
                last_exc = exc
            except (ValueError, TypeError) as exc:
                raise    # the request is at fault, not the replica
            except Exception as exc:  # noqa: BLE001 — the failover point
                last_exc = exc
                cls = rep.breaker.record_failure(exc)
                with self._lock:
                    self.failovers += 1
                self._event("serve_failover", replica=rep.idx,
                            classify=cls, breaker=rep.breaker.state,
                            error=f"{type(exc).__name__}: {exc}")
                log.warning("serve router: replica r%d %s failure (%s: %s); "
                            "breaker %s; failing over", rep.idx, cls,
                            type(exc).__name__, exc, rep.breaker.state)
        if isinstance(last_exc, ServeOverloadError):
            # the client-visible shed is counted here, once
            self.metrics.count_shed(getattr(last_exc, "priority", None)
                                    or priority)
        elif last_exc is not None:
            # every replica refused: one failed request of the fleet
            (self.metrics.observe if kind == "predict"
             else self.metrics.observe_explain)(0.0, ok=False)
        raise last_exc if last_exc is not None else NoReplicaAvailable(
            "no replica accepted the request")

    def submit(self, X, **kw) -> RoutedTicket:
        return self._dispatch("predict", X, **kw)

    def submit_explain(self, X, **kw) -> RoutedTicket:
        return self._dispatch("explain", X, **kw)

    def result(self, ticket, timeout: Optional[float] = None) -> np.ndarray:
        if not isinstance(ticket, RoutedTicket):
            # a bare ticket can only come from replica 0's session surface
            return self.replicas[0].session.result(ticket, timeout)
        try:
            out = ticket.replica.session.result(ticket.inner, timeout)
        except Exception as exc:
            if not isinstance(exc, (DeadlineExceeded, _FutureTimeout,
                                    ServeOverloadError)):
                # a worker-side failure is a replica-health signal; a
                # deadline or timeout is the caller's budget
                ticket.replica.breaker.record_failure(exc)
            raise
        ticket.replica.breaker.record_ok()
        return out

    def predict(self, X, raw_score: bool = False) -> np.ndarray:
        return self.result(self.submit(X, raw_score=raw_score))

    def explain(self, X) -> np.ndarray:
        return self.result(self.submit_explain(X))

    # ---- fleet management --------------------------------------------
    def drain(self, idx: int) -> None:
        self.replicas[idx].draining = True
        self._event("serve_drain", replica=idx, draining=True)

    def undrain(self, idx: int) -> None:
        self.replicas[idx].draining = False
        self._event("serve_drain", replica=idx, draining=False)

    def restart_replica(self, idx: int) -> dict:
        """Replace one replica in place: a new ``PredictorSession`` packed
        from the router's model source on the same device, a fresh
        breaker, the shared metrics.  In-flight work of the old replica
        drains (its batcher finishes its queue on close)."""
        if self._model_src is None:
            raise RuntimeError(
                "router built from caller-provided sessions has no model "
                "source to restart a replica from")
        rep = self.replicas[idx]
        rep.draining = True          # out of the routing set now
        t0 = time.perf_counter()
        sess = PredictorSession(self._model_src, config=self._config,
                                metrics=self.metrics,
                                device=rep.session.device,
                                drift=self.drift, **self._session_kw)
        sess.model_name = self.name
        sess.model_version = self.version
        sess.replica_id = f"r{idx}"
        old = rep.session
        self.replicas[idx] = Replica(idx, sess, self._breaker(idx))
        try:
            old.close()
        except Exception as exc:  # noqa: BLE001 — the replacement is live
            log.warning("restart_replica(%d): closing the old session "
                        "failed (%s: %s)", idx, type(exc).__name__, exc)
        boot = {"replica": idx,
                "boot_ms": round((time.perf_counter() - t0) * 1e3, 3)}
        self._event("serve_replica_restart", **boot)
        log.info("router: replica r%d restarted in %.1f ms", idx,
                 boot["boot_ms"])
        return boot

    def routable_count(self) -> int:
        return sum(1 for r in self.replicas
                   if not r.draining and r.breaker.state != "open")

    def stats(self) -> dict:
        """Fleet stats in the single-session shape (``render_prometheus``
        and ``/health`` read it), plus the per-replica rows."""
        rows = [r.stats_row() for r in self.replicas]
        per = [r.session.stats() for r in self.replicas]
        agg = {}
        for key in ("requests", "ok", "failed", "deadline_missed",
                    "overloads", "batches", "rows", "padded_rows",
                    "explain_requests", "explain_ok", "explain_batches",
                    "explain_rows", "explain_padded_rows", "queue_rows",
                    "explain_deadline_missed"):
            agg[key] = sum(int(s.get(key) or 0) for s in per)
        all_lat, all_xlat = [], []
        for r in self.replicas:
            with r.session._lock:    # the reservoirs change under it
                all_lat.extend(r.session._lat_ms)
                all_xlat.extend(r.session._xlat_ms)
        all_lat.sort()
        all_xlat.sort()
        agg["p50_ms"] = percentile(all_lat, 0.50)
        agg["p99_ms"] = percentile(all_lat, 0.99)
        agg["explain_p50_ms"] = percentile(all_xlat, 0.50)
        agg["explain_p99_ms"] = percentile(all_xlat, 0.99)
        agg["explain_occupancy"] = (
            round(agg["explain_rows"] / agg["explain_padded_rows"], 4)
            if agg["explain_padded_rows"] else None)
        agg["explain_buckets"] = sorted(
            {b for s in per for b in s["explain_buckets"]})
        agg["explain_max_batch"] = per[0]["explain_max_batch"]
        agg["occupancy"] = (round(agg["rows"] / agg["padded_rows"], 4)
                            if agg["padded_rows"] else None)
        agg["buckets"] = sorted({b for s in per for b in s["buckets"]})
        agg["degraded"] = all(s["degraded"] for s in per)
        agg["any_degraded"] = any(s["degraded"] for s in per)
        agg["explain_degraded"] = all(s["explain_degraded"] for s in per)
        agg["degraded_transitions"] = self.metrics.degraded_transitions
        agg["recoveries"] = self.metrics.recoveries
        agg["slo_p99_ms"] = per[0]["slo_p99_ms"]
        agg["slo_burn"] = self.metrics.slo_burn()
        agg["uptime_s"] = round(time.time() - self._t_start, 1)
        for key in ("trees", "num_class", "num_features", "max_batch",
                    "explain_enabled"):
            agg[key] = per[0][key]
        agg["explain_armed"] = any(s["explain_armed"] for s in per)
        agg["model"] = self.name
        agg["version"] = self.version
        agg["n_replicas"] = len(self.replicas)
        agg["routable_replicas"] = self.routable_count()
        agg["failovers"] = self.failovers
        agg["resident_bytes"] = self.resident_bytes()
        agg["drift"] = (self.drift.status() if self.drift is not None
                        else None)
        agg["graph_captures"] = sum(int(s.get("graph_captures") or 0)
                                    for s in per)
        # the replicas share one store directory; each counts its own loads
        aots = [s["aot"] for s in per if s.get("aot")]
        agg["aot"] = (None if not aots else {
            **aots[0], **{k: sum(int(a[k]) for a in aots)
                          for k in ("loaded", "saved", "fallbacks",
                                    "save_errors")}})
        agg["replicas"] = rows
        return agg

    def resident_bytes(self) -> int:
        """Device bytes of this version's replicas (each packs its own
        forest, so a sum even on a shared card)."""
        return sum(int(r.session.resident_bytes()) for r in self.replicas)

    def close(self) -> None:
        for r in self.replicas:
            r.session.close()

    def __enter__(self) -> "ReplicaRouter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
