"""Live serving metrics: counters + a fixed-bucket latency histogram,
exposed as Prometheus text (``GET /metrics``) and JSON (``GET /stats``)
(counterpart of lightgbm_tpu/serve/metrics.py).

Lock-cheap by construction: every observation is a handful of integer
bumps under one small lock plus a bounded ring append — no JSONL
readback, no sort on the hot path (percentile-ish questions are answered
from the fixed histogram buckets and the recent-window ring at SCRAPE
time).  The SLO-burn gauge follows the standard error-budget framing:
with a p99 objective of ``slo_p99_ms``, 1% of requests are allowed over
the target; ``slo_burn`` is (observed over-target fraction in the recent
window) / 1%, so 1.0 means burning budget exactly at the allowed rate
and >1 means the SLO is being violated.

``parse_prometheus`` is the minimal text-format parser the tests and
``chip_smoke.py`` use to read the exposition back.

The drift series (``tpu_serve_drift_*``) render where a model's drift
monitor is armed, and the online loop's (``tpu_online_*``) where a loop
has parked its stats on the registry (``online/loop.py run_online``).
Series the port cannot fill are left out, not reported as zero: the
recompile counter (the port compiles nothing per bucket) and the AOT
store's series (ROADMAP.md "serve AOT store").
"""
from __future__ import annotations

import math
import threading
from collections import deque
from typing import Dict, List, Optional

# Prometheus-convention cumulative buckets, in milliseconds.  Fixed at
# import so every replica's histograms aggregate; +Inf is implicit.
LATENCY_BUCKETS_MS = (1.0, 2.0, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0,
                      500.0, 1000.0, 2500.0, 5000.0)

_SLO_WINDOW = 1024     # recent requests the burn gauge is computed over
_ERROR_BUDGET = 0.01   # a p99 objective tolerates 1% over-target


def percentile(sorted_vals: List[float], p: float):
    """Nearest-rank percentile (rank ceil(p*n), 1-indexed) of a sorted
    list, rounded to 3 places: the JAX package's latency definition
    (lightgbm_tpu/obs/report.py ``percentile``), shared by every
    ``stats()`` of the serving stack."""
    if not sorted_vals:
        return None
    n = len(sorted_vals)
    i = min(max(math.ceil(p * n) - 1, 0), n - 1)
    return round(sorted_vals[i], 3)


class ServeMetrics:
    """Request-level counters for one serving session."""

    def __init__(self, slo_p99_ms: float = 0.0):
        self.slo_p99_ms = max(float(slo_p99_ms or 0.0), 0.0)
        self._lock = threading.Lock()
        self._buckets = [0] * (len(LATENCY_BUCKETS_MS) + 1)  # last = +Inf
        self._lat_sum = 0.0
        self._lat_count = 0
        self._ok = 0
        self._failed = 0
        # explanation requests get their own histogram + outcome
        # counters: a TreeSHAP row costs O(leaves x depth^2) vs the
        # predictor's O(depth), so folding both into one latency
        # distribution would make either signal unreadable
        self._x_buckets = [0] * (len(LATENCY_BUCKETS_MS) + 1)
        self._x_lat_sum = 0.0
        self._x_lat_count = 0
        self._x_ok = 0
        self._x_failed = 0
        self._status: Dict[int, int] = {}
        # priority-class accounting for load shedding (serve/batcher.py
        # PRIORITIES): served vs shed per class is the evidence that
        # overload dropped low-priority traffic first
        self._served: Dict[str, int] = {}
        self._shed: Dict[str, int] = {}
        self._recent = deque(maxlen=_SLO_WINDOW)
        # degradation is a recoverable state (serve/session.py re-probes
        # the device), so the gauge needs transition counters beside it:
        # how many times the device path went down, and how many times the
        # probe brought it back
        self._degraded = False
        self._degraded_transitions = 0
        self._recoveries = 0

    # ---- hot path ----------------------------------------------------
    @staticmethod
    def _bucket_index(ms: float) -> int:
        """Index into LATENCY_BUCKETS_MS (+1 overflow slot) — the ONE
        copy of the histogram bucketing rule, shared by the predict and
        explain observers so the two histograms cannot drift."""
        i = 0
        for b in LATENCY_BUCKETS_MS:
            if ms <= b:
                break
            i += 1
        return i

    def observe(self, latency_ms: float, ok: bool = True) -> None:
        """Account one finished request (any outcome)."""
        ms = float(latency_ms)
        i = self._bucket_index(ms)
        with self._lock:
            self._buckets[i] += 1
            self._lat_sum += ms
            self._lat_count += 1
            if ok:
                self._ok += 1
            else:
                self._failed += 1
            self._recent.append(ms)

    def observe_explain(self, latency_ms: float, ok: bool = True) -> None:
        """Account one finished explanation request (any outcome)."""
        ms = float(latency_ms)
        i = self._bucket_index(ms)
        with self._lock:
            self._x_buckets[i] += 1
            self._x_lat_sum += ms
            self._x_lat_count += 1
            if ok:
                self._x_ok += 1
            else:
                self._x_failed += 1

    def count_status(self, code: int) -> None:
        """Bump the HTTP-status counter (server front end only)."""
        code = int(code)
        with self._lock:
            self._status[code] = self._status.get(code, 0) + 1

    def count_served(self, priority: str) -> None:
        """One successfully served request of this priority class."""
        p = str(priority or "normal")
        with self._lock:
            self._served[p] = self._served.get(p, 0) + 1

    def count_shed(self, priority: str) -> None:
        """One request rejected by overload/shedding in this class."""
        p = str(priority or "normal")
        with self._lock:
            self._shed[p] = self._shed.get(p, 0) + 1

    def set_degraded(self, flag: bool) -> None:
        """Record a degradation-state transition (the session's device
        path went down, or a successful device re-probe recovered it)."""
        flag = bool(flag)
        with self._lock:
            if flag and not self._degraded:
                self._degraded_transitions += 1
            elif not flag and self._degraded:
                self._recoveries += 1
            self._degraded = flag

    @property
    def degraded_transitions(self) -> int:
        with self._lock:
            return self._degraded_transitions

    @property
    def recoveries(self) -> int:
        with self._lock:
            return self._recoveries

    # ---- scrape time -------------------------------------------------
    def slo_burn(self) -> Optional[float]:
        """Error-budget burn rate over the recent window (None when no
        SLO is configured, 0.0 when nothing was served yet)."""
        if not self.slo_p99_ms:
            return None
        with self._lock:
            recent = list(self._recent)
        if not recent:
            return 0.0
        over = sum(1 for v in recent if v > self.slo_p99_ms)
        return round((over / len(recent)) / _ERROR_BUDGET, 3)

    def snapshot(self) -> dict:
        burn = self.slo_burn()
        with self._lock:
            cum, total = [], 0
            for c in self._buckets:
                total += c
                cum.append(total)
            x_cum, x_total = [], 0
            for c in self._x_buckets:
                x_total += c
                x_cum.append(x_total)
            return {
                "latency_buckets_ms": list(LATENCY_BUCKETS_MS),
                "latency_cumulative": cum,
                "latency_sum_ms": round(self._lat_sum, 3),
                "latency_count": self._lat_count,
                "ok": self._ok,
                "failed": self._failed,
                "explain_latency_cumulative": x_cum,
                "explain_latency_sum_ms": round(self._x_lat_sum, 3),
                "explain_latency_count": self._x_lat_count,
                "explain_ok": self._x_ok,
                "explain_failed": self._x_failed,
                "status": dict(sorted(self._status.items())),
                "served_by_priority": dict(sorted(self._served.items())),
                "shed_by_priority": dict(sorted(self._shed.items())),
                "slo_p99_ms": self.slo_p99_ms or None,
                "slo_burn": burn,
                "degraded": self._degraded,
                "degraded_transitions": self._degraded_transitions,
                "recoveries": self._recoveries,
            }


def _fmt(v) -> str:
    if v is None:
        return "0"
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, float) and v.is_integer():
        return str(int(v))
    return repr(v) if isinstance(v, float) else str(v)


def _arena_series(out, head, ast) -> None:
    """Render one forest-arena stats dict (serve/arena.py
    ``ForestArena.stats()``) as the ``tpu_serve_arena_*`` series."""
    head("tpu_serve_arena_tenants", "gauge",
         "Tenant models known to the arena (resident + evicted).")
    out.append("tpu_serve_arena_tenants %d" % int(ast.get("tenants")
                                                  or 0))
    head("tpu_serve_arena_resident", "gauge",
         "Tenant models currently packed into the device arena.")
    out.append("tpu_serve_arena_resident %d" % int(ast.get("resident")
                                                   or 0))
    head("tpu_serve_arena_bytes", "gauge",
         "Device bytes of the packed multi-tenant forest.")
    out.append("tpu_serve_arena_bytes %d" % int(ast.get("packed_bytes")
                                                or 0))
    head("tpu_serve_arena_budget_bytes", "gauge",
         "Configured arena residency budget (tpu_serve_arena_bytes; "
         "0 = unbounded).")
    out.append("tpu_serve_arena_budget_bytes %d"
               % int(ast.get("budget_bytes") or 0))
    head("tpu_serve_arena_evictions_total", "counter",
         "Tenants LRU-evicted from the arena (budget pressure or "
         "manual).")
    out.append("tpu_serve_arena_evictions_total %d"
               % int(ast.get("evictions") or 0))
    head("tpu_serve_arena_readmissions_total", "counter",
         "Evicted tenants transparently repacked on their next "
         "request.")
    out.append("tpu_serve_arena_readmissions_total %d"
               % int(ast.get("readmissions") or 0))
    head("tpu_serve_arena_repacks_total", "counter",
         "Arena pack generations built (admissions, evictions, swaps).")
    out.append("tpu_serve_arena_repacks_total %d"
               % int(ast.get("repacks") or 0))
    head("tpu_serve_arena_batches_total", "counter",
         "Coalesced arena batches executed.")
    out.append("tpu_serve_arena_batches_total %d"
               % int(ast.get("batches") or 0))
    head("tpu_serve_arena_cross_model_batches_total", "counter",
         "Arena batches that coalesced requests for more than one "
         "tenant into a single device launch.")
    out.append("tpu_serve_arena_cross_model_batches_total %d"
               % int(ast.get("cross_model_batches") or 0))
    head("tpu_serve_arena_occupancy", "gauge",
         "Real rows / padded rows across arena launches.")
    out.append("tpu_serve_arena_occupancy %s"
               % _fmt(ast.get("occupancy")))
    head("tpu_serve_arena_requests_total", "counter",
         "Requests answered by the arena, by outcome.")
    out.append('tpu_serve_arena_requests_total{outcome="ok"} %d'
               % int(ast.get("ok") or 0))
    out.append('tpu_serve_arena_requests_total{outcome="deadline"} %d'
               % int(ast.get("deadline_missed") or 0))
    out.append('tpu_serve_arena_requests_total{outcome="overload"} %d'
               % int(ast.get("overloads") or 0))


# the drift monitor's score keys, one series label each
_DRIFT_KINDS = ("psi_max", "psi_mean", "ks_max", "pred_psi", "pred_ks")


def _drift_series(out, head, dr) -> None:
    """One drift monitor's ``status()`` as the ``tpu_serve_drift_*``
    series; ``head`` writes HELP/TYPE (once, for a fleet's models)."""
    model = dr.get("model") or "default"
    version = int(dr.get("version") or 0)
    scores = dr.get("scores") or {}
    head("tpu_serve_drift_score", "gauge",
         "Live-traffic drift vs the training reference from the last "
         "cadence check (PSI/KS over feature bins and the prediction "
         "histogram, by kind).")
    for kind in _DRIFT_KINDS:
        out.append(
            'tpu_serve_drift_score{model="%s",version="%d",kind="%s"} %s'
            % (model, version, kind, _fmt(scores.get(kind))))
    head("tpu_serve_drift_rows", "gauge",
         "Rows accumulated in the live drift sketch since the last "
         "reset, by stream (feat = sampled feature rows, pred = scored "
         "responses).")
    for kind in ("feat", "pred"):
        out.append(
            'tpu_serve_drift_rows{model="%s",version="%d",kind="%s"} %d'
            % (model, version, kind, int(dr.get(kind + "_rows") or 0)))
    head("tpu_serve_drift_breach", "gauge",
         "1 while a drift breach is latched (PSI above "
         "tpu_drift_psi_warn at the last cadence check).")
    out.append('tpu_serve_drift_breach{model="%s",version="%d"} %d'
               % (model, version, 1 if dr.get("breach") else 0))


def render_prometheus(session) -> str:
    """Prometheus text exposition for one session (its ``ServeMetrics``
    plus the live gauges out of ``session.stats()``)."""
    m: ServeMetrics = session.metrics
    snap = m.snapshot()
    st = session.stats()
    out = []

    def head(name, kind, help_):
        out.append(f"# HELP {name} {help_}")
        out.append(f"# TYPE {name} {kind}")

    head("tpu_serve_requests_total", "counter",
         "Requests by HTTP status (front end).")
    for code, n in (snap["status"] or {200: 0}).items():
        out.append('tpu_serve_requests_total{status="%s"} %d' % (code, n))
    head("tpu_serve_session_requests_total", "counter",
         "Session-level requests by outcome.")
    out.append('tpu_serve_session_requests_total{outcome="ok"} %d'
               % snap["ok"])
    out.append('tpu_serve_session_requests_total{outcome="failed"} %d'
               % snap["failed"])
    head("tpu_serve_request_latency_ms", "histogram",
         "Request latency (submit to result), milliseconds.")
    for b, c in zip(LATENCY_BUCKETS_MS, snap["latency_cumulative"]):
        out.append('tpu_serve_request_latency_ms_bucket{le="%g"} %d'
                   % (b, c))
    out.append('tpu_serve_request_latency_ms_bucket{le="+Inf"} %d'
               % snap["latency_count"])
    out.append("tpu_serve_request_latency_ms_sum %s"
               % _fmt(snap["latency_sum_ms"]))
    out.append("tpu_serve_request_latency_ms_count %d"
               % snap["latency_count"])
    head("tpu_serve_explain_requests_total", "counter",
         "Explanation requests by outcome (POST /explain).")
    out.append('tpu_serve_explain_requests_total{outcome="ok"} %d'
               % snap["explain_ok"])
    out.append('tpu_serve_explain_requests_total{outcome="failed"} %d'
               % snap["explain_failed"])
    head("tpu_serve_explain_latency_ms", "histogram",
         "Explanation request latency (submit to result), milliseconds.")
    for b, c in zip(LATENCY_BUCKETS_MS, snap["explain_latency_cumulative"]):
        out.append('tpu_serve_explain_latency_ms_bucket{le="%g"} %d'
                   % (b, c))
    out.append('tpu_serve_explain_latency_ms_bucket{le="+Inf"} %d'
               % snap["explain_latency_count"])
    out.append("tpu_serve_explain_latency_ms_sum %s"
               % _fmt(snap["explain_latency_sum_ms"]))
    out.append("tpu_serve_explain_latency_ms_count %d"
               % snap["explain_latency_count"])
    # priority-class shedding (serve/batcher.py): served vs shed per
    # class — every class is rendered even at 0 so a scrape series never
    # appears mid-overload
    from .batcher import PRIORITIES
    head("tpu_serve_served_total", "counter",
         "Successfully served requests by priority class.")
    for p in PRIORITIES:
        out.append('tpu_serve_served_total{priority="%s"} %d'
                   % (p, snap["served_by_priority"].get(p, 0)))
    head("tpu_serve_shed_total", "counter",
         "Requests rejected by overload shedding, by priority class "
         "(low sheds first).")
    for p in PRIORITIES:
        out.append('tpu_serve_shed_total{priority="%s"} %d'
                   % (p, snap["shed_by_priority"].get(p, 0)))

    gauges = (
        ("tpu_serve_queue_rows", "gauge", "Rows waiting in the batcher "
         "queue.", st.get("queue_rows")),
        ("tpu_serve_batch_occupancy", "gauge", "Real rows / padded rows "
         "over the session lifetime.", st.get("occupancy")),
        ("tpu_serve_pad_waste_rows_total", "counter", "Padded minus real "
         "rows dispatched to the device.",
         max(int(st.get("padded_rows") or 0) - int(st.get("rows") or 0), 0)),
        ("tpu_serve_batches_total", "counter", "Device batches "
         "executed.", st.get("batches")),
        ("tpu_serve_rows_total", "counter", "Real rows scored.",
         st.get("rows")),
        ("tpu_serve_explain_batches_total", "counter", "Device "
         "TreeSHAP batches executed.", st.get("explain_batches")),
        ("tpu_serve_explain_rows_total", "counter", "Real rows "
         "explained.", st.get("explain_rows")),
        ("tpu_serve_overloads_total", "counter", "Submits rejected by "
         "backpressure.", st.get("overloads")),
        ("tpu_serve_deadline_missed_total", "counter", "Requests expired "
         "in queue.", st.get("deadline_missed")),
        ("tpu_serve_degraded", "gauge", "1 while the session's device "
         "path is down and its requests fail (recoverable: the session "
         "re-probes the device).", bool(st.get("degraded"))),
        ("tpu_serve_degraded_transitions_total", "counter", "Times the "
         "session's device path went down.",
         st.get("degraded_transitions")),
        ("tpu_serve_recoveries_total", "counter", "Times a device "
         "re-probe recovered a degraded session.",
         st.get("recoveries")),
        ("tpu_serve_uptime_seconds", "gauge", "Seconds since the session "
         "packed its model.", st.get("uptime_s")),
        ("tpu_serve_slo_p99_ms", "gauge", "Configured p99 latency "
         "objective (tpu_serve_slo_p99_ms).", m.slo_p99_ms or 0.0),
        ("tpu_serve_slo_burn", "gauge", "Error-budget burn rate vs the "
         "p99 objective (1.0 = at budget).", snap["slo_burn"]),
    )
    for name, kind, help_, v in gauges:
        head(name, kind, help_)
        out.append(f"{name} {_fmt(v)}")
    # replica fleet view (serve/router.py): when the target is a
    # ReplicaRouter its stats() carries per-replica rows — rendered with
    # a replica label so one scrape shows which replica is degraded /
    # breaker-open / draining
    reps = st.get("replicas")
    if isinstance(reps, list) and reps:
        _BREAKER_CODE = {"closed": 0, "half_open": 1, "open": 2}
        head("tpu_serve_replica_healthy", "gauge",
             "1 when the replica is routable (breaker closed, not "
             "draining, not degraded).")
        for r in reps:
            out.append('tpu_serve_replica_healthy{replica="%s"} %d'
                       % (r.get("replica"), 1 if r.get("healthy") else 0))
        head("tpu_serve_replica_breaker_state", "gauge",
             "Replica circuit-breaker state: 0 closed, 1 half_open, "
             "2 open.")
        for r in reps:
            out.append(
                'tpu_serve_replica_breaker_state{replica="%s"} %d'
                % (r.get("replica"),
                   _BREAKER_CODE.get((r.get("breaker") or {})
                                     .get("state"), 0)))
        head("tpu_serve_replica_queue_rows", "gauge",
             "Rows waiting in each replica's batcher queue.")
        for r in reps:
            out.append('tpu_serve_replica_queue_rows{replica="%s"} %d'
                       % (r.get("replica"),
                          int(r.get("queue_rows") or 0)))
    if st.get("resident_bytes") is not None:
        head("tpu_serve_resident_bytes", "gauge",
             "Device bytes held resident by this serving target "
             "(packed forest + explanation planes, all replicas).")
        out.append("tpu_serve_resident_bytes %d"
                   % int(st["resident_bytes"]))
    dr = st.get("drift")
    if isinstance(dr, dict) and dr.get("armed"):
        _drift_series(out, head, dr)
    return "\n".join(out) + "\n"


def render_prometheus_fleet(registry) -> str:
    """Prometheus text for a ``ModelRegistry`` fleet: the default
    model's live router rendered as the primary series (so dashboards
    built against the single-session exposition keep working), plus the
    registry-level model/version/swap/rollback series, the arena's and
    the online loop's."""
    ver = registry.resolve(None)
    out = [render_prometheus(ver.router).rstrip("\n")]

    def head(name, kind, help_):
        out.append(f"# HELP {name} {help_}")
        out.append(f"# TYPE {name} {kind}")

    listing = registry.models()
    head("tpu_serve_models", "gauge", "Models resident in the registry.")
    out.append("tpu_serve_models %d" % len(listing))
    head("tpu_serve_model_version", "gauge",
         "Live version per registered model.")
    for m in listing:
        out.append('tpu_serve_model_version{model="%s"} %d'
                   % (m["name"], m["live_version"]))
    head("tpu_serve_swaps_total", "counter",
         "Completed hot-swaps per model (canary-gated flips).")
    for m in listing:
        out.append('tpu_serve_swaps_total{model="%s"} %d'
                   % (m["name"], m["swaps"]))
    head("tpu_serve_swaps_rejected_total", "counter",
         "Swap attempts rejected by the canary gate.")
    for m in listing:
        out.append('tpu_serve_swaps_rejected_total{model="%s"} %d'
                   % (m["name"], m["swaps_rejected"]))
    head("tpu_serve_rollbacks_total", "counter",
         "Rollbacks per model (manual + automatic post-swap).")
    for m in listing:
        out.append('tpu_serve_rollbacks_total{model="%s"} %d'
                   % (m["name"], m["rollbacks"]))
    head("tpu_serve_resident_bytes", "gauge",
         "Device bytes held resident per model version (live and the "
         "rollback-held previous version).")
    for m in listing:
        for v in m.get("versions") or []:
            if v.get("resident_bytes") is not None:
                out.append(
                    'tpu_serve_resident_bytes{model="%s",version="%d"} %d'
                    % (m["name"], int(v["version"]),
                       int(v["resident_bytes"])))
    # the other models' drift (the default model's is rendered above)
    seen_heads = set()

    def head_once(name, kind, help_):
        if name not in seen_heads:
            seen_heads.add(name)
            head(name, kind, help_)

    for m in listing:
        dr = m.get("drift")
        if not m.get("default") and isinstance(dr, dict) \
                and dr.get("armed"):
            _drift_series(out, head_once, dr)
    # multi-tenant forest arena (serve/arena.py): occupancy, residency
    # and eviction pressure for the packed-tenant plane
    arena = getattr(registry, "arena", None)
    if arena is not None:
        try:
            ast = arena.stats()
        except Exception:  # noqa: BLE001 — a scrape never fails for a
            # closing arena
            ast = None
        if ast:
            _arena_series(out, head, ast)
    # the online loop (online/loop.py run_online) parks its stats provider
    # on the registry, so one fleet scrape covers serving and the refresh
    # loop feeding it
    prov = getattr(registry, "online_provider", None)
    if prov is not None:
        try:
            ost = prov() if callable(prov) else dict(prov)
        except Exception:  # noqa: BLE001 — a scrape never fails for a
            # dead provider
            ost = None
        if ost:
            _online_series(out, head, ost)
    return "\n".join(out) + "\n"


def _online_series(out, head, ost) -> None:
    """Render the online loop's ``stats()`` (online/loop.py) as the
    ``tpu_online_*`` series, under the JAX package's names."""
    head("tpu_online_refresh_total", "counter",
         "Online-loop refresh outcomes (pushed = adopted by the registry, "
         "rejected = bounced by the canary gate, failed = died before the "
         "push, skipped = cadence fired on a stalled ingest).")
    for outcome, key in (("pushed", "versions"), ("rejected", "rejected"),
                         ("failed", "failed"), ("skipped", "skipped")):
        out.append('tpu_online_refresh_total{outcome="%s"} %d'
                   % (outcome, int(ost.get(key) or 0)))
    head("tpu_online_swap_rejected_total", "counter",
         "Online refreshes the canary gate refused to flip.")
    out.append("tpu_online_swap_rejected_total %d"
               % int(ost.get("rejected") or 0))
    head("tpu_online_rows_ingested_total", "counter",
         "Labeled rows the online loop has ingested.")
    out.append("tpu_online_rows_ingested_total %d"
               % int(ost.get("rows_ingested") or 0))
    head("tpu_online_last_refresh_age_seconds", "gauge",
         "Seconds since the online loop last attempted a refresh (stalls "
         "show up as unbounded growth).")
    out.append("tpu_online_last_refresh_age_seconds %s"
               % _fmt(ost.get("last_refresh_age_s")))


def parse_prometheus(text: str) -> Dict[str, float]:
    """Minimal Prometheus text parser: ``{'name{labels}': value}`` (and
    bare ``name`` for label-less samples).  Enough to assert on an
    exposition in tests and to embed a scrape in a bench artifact."""
    out: Dict[str, float] = {}
    for line in (text or "").splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        try:
            key, val = line.rsplit(None, 1)
        except ValueError:
            continue
        try:
            out[key] = float(val)
        except ValueError:
            continue
    return out
