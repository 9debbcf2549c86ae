"""The train board: a live ``/metrics`` exporter for training
(counterpart of lightgbm_tpu/obs/board.py, with its series names).

``engine.train`` arms a :class:`TrainBoard` when
``tpu_train_metrics_port`` (or ``LGBM_TPU_TRAIN_METRICS``) asks for one:
one daemon thread running a threaded ``http.server``, as in
``serve/server.py``; the training thread pays one call per event.
Endpoints:

- ``GET /metrics``: Prometheus text: the iteration, row-iterations a
  second and ``vs_baseline``, each phase's seconds and share, the
  checkpoint's age, the device guard's retries and stalls (the
  ``watchdog`` provider, ``robust/watchdog.py DeviceGuard.snapshot``),
  health failures, kernel builds, collective bytes, the skew table across
  ranks and the last reconciliation (``obs/ranks.py``), the fleet's view
  (the ``fleet`` and ``fleet_hub`` providers, ``fleet/health.py``).
- ``GET /progress``: JSON: iteration and total, a smoothed ETA, the last
  iteration records.  ``start_round`` (the round ``engine.train`` starts
  or resumes at) anchors the rate to this run's iterations.
- ``GET /debug/flight``: the flight ring, as the serving endpoint gives
  it.

The board sees events through ``core._set_board_hook``, with or without
a sink, and arming it runs the phase timers it renders.  Across ranks
each binds ``port + rank`` (port 0: every rank takes a free port).
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from ..utils import log
from . import core, spans, trace

# The vs_baseline denominator: LightGBM's OpenCL GPU learner on HIGGS,
# 10,500,000 rows x 500 iterations in 238.5 s (the JAX package's
# reference constant, lightgbm_tpu/obs/board.py, copied here with its
# source; no TPU number enters it).
_REF_ROW_ITERS_PER_S = 10_500_000 * 500 / 238.5


def baseline_row_iters_per_s() -> float:
    """The ``vs_baseline`` denominator (row-iterations a second)."""
    return _REF_ROW_ITERS_PER_S


def _fmt(v) -> str:
    """Prometheus sample formatting (serve/metrics.py conventions)."""
    if v is None:
        return "0"
    if isinstance(v, bool):
        return "1" if v else "0"
    f = float(v)
    return str(int(f)) if f.is_integer() else repr(f)


def _head(out: list, name: str, kind: str, help_: str) -> None:
    out.append(f"# HELP {name} {help_}")
    out.append(f"# TYPE {name} {kind}")


class _BoardServer(ThreadingHTTPServer):
    daemon_threads = True
    allow_reuse_address = True
    board = None  # set by TrainBoard.start


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # noqa: A002 — silence stderr
        pass

    def _reply(self, code: int, body: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802 — http.server API
        board = self.server.board
        path = self.path.split("?", 1)[0]
        try:
            if path == "/metrics":
                self._reply(200, board.metrics_text().encode(),
                            "text/plain; version=0.0.4; charset=utf-8")
            elif path == "/progress":
                self._reply(200, json.dumps(
                    board.progress(), default=core._json_default).encode(),
                    "application/json")
            elif path == "/debug/flight":
                self._reply(200, json.dumps(
                    {"enabled": spans.flight_enabled(),
                     "ring_len": spans.flight_len(),
                     "events": spans.flight_snapshot()},
                    default=core._json_default).encode(),
                    "application/json")
            else:
                self._reply(404, b'{"error": "not found"}',
                            "application/json")
        except (BrokenPipeError, ConnectionResetError):
            pass


class TrainBoard:
    """The exporter: event-fed accumulators + the HTTP thread."""

    def __init__(self, total_rounds: int, start_round: int = 0,
                 port: int = 0, host: str = "127.0.0.1", last_k: int = 32):
        self.total_rounds = int(total_rounds)
        self.start_round = int(start_round)
        self._host = host
        self._port_req = int(port)
        self.port = None
        self._lock = threading.Lock()
        self._t0 = time.time()
        self._iteration = None
        self._completed = 0          # iterations finished THIS run
        self._ema_iter_s = None
        self._last_iter_s = None
        self._row_iters_per_s = 0.0
        self._phase_cum = {}
        self._recent = deque(maxlen=max(int(last_k), 1))
        self._ckpt_t = None
        self._ckpt_iter = None
        self._ckpt_count = 0
        self._restores = 0
        self._retries = 0
        self._stalls = 0
        self._health_failures = 0
        self._stragglers = deque(maxlen=8)
        self._straggler_count = 0
        self._reconciliation = None
        self._providers = {}
        self._baseline = baseline_row_iters_per_s()
        self.hook_s = 0.0            # train-thread seconds spent in notes
        self._server = None
        self._thread = None
        self._armed_flight = False   # start() armed the flight ring

    # ------------------------------------------------------------------
    # event intake (train thread)
    # ------------------------------------------------------------------

    def _note(self, name: str, fields: dict) -> None:
        t0 = time.perf_counter()
        try:
            self._dispatch(name, fields)
        except Exception:  # noqa: BLE001 — the exporter never fails train
            pass
        finally:
            self.hook_s += time.perf_counter() - t0

    def _dispatch(self, name: str, fields: dict) -> None:
        if name == "iteration":
            with self._lock:
                self._iteration = int(fields.get("iteration", 0))
                it_s = float(fields.get("iter_s", 0.0) or 0.0)
                self._last_iter_s = it_s
                # EMA over THIS run's iterations only (alpha 0.3): a
                # resumed run's ETA reflects the live rate, not the
                # restored offset's wall clock
                self._ema_iter_s = (it_s if self._ema_iter_s is None
                                    else 0.7 * self._ema_iter_s
                                    + 0.3 * it_s)
                self._completed += 1
                rps = fields.get("cum_row_iters_per_s")
                if rps:
                    self._row_iters_per_s = float(rps)
                for p, s in (fields.get("phase_s") or {}).items():
                    self._phase_cum[p] = \
                        self._phase_cum.get(p, 0.0) + float(s or 0.0)
                self._recent.append({
                    "iteration": self._iteration,
                    "iter_s": round(it_s, 6),
                    "metrics": fields.get("metrics") or {},
                    "recompiles": int(fields.get("recompiles", 0) or 0),
                    "cum_row_iters_per_s": self._row_iters_per_s,
                    "t": round(time.time(), 3),
                })
        elif name == "checkpoint":
            with self._lock:
                self._ckpt_t = time.time()
                self._ckpt_iter = fields.get("iteration")
                self._ckpt_count += 1
        elif name == "restore":
            with self._lock:
                self._restores += 1
        elif name == "retry":
            with self._lock:
                self._retries += 1
        elif name == "device_stall":
            with self._lock:
                self._stalls += 1
        elif name == "health":
            if not fields.get("ok", True):
                with self._lock:
                    self._health_failures += 1
        elif name == "straggler":
            with self._lock:
                self._stragglers.append(dict(fields))
                self._straggler_count += 1
        elif name == "reconciliation":
            with self._lock:
                self._reconciliation = {
                    "iteration": fields.get("iteration"),
                    "units": fields.get("units") or {}}

    def set_provider(self, name: str, fn) -> None:
        """Register a snapshot callable rendered on scrape (e.g. the
        engine's DeviceGuard: ``set_provider("watchdog",
        guard.snapshot)``)."""
        self._providers[name] = fn

    def _provider(self, name: str) -> dict:
        fn = self._providers.get(name)
        if fn is None:
            return {}
        try:
            return dict(fn() or {})
        except Exception:  # noqa: BLE001 — scrape must not raise
            return {}

    # ------------------------------------------------------------------
    # renderers (HTTP thread)
    # ------------------------------------------------------------------

    def _eta_s(self) -> Optional[float]:
        if self._ema_iter_s is None or self._iteration is None:
            return None
        remaining = max(self.total_rounds - (self._iteration + 1), 0)
        return self._ema_iter_s * remaining

    def progress(self) -> dict:
        with self._lock:
            eta = self._eta_s()
            rps = self._row_iters_per_s
            out = {
                "iteration": self._iteration,
                "total_rounds": self.total_rounds,
                "start_round": self.start_round,
                "completed": self._completed,
                "frac": (round((self._iteration + 1) / self.total_rounds,
                               4)
                         if self._iteration is not None
                         and self.total_rounds else None),
                "eta_s": round(eta, 3) if eta is not None else None,
                "ema_iter_s": (round(self._ema_iter_s, 6)
                               if self._ema_iter_s is not None else None),
                "uptime_s": round(time.time() - self._t0, 3),
                "row_iters_per_s": rps,
                "vs_baseline": (round(rps / self._baseline, 4)
                                if rps else None),
                "recent": list(self._recent),
                "checkpoint": {
                    "count": self._ckpt_count,
                    "iteration": self._ckpt_iter,
                    "age_s": (round(time.time() - self._ckpt_t, 3)
                              if self._ckpt_t else None)},
                "restores": self._restores,
                "stragglers": list(self._stragglers),
                "reconciliation": self._reconciliation,
            }
        wd = self._provider("watchdog")
        if wd:
            out["watchdog"] = wd
        fl = self._provider("fleet")
        if fl:
            out["fleet"] = fl
        hub = self._provider("fleet_hub")
        if hub:
            out["fleet_hub"] = hub
        return out

    def metrics_text(self) -> str:
        from . import ranks
        with self._lock:
            it = (self._iteration if self._iteration is not None
                  else self.start_round - 1)
            eta = self._eta_s()
            phase_cum = dict(self._phase_cum)
            rps = self._row_iters_per_s
            last_straggler = (self._stragglers[-1]
                             if self._stragglers else None)
            recon = self._reconciliation
            vals = (self._completed, self._ema_iter_s, self._ckpt_count,
                    self._ckpt_t, self._restores, self._retries,
                    self._stalls, self._health_failures,
                    self._straggler_count)
        (completed, ema, ckpts, ckpt_t, restores, retries, stalls,
         health_fail, stragglers) = vals
        out = []
        _head(out, "tpu_train_uptime_seconds", "gauge",
              "Seconds since the exporter was armed.")
        out.append("tpu_train_uptime_seconds "
                   + _fmt(round(time.time() - self._t0, 3)))
        _head(out, "tpu_train_iteration", "gauge",
              "Last completed boosting iteration (global numbering; "
              "resumes continue from the restored offset).")
        out.append("tpu_train_iteration " + _fmt(it))
        _head(out, "tpu_train_total_rounds", "gauge",
              "Configured num_boost_round for this run.")
        out.append("tpu_train_total_rounds " + _fmt(self.total_rounds))
        _head(out, "tpu_train_start_round", "gauge",
              "Iteration the run started/resumed at.")
        out.append("tpu_train_start_round " + _fmt(self.start_round))
        _head(out, "tpu_train_completed_iterations", "counter",
              "Iterations finished by THIS process lifetime.")
        out.append("tpu_train_completed_iterations " + _fmt(completed))
        _head(out, "tpu_train_iter_seconds", "gauge",
              "EMA-smoothed per-iteration wall seconds.")
        out.append("tpu_train_iter_seconds " + _fmt(ema))
        _head(out, "tpu_train_eta_seconds", "gauge",
              "Smoothed remaining-wall estimate (0 until the first "
              "iteration lands).")
        out.append("tpu_train_eta_seconds "
                   + _fmt(round(eta, 3) if eta is not None else None))
        _head(out, "tpu_train_row_iters_per_s", "gauge",
              "Cumulative row-iterations per second.")
        out.append("tpu_train_row_iters_per_s " + _fmt(rps))
        _head(out, "tpu_train_vs_baseline", "gauge",
              "Live row_iters/s over LightGBM's OpenCL GPU run on HIGGS.")
        out.append("tpu_train_vs_baseline "
                   + _fmt(round(rps / self._baseline, 4) if rps else None))
        total_phase = sum(phase_cum.values())
        _head(out, "tpu_train_phase_seconds", "counter",
              "Cumulative wall seconds per training phase.")
        for p in sorted(phase_cum):
            out.append('tpu_train_phase_seconds{phase="%s"} %s'
                       % (p, _fmt(round(phase_cum[p], 6))))
        _head(out, "tpu_train_phase_frac", "gauge",
              "Fraction of phase-accounted wall per phase.")
        for p in sorted(phase_cum):
            frac = phase_cum[p] / total_phase if total_phase else 0.0
            out.append('tpu_train_phase_frac{phase="%s"} %s'
                       % (p, _fmt(round(frac, 4))))
        _head(out, "tpu_train_checkpoints_total", "counter",
              "Checkpoints written this run.")
        out.append("tpu_train_checkpoints_total " + _fmt(ckpts))
        _head(out, "tpu_train_checkpoint_age_seconds", "gauge",
              "Seconds since the last checkpoint write (0 before any).")
        out.append("tpu_train_checkpoint_age_seconds "
                   + _fmt(round(time.time() - ckpt_t, 3)
                          if ckpt_t else None))
        _head(out, "tpu_train_restores_total", "counter",
              "Checkpoint restores observed.")
        out.append("tpu_train_restores_total " + _fmt(restores))
        _head(out, "tpu_train_retries_total", "counter",
              "Watchdog retry events observed.")
        out.append("tpu_train_retries_total " + _fmt(retries))
        _head(out, "tpu_train_stalls_total", "counter",
              "Device-stall events observed.")
        out.append("tpu_train_stalls_total " + _fmt(stalls))
        _head(out, "tpu_train_health_failures_total", "counter",
              "Failed health checks observed.")
        out.append("tpu_train_health_failures_total " + _fmt(health_fail))
        # the JAX package's compile series: the port builds its CUDA
        # kernels (nvcc, once per source digest) where it would compile,
        # and has no compile cache and no retrace
        _head(out, "tpu_train_recompiles_total", "counter",
              "CUDA kernel builds this process (cuda/kernel_builds).")
        out.append("tpu_train_recompiles_total "
                   + _fmt(core.counter_value(trace.BUILD_COUNTER)))
        _head(out, "tpu_train_compile_seconds_total", "counter",
              "Seconds spent building CUDA kernels this process.")
        out.append("tpu_train_compile_seconds_total "
                   + _fmt(round(core.counter_value(trace.BUILD_SECONDS), 3)))
        _head(out, "tpu_train_compile_cache_hits_total", "counter",
              "Persistent compile-cache hits (none in the port).")
        out.append("tpu_train_compile_cache_hits_total 0")
        _head(out, "tpu_train_compile_cache_misses_total", "counter",
              "Persistent compile-cache misses (none in the port).")
        out.append("tpu_train_compile_cache_misses_total 0")
        _head(out, "tpu_train_retraces_total", "counter",
              "Jit retraces (none in the port).")
        out.append("tpu_train_retraces_total 0")
        coll = [(k, v) for k, v in core.counters_snapshot().items()
                if k.startswith("collective/") and k.endswith("bytes")]
        _head(out, "tpu_train_collective_bytes_total", "counter",
              "Bytes moved per collective kind (traced_* = in-jit).")
        for k, v in sorted(coll):
            kind = k[len("collective/"):-len("/bytes")] \
                if k.endswith("/bytes") else \
                k[len("collective/"):-len("/traced_bytes")] + "/traced"
            out.append('tpu_train_collective_bytes_total{kind="%s"} %s'
                       % (kind, _fmt(v)))
        wd = self._provider("watchdog")
        if wd:
            _head(out, "tpu_train_watchdog_active", "gauge",
                  "1 when the device watchdog (or fault harness) is "
                  "armed.")
            out.append("tpu_train_watchdog_active "
                       + _fmt(wd.get("active")))
            _head(out, "tpu_train_watchdog_retries", "gauge",
                  "Retries the in-process watchdog has burned.")
            out.append("tpu_train_watchdog_retries "
                       + _fmt(wd.get("retry_count")))
            _head(out, "tpu_train_watchdog_stalls", "gauge",
                  "Stalls the in-process watchdog has stamped.")
            out.append("tpu_train_watchdog_stalls "
                       + _fmt(wd.get("stall_count")))
            _head(out, "tpu_train_watchdog_deadline_seconds", "gauge",
                  "Current per-call watchdog deadline.")
            out.append("tpu_train_watchdog_deadline_seconds "
                       + _fmt(wd.get("deadline_s")))
        fl = self._provider("fleet")
        if fl:
            _head(out, "tpu_train_fleet_world_size", "gauge",
                  "Live ranks in the elastic training fleet.")
            out.append("tpu_train_fleet_world_size "
                       + _fmt(fl.get("world")))
            _head(out, "tpu_train_fleet_rank", "gauge",
                  "This process's current shard rank (member id as "
                  "label — stable across resizes).")
            out.append('tpu_train_fleet_rank{member="%s"} %s'
                       % (fl.get("member"), _fmt(fl.get("rank"))))
            _head(out, "tpu_train_fleet_epoch", "gauge",
                  "Fleet epoch (bumped by every resize).")
            out.append("tpu_train_fleet_epoch " + _fmt(fl.get("epoch")))
            _head(out, "tpu_train_fleet_dead_ranks", "gauge",
                  "Members classified dead since launch.")
            out.append("tpu_train_fleet_dead_ranks "
                       + _fmt(len(fl.get("dead") or ())))
            _head(out, "tpu_train_fleet_recoveries_total", "counter",
                  "Elastic recoveries (rollback + resize) this rank "
                  "has run.")
            out.append("tpu_train_fleet_recoveries_total "
                       + _fmt(fl.get("recoveries")))
            _head(out, "tpu_train_fleet_pending_join", "gauge",
                  "Healed ranks parked at the hub awaiting a resize.")
            out.append("tpu_train_fleet_pending_join "
                       + _fmt(fl.get("pending_join")))
            members = fl.get("members") or {}
            if members:
                _head(out, "tpu_train_fleet_member_age_seconds", "gauge",
                      "Seconds since each live member's last heartbeat "
                      "(coordinator view).")
                for m in sorted(members):
                    out.append(
                        'tpu_train_fleet_member_age_seconds{member="%s",'
                        'shard="%s"} %s'
                        % (m, members[m].get("shard"),
                           _fmt(members[m].get("age_s"))))
        _head(out, "tpu_train_stragglers_total", "counter",
              "Straggler breaches detected (rank 0 only).")
        out.append("tpu_train_stragglers_total " + _fmt(stragglers))
        if last_straggler is not None:
            _head(out, "tpu_train_straggler_ratio", "gauge",
                  "Last straggler breach: rank wall over fleet median.")
            out.append(
                'tpu_train_straggler_ratio{rank="%s",phase="%s"} %s'
                % (last_straggler.get("rank"),
                   last_straggler.get("phase"),
                   _fmt(last_straggler.get("ratio"))))
        skew = ranks.skew_table()
        if skew.get("ranks"):
            _head(out, "tpu_train_phase_skew_seconds", "gauge",
                  "Per-rank per-iteration phase wall from the last "
                  "stats exchange.")
            for r in sorted(skew["ranks"]):
                for p, s in sorted(skew["ranks"][r].items()):
                    out.append(
                        'tpu_train_phase_skew_seconds{rank="%s",'
                        'phase="%s"} %s' % (r, p, _fmt(s)))
        if recon and recon.get("units"):
            _head(out, "tpu_train_reconciliation_ratio", "gauge",
                  "Measured over modeled phase seconds per cost-model "
                  "unit (last scored iteration).")
            for unit, u in sorted(recon["units"].items()):
                out.append(
                    'tpu_train_reconciliation_ratio{unit="%s"} %s'
                    % (unit, _fmt(u.get("ratio"))))
        _head(out, "tpu_train_flight_enabled", "gauge",
              "1 when the flight recorder ring is armed.")
        out.append("tpu_train_flight_enabled "
                   + _fmt(spans.flight_enabled()))
        return "\n".join(out) + "\n"

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    def start(self) -> "TrainBoard":
        global _BOARD
        self._server = _BoardServer((self._host, self._port_req),
                                    _Handler)
        self._server.board = self
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="lgbm-train-board",
            daemon=True)
        self._thread.start()
        core._set_board_hook(self._note)
        if not spans.flight_enabled():
            # the board's /debug/flight and the straggler dump both
            # want a ring; arm the default size unless the env says no,
            # and disarm it again at stop
            spans.enable_flight(spans.flight_len_from_env(256))
            self._armed_flight = spans.flight_enabled()
        _BOARD = self
        return self

    def stop(self) -> None:
        global _BOARD
        core._set_board_hook(None)
        if _BOARD is self:
            _BOARD = None
        if self._armed_flight:
            spans.enable_flight(0)
            self._armed_flight = False
        if self._server is not None:
            try:
                self._server.shutdown()
                self._server.server_close()
            except OSError:
                pass
            self._server = None
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None

    @property
    def url(self) -> str:
        return f"http://{self._host}:{self.port}"


_BOARD: Optional[TrainBoard] = None


def active() -> bool:
    """True when a TrainBoard exporter is armed in this process."""
    return _BOARD is not None


def current() -> Optional[TrainBoard]:
    return _BOARD


def resolve_port(config) -> Optional[int]:
    """The exporter port for this run, or None for off.  The env var
    wins over the parameter: ``LGBM_TPU_TRAIN_METRICS=<port>`` arms it
    (0: a free port), ``off``/``false``/``-1`` disarms; unset, the
    ``tpu_train_metrics_port`` parameter decides (-1, the default: off;
    0: a free port, which the JAX package reads as off)."""
    env = os.environ.get("LGBM_TPU_TRAIN_METRICS")
    if env is not None and env.strip():
        v = env.strip().lower()
        if v in ("off", "false", "no", "none"):
            return None
        try:
            p = int(v)
        except ValueError:
            log.warning("LGBM_TPU_TRAIN_METRICS=%r is not a port; "
                        "train metrics exporter stays off", env)
            return None
        return p if p >= 0 else None
    p = int(getattr(config, "tpu_train_metrics_port", -1))
    return p if p >= 0 else None


def maybe_start(config, total_rounds: int,
                start_round: int = 0) -> Optional[TrainBoard]:
    """Arm the exporter when configured (engine.train's hook).  A fixed
    port is offset by the rank (``port + rank``), so the ranks of one
    host do not collide; a failed bind logs and training goes on."""
    port = resolve_port(config)
    if port is None:
        return None
    if port > 0:
        from ..parallel.distributed import rank
        port += rank() or core._process_index()
    board = TrainBoard(total_rounds, start_round=start_round, port=port)
    try:
        board.start()
    except OSError as exc:
        log.warning("train metrics exporter failed to bind port %d "
                    "(%s); continuing without it", port, exc)
        return None
    log.info("train metrics exporter: %s/metrics", board.url)
    return board
