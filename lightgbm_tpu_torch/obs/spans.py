"""Tracing spans and the flight recorder (counterpart of
lightgbm_tpu/obs/spans.py, with its span schema).

One span schema for serving and training, so a request and a training
iteration render on one timeline (the JAX package's
``tools/trace_export.py`` turns the JSONL into Chrome trace-event /
Perfetto JSON).  A completed span is one ``span`` event:

    {"event": "span", "t": <start, unix s>, "dur_ms": ...,
     "name": "serve/queue_wait", "trace_id": ..., "span_id": ...,
     "parent_id": ..., "attrs": {...}}

``trace_id`` groups the spans of one request (minted at the HTTP edge
from an incoming ``X-Request-Id``, sanitized) or of one training run;
``parent_id`` links a child to its request's root span.  Two gates:

- **trace mode** (``tpu_trace`` / ``LGBM_TPU_TRACE``, :func:`enable_trace`)
  writes span events to the telemetry sink and turns every ``obs.phase``
  timer into a span; like profile mode it synchronizes phases.
- **the flight recorder** (``tpu_flight_len`` / ``LGBM_TPU_FLIGHT``,
  :func:`enable_flight`) keeps a ring of the last N spans and operational
  events with no sink; :func:`flight_dump` writes it as
  ``FLIGHT_rN.json`` on a degradation, an overload storm, a
  ``TrainingHealthError``, or on demand (``GET /debug/flight``).

With both gates off every entry point is one attribute check.  The ring
and the id counter take locks: serving threads write them.
"""
from __future__ import annotations

import glob
import itertools
import json
import os
import re
import threading
import time
import uuid
from collections import deque
from typing import Optional

from ..utils import log
from . import core

_ID_BAD = re.compile(r"[^A-Za-z0-9._:-]")

# ids are (per-process random base) + (atomic counter): unique without
# paying uuid4's ~25us urandom syscall on every span (the hot path emits
# several spans per serving request)
_ID_BASE = uuid.uuid4().hex[:8]
_ID_SEQ = itertools.count(1)

_trace_on = False
_flight: Optional[deque] = None
_flight_lock = threading.Lock()
_tls = threading.local()

# events (besides spans) worth keeping in the post-mortem ring: the
# operational record of the moments before a flip
_FLIGHT_EVENTS = frozenset((
    "health", "divergence", "fingerprint", "train_stop", "iteration",
    "serve_degraded", "serve_overload", "serve_batch", "serve_request",
    "serve_access", "serve_start", "serve_stop",
    # explanation serving (serve/session.py explain path): the TreeSHAP
    # batch history belongs in a serving post-mortem exactly like the
    # predict batches beside it
    "explain_request", "explain_batch",
    # fault tolerance (robust/): the recovery record is exactly what a
    # wedge post-mortem needs in the ring
    "checkpoint", "restore", "retry", "fault_injected", "device_stall",
    "serve_probe", "serve_recovered",
    # serving fleet (serve/registry.py + serve/router.py): the swap /
    # rollback / failover lifecycle IS the post-mortem when a model push
    # bounces
    "serve_swap", "serve_canary", "serve_rollback", "serve_failover",
    "serve_drain",
    # online learning (online/loop.py + refit_models): a bounced or
    # skipped refresh is the first thing a stale-model post-mortem
    # needs beside the swap/canary records it produced
    "online_refresh", "refit",
    # streaming ingestion (ingest/stream.py): the per-dataset summary —
    # rows, shard, digest — is what a crash-mid-ingest or corrupt-chunk
    # post-mortem needs first (per-chunk records stay telemetry-only:
    # a 10^8-row stream would flush the whole ring with them)
    "ingest_summary",
    # drift & quality plane (obs/drift.py + serve/quality.py): the
    # score trail leading up to a breach is exactly what the breach's
    # own flight dump must contain
    "drift_snapshot", "quality_window",
    # live introspection plane (obs/ranks.py): the straggler breach
    # belongs in the ring it triggers a dump of (reconciliation stays
    # telemetry-only: one record per iteration would crowd the ring the
    # way per-chunk ingest records would)
    "straggler",
    # zero-cold-start plane (serve/aot.py + serve/arena.py +
    # router.restart_replica): a store entry silently re-paying JIT, a
    # tenant bouncing in and out of residency, or a replica reboot are
    # exactly the moments-before a cold-start or capacity post-mortem
    # replays
    "aot_fallback", "serve_replica_restart", "arena_admit",
    "arena_evict", "arena_repack", "arena_swap",
))


# ---------------------------------------------------------------------------
# identifiers + context
# ---------------------------------------------------------------------------

def new_trace_id(seed=None) -> str:
    """Mint a trace id; a non-empty ``seed`` (e.g. an incoming
    ``X-Request-Id`` header) is sanitized and used verbatim so the
    caller's correlation id survives into every span."""
    if seed:
        s = _ID_BAD.sub("_", str(seed).strip())[:64]
        if s:
            return s
    return f"{_ID_BASE}{next(_ID_SEQ):x}"


def new_span_id() -> str:
    return f"s{next(_ID_SEQ):x}"


def _stack():
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


def current_context():
    """(trace_id, span_id) of the innermost active span on this thread,
    or (None, None)."""
    st = getattr(_tls, "stack", None)
    return st[-1] if st else (None, None)


# ---------------------------------------------------------------------------
# gates
# ---------------------------------------------------------------------------

def trace_enabled() -> bool:
    """True when span events stream to the telemetry sink and phase
    timers are promoted to spans."""
    return _trace_on


def span_record_enabled() -> bool:
    """True when spans are recorded anywhere (sink and/or flight ring) —
    the one check the serving hot path pays when both gates are off."""
    return _trace_on or _flight is not None


def enable_trace(on: bool = True) -> None:
    """Flip the PROCESS-WIDE trace gate (same scope as profile mode).
    Also arms the phase->span hook so ``obs.phase`` timers emit spans."""
    global _trace_on
    _trace_on = bool(on)
    core._set_spans_active(_trace_on, _on_phase if _trace_on else None)


def enable_flight(n: int) -> None:
    """Arm the flight ring with the last ``n`` records (0 disables).
    Idempotent for the same length; re-arming with a new length keeps
    the newest records that fit."""
    global _flight
    n = int(n)
    with _flight_lock:
        if n <= 0:
            _flight = None
        elif _flight is None or _flight.maxlen != n:
            old = list(_flight) if _flight is not None else []
            _flight = deque(old[-n:], maxlen=n)
    core._set_flight_hook(_flight_event_hook if n > 0 else None)


def flight_len_from_env(fallback) -> int:
    """THE parser for ``LGBM_TPU_FLIGHT`` (module init, serve sessions,
    and the trainer all route here so the disable synonyms cannot
    drift): unset -> ``fallback``; 0/false/off/no -> 0; else int."""
    v = os.environ.get("LGBM_TPU_FLIGHT", "").strip()
    if not v:
        return int(fallback)
    if v.lower() in ("0", "false", "off", "no"):
        return 0
    try:
        return int(v)
    except ValueError:
        log.warning("ignoring non-numeric LGBM_TPU_FLIGHT=%r", v)
        return int(fallback)


def flight_enabled() -> bool:
    return _flight is not None


def flight_len() -> int:
    return _flight.maxlen if _flight is not None else 0


def _flight_reset() -> None:
    with _flight_lock:
        if _flight is not None:
            _flight.clear()


core._register_reset(_flight_reset)


# ---------------------------------------------------------------------------
# span emission
# ---------------------------------------------------------------------------

def emit_span(name: str, t0: float, dur_ms: float, trace_id: str,
              span_id: Optional[str] = None, parent_id: Optional[str] = None,
              attrs: Optional[dict] = None) -> Optional[str]:
    """Record one completed span (explicit timing — the serving path
    measures its own phases).  Returns the span id, or None when both
    gates are off (the record went nowhere)."""
    if not (_trace_on or _flight is not None):
        return None
    rec = {"event": "span", "t": round(t0, 6), "name": name,
           "trace_id": trace_id, "span_id": span_id or new_span_id(),
           "dur_ms": round(float(dur_ms), 3)}
    if parent_id:
        rec["parent_id"] = parent_id
    if attrs:
        rec["attrs"] = attrs
    if _flight is not None:
        with _flight_lock:
            if _flight is not None:
                _flight.append(rec)
    if _trace_on:
        core.write_record(rec)
    return rec["span_id"]


class Span:
    """An in-flight span (see :func:`begin_span`)."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "attrs",
                 "t0", "_tp0", "_pushed", "_done")

    def __init__(self, name, trace_id, span_id, parent_id, attrs, pushed):
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.attrs = attrs
        self.t0 = time.time()
        self._tp0 = time.perf_counter()
        self._pushed = pushed
        self._done = False


def begin_span(name: str, trace_id: Optional[str] = None,
               parent_id: Optional[str] = None, push: bool = True,
               **attrs) -> Optional[Span]:
    """Open a span; ``push=True`` makes it the thread's current context
    so nested spans (and trace-mode phase timers) parent to it.  Returns
    None when recording is off — :func:`end_span` accepts None."""
    if not (_trace_on or _flight is not None):
        return None
    cur_trace, cur_span = current_context()
    if trace_id is None:
        trace_id = cur_trace or new_trace_id()
    if parent_id is None:
        parent_id = cur_span
    sp = Span(name, trace_id, new_span_id(), parent_id, attrs or None, push)
    if push:
        _stack().append((trace_id, sp.span_id))
    return sp


def end_span(sp: Optional[Span], **attrs) -> None:
    """Close a span opened by :func:`begin_span` (idempotent, None-safe)."""
    if sp is None or sp._done:
        return
    sp._done = True
    if sp._pushed:
        st = _stack()
        for i in range(len(st) - 1, -1, -1):
            if st[i][1] == sp.span_id:
                del st[i:]
                break
    a = dict(sp.attrs or {})
    a.update(attrs)
    emit_span(sp.name, sp.t0, (time.perf_counter() - sp._tp0) * 1e3,
              sp.trace_id, span_id=sp.span_id, parent_id=sp.parent_id,
              attrs=a or None)


class span:
    """Context-manager sugar over :func:`begin_span`/:func:`end_span`."""

    __slots__ = ("_args", "_kw", "_sp")

    def __init__(self, name, trace_id=None, parent_id=None, **attrs):
        self._args = (name, trace_id, parent_id)
        self._kw = attrs

    def __enter__(self):
        name, trace_id, parent_id = self._args
        self._sp = begin_span(name, trace_id=trace_id, parent_id=parent_id,
                              **self._kw)
        return self._sp

    def __exit__(self, *exc):
        end_span(self._sp)
        return False


def _on_phase(name: str, t0_wall: float, dur_s: float) -> None:
    """core.phase exit hook (trace mode only): every phase timer becomes
    a span under the thread's current trace context, so the training
    loop's existing ``timetag`` phases trace with zero new call sites."""
    trace_id, parent = current_context()
    if trace_id is None:
        trace_id = f"proc-{os.getpid()}"
    emit_span("phase/" + name, t0_wall, dur_s * 1e3, trace_id,
              parent_id=parent)


# ---------------------------------------------------------------------------
# flight recorder
# ---------------------------------------------------------------------------

# introspection endpoints are scraped continuously (Prometheus, LB
# health probes); their access lines must not evict the request spans /
# batch history the post-mortem ring exists to keep
_SCRAPE_PATHS = frozenset(("", "/", "/health", "/metrics", "/stats",
                           "/debug/flight"))


def _flight_event_hook(name: str, fields: dict) -> None:
    """core.event forward: operational events enter the ring even when
    no telemetry sink is configured (spans are appended by emit_span
    directly, so they are deliberately absent from the allowlist)."""
    if name not in _FLIGHT_EVENTS:
        return
    if name == "serve_access" and fields.get("path") in _SCRAPE_PATHS:
        return
    rec = {"event": name, "t": round(time.time(), 6)}
    rec.update(fields)
    if _flight is not None:
        with _flight_lock:
            if _flight is not None:
                _flight.append(rec)


def flight_snapshot() -> list:
    """Copy of the ring, oldest first (empty when disabled)."""
    with _flight_lock:
        return list(_flight) if _flight is not None else []


def _next_flight_round(out_dir: str) -> int:
    n = 0
    for f in glob.glob(os.path.join(out_dir, "FLIGHT_r*.json")):
        m = re.search(r"FLIGHT_r(\d+)\.json$", os.path.basename(f))
        if m:
            n = max(n, int(m.group(1)))
    return n + 1


def flight_dump(reason: str, out_dir: Optional[str] = None,
                extra: Optional[dict] = None) -> Optional[str]:
    """Write the ring as ``FLIGHT_rN.json`` (next free N) and return the
    path; None when the ring is disarmed or the write failed.  The dump
    is the post-mortem artifact: its last events are the moments before
    whatever tripped ``reason``."""
    events = flight_snapshot()
    if _flight is None:
        return None
    if not out_dir:
        out_dir = os.environ.get("LGBM_TPU_FLIGHT_DIR", "")
    if not out_dir:
        # prefer the telemetry sink's directory so the post-mortem lands
        # next to the event stream it complements; cwd is the fallback
        sink = core.sink_path()
        out_dir = (os.path.dirname(sink) or os.getcwd()) if sink \
            else os.getcwd()
    try:
        os.makedirs(out_dir, exist_ok=True)
        rec = {"kind": "flight", "reason": reason,
               "t": round(time.time(), 6), "ring_len": flight_len(),
               "events": events}
        if extra:
            rec.update(extra)
        # created exclusively: processes that dump into one directory at
        # once (a fleet's ranks) each take their own round
        while True:
            n = _next_flight_round(out_dir)
            path = os.path.join(out_dir, f"FLIGHT_r{n:02d}.json")
            try:
                fh = open(path, "x")
                break
            except FileExistsError:
                continue
        with fh:
            json.dump(rec, fh, indent=1, default=core._json_default)
        log.warning("flight recorder: dumped %d event(s) to %s (%s)",
                    len(events), path, reason)
        return path
    except OSError as exc:
        log.warning("flight recorder: dump failed (%s)", exc)
        return None


_env_trace = os.environ.get("LGBM_TPU_TRACE", "")
if _env_trace not in ("", "0", "false"):
    enable_trace()
if os.environ.get("LGBM_TPU_FLIGHT", ""):
    enable_flight(flight_len_from_env(256))
