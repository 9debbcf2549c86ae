"""Structured training telemetry: events, counters, gauges, phase timers
(counterpart of lightgbm_tpu/obs/core.py, with its event schema).

Two gates, as in the JAX package:

- ``LGBM_TPU_TIMETAG=1``: phase wall-time accumulation and the report at
  exit (reference: src/treelearner/serial_tree_learner.cpp:21-60).
- ``LGBM_TPU_TELEMETRY=<path>`` (or the ``tpu_telemetry`` parameter, or
  :func:`enable`): a JSONL event stream.  ``<path>`` is a directory
  (``telemetry.{process_index}.jsonl`` inside it) or a ``*.jsonl`` file
  (a non-zero rank inserts ``.{rank}`` before the extension).

PyTorch launches CUDA work asynchronously, so a phase timer around device
work measures its launches unless the phase synchronizes.  ``sync(x)``
calls ``torch.cuda.synchronize`` on ``x``'s device only while tracing is
on (a sink, TIMETAG, profile or trace mode): with every gate off each
entry point here is a boolean check and the training loop keeps its
asynchronous launches.  Whenever a ``torch.profiler`` records on this
thread (the profiler window of ``obs/xprof.py``, or any caller's), a
phase also opens a ``torch.profiler.record_function`` range
(``lgbm/<phase>``), so the trace carries the phase names; the range
never synchronizes, and with no profiler recording a phase enters none.
Phases nest (the wave grower's ``grow.*`` and ``wait`` run inside
``tree growth``): a nested phase keeps its seconds and its range, but
trace mode makes spans of the top-level phases only, and a share divides
by their seconds alone (``share_total``).  An armed train board
(``obs/board.py``) sees every event through a hook and runs the phase
timers, with or without a sink.

Events are one JSON object a line with ``event`` (the name) and ``t``
(unix seconds); the JAX package's ``obs/report.py`` and
``tools/trace_export.py`` read them.
"""
from __future__ import annotations

import atexit
import json
import math
import os
import time
from collections import defaultdict
from typing import Optional

from torch._C._autograd import _profiler_enabled

from ..utils import log

TIMETAG_ENABLED = os.environ.get("LGBM_TPU_TIMETAG", "") not in ("", "0",
                                                                 "false")

_acc = defaultdict(float)       # phase name -> accumulated seconds
_cnt = defaultdict(int)         # phase name -> completed enter/exit pairs
_counters = defaultdict(float)  # counter name -> value (monotonic)
_gauges = {}                    # gauge name -> last value

_path: Optional[str] = None     # configured sink (dir or *.jsonl file)
_fh = None                      # lazily opened per-process file
_fh_idx = None                  # the rank the open file was named for
_cur_phase = ""                 # innermost active phase
_nested = set()                 # phases opened inside another phase
_atexit_on = False
_write_warned = False
_profile_active = False         # set by obs.profile
_spans_active = False           # set by obs.spans (trace mode)
_span_phase_hook = None         # obs.spans phase -> span promotion
_flight_hook = None             # obs.spans flight-recorder forward
_board_hook = None              # obs.board live-exporter forward
_mem_probe = None               # obs.memory per-phase-exit hook
_reset_hooks = []               # submodule state cleared by reset()


def _set_spans_active(on: bool, phase_hook=None) -> None:
    """Trace mode runs the phase timers (as spans) without a sink."""
    global _spans_active, _span_phase_hook
    _spans_active = bool(on)
    _span_phase_hook = phase_hook
    if on:
        _ensure_atexit()


def _set_flight_hook(hook) -> None:
    """obs/spans.py forwards operational events to the flight ring with
    no sink configured (one None check when disarmed)."""
    global _flight_hook
    _flight_hook = hook


def _set_board_hook(hook) -> None:
    """obs/board.py forwards every event to the train board, and the
    phase timers run while it is armed (the board renders them), with no
    sink configured too."""
    global _board_hook
    _board_hook = hook
    if hook is not None:
        _ensure_atexit()


def _set_profile_active(on: bool) -> None:
    """Profile mode runs the phase timers, synchronized, without a sink,
    and probes the allocator at each phase's exit."""
    global _profile_active, _mem_probe
    _profile_active = bool(on)
    if on:
        from .memory import phase_probe
        _mem_probe = phase_probe
        _ensure_atexit()
    else:
        _mem_probe = None


def _register_reset(hook) -> None:
    _reset_hooks.append(hook)


def enabled() -> bool:
    """True when a telemetry sink is configured."""
    return _path is not None


def tracing_enabled() -> bool:
    """True when phase timers accumulate and :func:`sync` waits."""
    return (TIMETAG_ENABLED or _path is not None or _profile_active
            or _spans_active or _board_hook is not None)


def enable(path: str) -> None:
    """Point the JSONL sink at ``path`` (a directory or a ``*.jsonl``
    file); idempotent for the same path, a new path closes the old
    sink."""
    global _path
    if not path:
        return
    if _path is not None and _path != path:
        _close_sink()
    _path = path
    _ensure_atexit()


def disable() -> None:
    """Close the sink (the accumulators stay; :func:`reset` clears
    them)."""
    global _path
    _close_sink()
    _path = None


def _close_sink() -> None:
    global _fh, _fh_idx
    if _fh is not None:
        try:
            _fh.close()
        except OSError:
            pass
        _fh = None
        _fh_idx = None


def _process_index() -> int:
    """This process's rank, from the launcher's environment
    (``LGBM_TPU_RANK``, then torchrun's ``RANK``); 0 alone."""
    for var in ("LGBM_TPU_RANK", "RANK"):
        v = os.environ.get(var, "")
        if v:
            try:
                return int(v)
            except ValueError:
                pass
    return 0


def _sink_target(pidx: int) -> str:
    if _path.endswith(".jsonl"):
        if pidx:
            return f"{_path[:-len('.jsonl')]}.{pidx}.jsonl"
        return _path
    return os.path.join(_path, f"telemetry.{pidx}.jsonl")


def sink_path() -> Optional[str]:
    """The file this process writes (None when disabled)."""
    if _path is None:
        return None
    return _sink_target(_process_index())


def _open_sink():
    global _fh, _fh_idx
    idx = _process_index()
    if _fh is not None and idx != _fh_idx:
        # the rank became known after the sink opened: later writes go to
        # the right file, and the marker names where the early ones are
        old_target = _sink_target(_fh_idx)
        _close_sink()
        fh = _open_sink()
        fh.write(json.dumps(
            {"event": "sink_reattached", "t": round(time.time(), 6),
             "early_events_in": os.path.basename(old_target)},
            separators=(",", ":")) + "\n")
        return fh
    if _fh is None:
        _fh_idx = idx
        target = sink_path()
        d = os.path.dirname(target)
        if d:
            os.makedirs(d, exist_ok=True)
        # line-buffered: a crash loses at most the record being written
        _fh = open(target, "a", buffering=1)
    return _fh


def _json_default(o):
    try:
        return o.item()  # numpy and torch scalars
    except Exception:  # noqa: BLE001
        return repr(o)


def event(name: str, **fields) -> None:
    """Append one record to the sink (no-op when disabled); numpy and
    torch scalars are unwrapped."""
    if _flight_hook is not None:
        _flight_hook(name, fields)
    if _board_hook is not None:
        _board_hook(name, fields)
    if _path is None:
        return
    rec = {"event": name, "t": round(time.time(), 6)}
    rec.update(fields)
    write_record(rec)


def write_record(rec: dict) -> None:
    """Append a record built by the caller (span records carry their own
    ``name`` and ``t``).  No-op when disabled."""
    global _write_warned
    if _path is None:
        return
    try:
        _open_sink().write(
            json.dumps(rec, separators=(",", ":"), default=_json_default)
            + "\n")
    except (OSError, TypeError, ValueError) as exc:
        if not _write_warned:
            _write_warned = True
            log.warning("telemetry write failed (%s); further write "
                        "errors are silenced", exc)


def count(name: str, n=1) -> None:
    """Bump a monotonic counter (no-op when disabled)."""
    if _path is not None or _board_hook is not None:
        _counters[name] += n


def gauge(name: str, value) -> None:
    """Record the latest value of a gauge (no-op when disabled)."""
    if _path is not None or _board_hook is not None:
        _gauges[name] = value


def counter_value(name: str) -> float:
    return _counters.get(name, 0)


def counters_snapshot() -> dict:
    """Counters and gauges as one JSON-friendly dict."""
    out = {}
    for k, v in _counters.items():
        fv = float(v)
        out[k] = int(fv) if fv.is_integer() else round(fv, 6)
    out.update(_gauges)
    return out


# ---------------------------------------------------------------------------
# Phase timers (the TIMETAG accumulators)
# ---------------------------------------------------------------------------

class phase:
    """Context manager adding its wall time to ``name`` while tracing is
    on (``utils.timetag.timetag``), and opening the range ``lgbm/<name>``
    while a ``torch.profiler`` records (the one range gate)."""

    __slots__ = ("name", "t0", "_t0w", "_on", "_prev", "_rf")

    def __init__(self, name: str):
        self.name = name
        self._on = False
        self._rf = None

    def __enter__(self):
        if _profiler_enabled():
            import torch
            self._rf = torch.profiler.record_function("lgbm/" + self.name)
            self._rf.__enter__()
        if tracing_enabled():
            global _cur_phase
            self._on = True
            self._prev = _cur_phase
            if _cur_phase:
                _nested.add(self.name)
            _cur_phase = self.name
            # trace mode turns a top-level timer into a span, which takes a
            # wall clock start (a nested one's time is in its holder's span)
            self._t0w = (time.time() if _span_phase_hook is not None
                         and not self._prev else None)
            self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type=None, exc_value=None, tb=None):
        if self._on:
            global _cur_phase
            dur = time.perf_counter() - self.t0
            _acc[self.name] += dur
            _cnt[self.name] += 1
            _cur_phase = self._prev
            if _span_phase_hook is not None and self._t0w is not None:
                _span_phase_hook(self.name, self._t0w, dur)
            if _mem_probe is not None:
                _mem_probe(self.name)
            self._on = False
        if self._rf is not None:
            self._rf.__exit__(exc_type, exc_value, tb)
            self._rf = None
        return False


def current_phase() -> str:
    return _cur_phase


def share_total(phase_s: dict) -> float:
    """The seconds a phase's share of ``phase_s`` divides by: those of
    the phases never opened inside another.  A nested phase (the wave
    grower's ``grow.*`` and ``wait`` inside ``tree growth``) spends its
    holder's seconds; a name opened both ways (``wait``, which also ends
    the iteration at the top) counts as nested."""
    return sum(v for k, v in phase_s.items() if k not in _nested)


def _cuda_device(x):
    """The CUDA device of tensor ``x`` (or of the first CUDA tensor in a
    list or tuple), else None."""
    if isinstance(x, (list, tuple)):
        for part in x:
            d = _cuda_device(part)
            if d is not None:
                return d
        return None
    return x.device if getattr(x, "is_cuda", False) else None


def sync(x):
    """Wait for the CUDA work behind ``x`` only while tracing is on, so
    normal runs keep their asynchronous launches.  Returns ``x``."""
    if x is not None and tracing_enabled():
        dev = _cuda_device(x)
        if dev is not None:
            import torch
            torch.cuda.synchronize(dev)
    return x


def add(name: str, seconds: float) -> None:
    """Accumulate a phase timed elsewhere."""
    if tracing_enabled():
        _acc[name] += seconds
        _cnt[name] += 1


def phase_snapshot() -> dict:
    """Per-phase accumulated seconds (a copy)."""
    return dict(_acc)


def phase_delta(snapshot: dict) -> dict:
    """Per-phase seconds accumulated since ``snapshot`` (the phases that
    moved)."""
    out = {}
    for name, total in _acc.items():
        d = total - snapshot.get(name, 0.0)
        if d > 0.0:
            out[name] = round(d, 6)
    return out


def reset() -> None:
    _acc.clear()
    _cnt.clear()
    _nested.clear()
    _counters.clear()
    _gauges.clear()
    for hook in _reset_hooks:
        hook()


def digest() -> dict:
    """The run's summary: phase totals and calls, counters, and, after a
    profile run, per-kernel bounds and the memory peak.  The ``summary``
    event at exit carries it."""
    d = {
        "phase_s": {k: round(v, 4) for k, v in _acc.items()},
        "phase_calls": dict(_cnt),
        "counters": counters_snapshot(),
    }
    if _nested:
        d["phase_nested"] = sorted(_nested)
    from .memory import memory_digest
    from .profile import profile_digest
    from .xprof import compile_digest, xprof_digest
    kernels = profile_digest()
    if kernels:
        d["kernels"] = kernels
    mem = memory_digest()
    if mem:
        d["memory"] = mem
    xp = xprof_digest()
    if xp:
        d["xprof"] = xp
    comp = compile_digest()
    if comp:
        d["compile"] = comp
    return d


def report() -> None:
    """Log the accumulated phase times, largest first, and the
    counters."""
    if _acc:
        total = share_total(_acc)
        log.info("TIMETAG phase times (* inside another phase):")
        for name, t in sorted(_acc.items(), key=lambda kv: -kv[1]):
            log.info("  %-24s %8.3f s  (%d calls, %4.1f%%)",
                     name + (" *" if name in _nested else ""), t,
                     _cnt[name], 100.0 * t / total if total else 0.0)
    if _counters:
        log.info("telemetry counters:")
        for name, v in sorted(_counters.items()):
            fv = float(v)
            log.info("  %-32s %s", name,
                     int(fv) if fv.is_integer() else round(fv, 4))


# ---------------------------------------------------------------------------
# Collective traffic (parallel/mesh.py, parallel/distributed.py)
# ---------------------------------------------------------------------------

def record_collective(kind: str, x) -> None:
    """Account one device collective on tensor ``x`` (calls and bytes,
    attributed to the active phase).  The counters keep the JAX package's
    ``traced_*`` names; the port has no trace, so each call of a
    collective counts once, as it runs."""
    if _path is None:
        return
    try:
        nbytes = int(math.prod(x.shape)) * int(x.element_size())
        shape = list(x.shape)
    except Exception:  # noqa: BLE001
        nbytes, shape = 0, None
    _counters[f"collective/{kind}/traced_calls"] += 1
    _counters[f"collective/{kind}/traced_bytes"] += nbytes
    event("collective", kind=kind, bytes=nbytes, shape=shape,
          phase=_cur_phase, traced=True)


def record_collective_host(kind: str, nbytes: int) -> None:
    """Account a host-driven collective with its byte count."""
    if _path is None:
        return
    _counters[f"collective/{kind}/calls"] += 1
    _counters[f"collective/{kind}/bytes"] += int(nbytes)
    event("collective", kind=kind, bytes=int(nbytes), phase=_cur_phase,
          traced=False)


# ---------------------------------------------------------------------------
# Process lifecycle
# ---------------------------------------------------------------------------

def _at_exit() -> None:
    if _path is not None:
        event("summary", **digest())
        _close_sink()
    if TIMETAG_ENABLED:
        report()


def _ensure_atexit() -> None:
    global _atexit_on
    if not _atexit_on:
        atexit.register(_at_exit)
        _atexit_on = True


if TIMETAG_ENABLED:
    _ensure_atexit()

_env_sink = os.environ.get("LGBM_TPU_TELEMETRY", "")
if _env_sink and _env_sink != "0":
    enable(_env_sink)
