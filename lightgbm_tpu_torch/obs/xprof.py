"""The profiler window: a ``torch.profiler`` capture of a few training
iterations, read back and held against the port's cost functions
(counterpart of lightgbm_tpu/obs/xprof.py).

1. **Capture.**  :func:`maybe_window` arms a :class:`WindowedCapture`
   around ``tpu_xprof_iters`` iterations (after the first two: the first
   builds and warms) when ``tpu_xprof`` or ``LGBM_TPU_XPROF`` asks for
   it.  On the card it records CPU and CUDA activity, on the CPU the CPU
   only; while it records, every phase timer (``obs/core.py phase``) opens a
   ``torch.profiler.record_function`` range ``lgbm/<phase>``.  The
   window ends with ``torch.cuda.synchronize`` and writes a Chrome trace,
   ``*.trace.json``, under ``<sink>/xprof/``.

2. **Parsing** (:func:`parse_trace_dir`), stdlib only: it never raises on
   an empty, truncated or corrupt file; each failure is a line in the
   result's ``errors``.

3. **Attribution** (:func:`attribute`) and the **bounds**
   (:func:`measured_rooflines`).  The hand kernels are launched through
   ctypes, so no torch op stands above them: they are found by their CUDA
   symbol (``hist_wave*`` is K1, ``lgbm/hist_wave``; ``hist_channels*``
   is K2, ``lgbm/hist_channels``).  Other device work goes to the
   innermost ``lgbm/*`` range that contains it on the device's timeline
   (the profiler's ``gpu_user_annotation`` events), or, failing that, to
   the range around its launch on the host.  What is left on a device
   track is ``unattributed``.  Scopes with a cost function (K1, K2, the
   partition, the pair pass, TreeSHAP) get the bound of the window's work
   beside the measured time: the ``kernel_measured`` events.  Without a
   device track (a CPU window) the host ranges themselves are the rows.

4. **Builds.**  The port compiles its CUDA kernels once per source
   digest (``ops/build.py``) and captures one CUDA graph per serving
   bucket (``serve/aot.py``); :func:`compile_digest` counts both
   (``obs/trace.py`` notes them).  :func:`watch_jit` names a call's range
   while a window records: there is no jit to watch.
"""
from __future__ import annotations

import glob
import gzip
import json
import os
import re
import socket
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from ..utils import log
from . import core

__all__ = [
    "WindowedCapture",
    "attribute",
    "compile_digest",
    "install_compile_observer",
    "maybe_window",
    "measured_rooflines",
    "parse_trace_dir",
    "record_measured",
    "reset_xprof",
    "resolve_trace_dir",
    "resolve_window",
    "trace_files",
    "train_context",
    "watch_jit",
    "xprof_digest",
]

# ---------------------------------------------------------------------------
# trace parsing (stdlib only)
# ---------------------------------------------------------------------------

_SCOPE_RE = re.compile(r"lgbm/[A-Za-z0-9_.\-]+")

# the hand kernels, by a piece of their CUDA symbol
_KERNEL_SCOPES = (("hist_wave", "lgbm/hist_wave"),
                  ("hist_channels", "lgbm/hist_channels"))
# Kineto's categories of device work, and of a range shown on a device's
# timeline
_DEVICE_CATS = frozenset(("kernel", "gpu_memcpy", "gpu_memset"))
_DEVICE_RANGE_CAT = "gpu_user_annotation"


def trace_files(path: str) -> List[str]:
    """Every Chrome trace under *path* (recursive): the window's
    ``*.trace.json`` (and ``torch.profiler``'s ``*.pt.trace.json``), or
    gzipped ones."""
    if not path or not os.path.isdir(path):
        return []
    out = []
    for pat in ("*.trace.json.gz", "*.trace.json"):
        out.extend(glob.glob(os.path.join(path, "**", pat), recursive=True))
    return sorted(set(out))


def _load_trace(path: str) -> Dict[str, Any]:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as fh:
        doc = json.loads(fh.read().decode("utf-8", "replace"))
    if not isinstance(doc, dict):
        raise ValueError("trace root is not an object")
    return doc


def _is_device_event(cat: str, proc: str) -> bool:
    """The port's device-track rule.  Kineto gives device work its own
    categories (``kernel``, ``gpu_memcpy``, ``gpu_memset``) on a process
    per card; the JAX package's rule (``/device:`` processes or ``xla``
    threads) matches none of them.  A process named ``GPU ...`` counts
    too."""
    return cat in _DEVICE_CATS or proc.upper().startswith("GPU")


def _kernel_scope(name: str) -> Optional[str]:
    for piece, scope in _KERNEL_SCOPES:
        if piece in name:
            return scope
    return None


def _scope_of(name: str) -> Optional[str]:
    if name.startswith("lgbm/"):
        # a phase range keeps its whole name ("lgbm/tree growth")
        if " " in name:
            return name
        m = _SCOPE_RE.match(name)
        return m.group(0) if m else name
    m = _SCOPE_RE.search(name)
    return m.group(0) if m else None


def parse_trace_dir(path: str) -> Dict[str, Any]:
    """Every trace under *path* as one flat list of scoped events.

    Never raises for a bad file: an empty directory, a truncated gzip
    stream or corrupt JSON give an empty result with the failure in
    ``errors``.  Returns ``{"dir", "files", "parsed", "errors", "ops",
    "tracks", "window_us"}``: ``ops`` the scoped events (``{"name",
    "scope", "device", "thread", "dur_us", "ts"}``, ``device`` "" for a
    host range), ``tracks`` per device ``{ops, busy_us,
    unattributed_us}``."""
    files = trace_files(path)
    out: Dict[str, Any] = {
        "dir": path, "files": len(files), "parsed": 0,
        "errors": [], "ops": [], "tracks": {}, "window_us": 0.0,
    }
    for f in files:
        try:
            doc = _load_trace(f)
        except (OSError, EOFError, ValueError) as exc:
            out["errors"].append(
                "%s: %s" % (os.path.basename(f), type(exc).__name__))
            continue
        events = doc.get("traceEvents")
        if not isinstance(events, list):
            out["errors"].append(
                "%s: no traceEvents list" % os.path.basename(f))
            continue
        out["parsed"] += 1
        _fold_events(events, out)
    return out


def _innermost(ranges: List[Tuple[float, float, str]], ts: float,
               end: float) -> Optional[str]:
    """The shortest range in ``ranges`` (ts, end, scope) holding
    [ts, end]."""
    best, best_len = None, None
    for lo, hi, scope in ranges:
        if lo <= ts and end <= hi and (best_len is None
                                       or hi - lo < best_len):
            best, best_len = scope, hi - lo
    return best


def _fold_events(events: Sequence[Any], out: Dict[str, Any]) -> None:
    procs: Dict[Any, str] = {}
    threads: Dict[Tuple[Any, Any], str] = {}
    for e in events:  # metadata: pid/tid -> names
        if not isinstance(e, dict) or e.get("ph") != "M":
            continue
        args = e.get("args") or {}
        if e.get("name") == "process_name":
            procs[e.get("pid")] = str(args.get("name", ""))
        elif e.get("name") == "thread_name":
            threads[(e.get("pid"), e.get("tid"))] = str(args.get("name", ""))

    host_ranges: Dict[Any, list] = {}    # (pid, tid) -> [(lo, hi, scope)]
    dev_ranges: Dict[Any, list] = {}     # device pid -> [(lo, hi, scope)]
    launches: Dict[Any, tuple] = {}      # correlation -> (pid, tid, ts)
    dev_ops = []
    t_lo, t_hi = None, None
    for e in events:
        if not isinstance(e, dict) or e.get("ph") != "X":
            continue
        try:
            ts = float(e.get("ts", 0.0))
            dur = float(e.get("dur", 0.0))
        except (TypeError, ValueError):
            continue
        if dur < 0:
            continue
        name = str(e.get("name", ""))
        cat = str(e.get("cat", "") or "")
        if cat == "Trace":
            continue  # the profiler's own span over the whole window
        t_lo = ts if t_lo is None else min(t_lo, ts)
        t_hi = ts + dur if t_hi is None else max(t_hi, ts + dur)
        pid, tid = e.get("pid"), e.get("tid")
        args = e.get("args") if isinstance(e.get("args"), dict) else {}
        proc = procs.get(pid, "")
        if cat == _DEVICE_RANGE_CAT:
            scope = _scope_of(name)
            if scope is not None:
                dev_ranges.setdefault(pid, []).append((ts, ts + dur, scope))
            continue
        if cat == "cuda_runtime" and args.get("correlation") is not None:
            launches[args["correlation"]] = (pid, tid, ts)
        if _is_device_event(cat, proc):
            dev_ops.append((e, name, pid, ts, dur, args))
            continue
        scope = _scope_of(name) if name.startswith("lgbm/") else None
        if scope is None:
            continue  # host op: interpreter and dispatcher work
        host_ranges.setdefault((pid, tid), []).append((ts, ts + dur, scope))
        out["ops"].append({"name": name[:160], "scope": scope, "device": "",
                           "thread": threads.get((pid, tid), ""),
                           "dur_us": dur, "ts": ts})

    tracks = out["tracks"]
    for e, name, pid, ts, dur, args in dev_ops:
        dev = args.get("device")
        track = (f"GPU {dev}" if dev is not None
                 else procs.get(pid, "") or "device")
        scope = _kernel_scope(name)
        if scope is None:
            scope = _innermost(dev_ranges.get(pid, ()), ts, ts + dur)
        if scope is None and args.get("correlation") in launches:
            lp, lt, lts = launches[args["correlation"]]
            scope = _innermost(host_ranges.get((lp, lt), ()), lts, lts)
        t = tracks.get(track)
        if t is None:
            t = tracks[track] = {"ops": 0, "busy_us": 0.0,
                                 "unattributed_us": 0.0}
        t["ops"] += 1
        t["busy_us"] += dur
        if scope is None:
            t["unattributed_us"] += dur
            continue
        out["ops"].append({"name": name[:160], "scope": scope,
                           "device": track, "thread": "",
                           "dur_us": dur, "ts": ts})
    if t_lo is not None:
        out["window_us"] = max(out["window_us"], t_hi - t_lo)


# ---------------------------------------------------------------------------
# attribution
# ---------------------------------------------------------------------------

def attribute(parsed: Dict[str, Any]) -> Dict[str, Any]:
    """Parsed durations by ``lgbm/*`` scope.

    Returns ``{"window_ms", "kernels": {scope: {ops, measured_ms,
    devices}}, "devices": {track: {ops, busy_ms, unattributed_ms}},
    "errors", "files", "parsed"}``.  A scope with device work is measured
    by its device time alone (a host range's wall on the card is launch
    time, not work); a scope seen only on the host (a CPU window) by its
    ranges' wall."""
    kernels: Dict[str, Dict[str, Any]] = {}
    on_device = {op["scope"] for op in parsed.get("ops", ()) if op["device"]}
    for op in parsed.get("ops", ()):
        if op["scope"] in on_device and not op["device"]:
            continue
        k = kernels.setdefault(
            op["scope"], {"ops": 0, "measured_ms": 0.0, "devices": set()})
        k["ops"] += 1
        k["measured_ms"] += op["dur_us"] / 1e3
        k["devices"].add(op["device"] or "host")
    for k in kernels.values():
        k["devices"] = sorted(k["devices"])
        k["measured_ms"] = round(k["measured_ms"], 4)
    devices = {
        track: {"ops": int(t["ops"]),
                "busy_ms": round(t["busy_us"] / 1e3, 4),
                "unattributed_ms": round(t["unattributed_us"] / 1e3, 4)}
        for track, t in parsed.get("tracks", {}).items()}
    return {
        "window_ms": round(parsed.get("window_us", 0.0) / 1e3, 4),
        "kernels": kernels,
        "devices": devices,
        "errors": list(parsed.get("errors", ())),
        "files": parsed.get("files", 0),
        "parsed": parsed.get("parsed", 0),
    }


# ---------------------------------------------------------------------------
# the bounds of the window's work (the port's cost functions)
# ---------------------------------------------------------------------------

def _counts(booster: Any) -> Dict[str, float]:
    """The kernels' launch counts and K1's slotted rows so far."""
    from ..ops.hist_channels import hist_channels
    from ..ops.hist_wave import hist_wave
    gbdt = getattr(booster, "_gbdt", None)
    stats = getattr(gbdt, "wave_stats", None) or []
    return {"k1_launches": int(hist_wave.launches),
            "k1_plain_calls": int(hist_wave.plain_calls),
            "k1_rows": int(sum(r for _, r in stats)),
            "k2_launches": int(hist_channels.launches)}


def train_context(booster: Any = None, **extra: Any) -> Dict[str, Any]:
    """What :func:`measured_rooflines` needs of a training run: rows,
    physical columns, bins, the K1 mode and layout, the query sizes of a
    ranking objective; the window adds the launches and rows its
    iterations took (``"_counts"``, read at its start and its end)."""
    ctx: Dict[str, Any] = {}
    gbdt = getattr(booster, "_gbdt", None)
    if gbdt is not None:
        ds = getattr(gbdt, "train_ds", None)
        if ds is not None:
            ctx["rows"] = int(getattr(ds, "num_data", 0) or 0)
            bins = getattr(ds, "X_bin", None)
            ctx["features"] = int(bins.shape[1] if bins is not None
                                  else getattr(ds, "num_features", 0))
            qb = getattr(getattr(ds, "metadata", None), "query_boundaries",
                         None)
            if qb is not None and getattr(gbdt, "objective", None) is not \
                    None and getattr(gbdt.objective, "name", "") == \
                    "lambdarank":
                import numpy as np
                ctx["query_sizes"] = np.diff(np.asarray(qb, np.int64))
        ctx["bins"] = int(getattr(gbdt, "B", 256) or 256)
        ctx["mode"] = str(getattr(gbdt, "hist_mode", "2xbf16"))
        kw = getattr(gbdt, "wave_kw", None) or {}
        ctx["packed"] = bool(kw.get("packed", True))
        ctx["fused"] = bool(kw.get("fused_sibling", False))
        cfg = getattr(gbdt, "config", None)
        if cfg is not None:
            ctx["leaves"] = int(getattr(cfg, "num_leaves", 31) or 31)
        ctx["_counts"] = lambda: _counts(booster)
    ctx.update({k: v for k, v in extra.items() if v is not None})
    return ctx


def _model_cost(scope: str, ctx: Dict[str, Any]
                ) -> Optional[Tuple[float, float, str]]:
    """(operations, bytes, model name) of *scope*'s work over the window,
    or None where no cost function covers it."""
    if not ctx:
        return None
    iters = max(int(ctx.get("iters", 1) or 1), 1)
    N = int(ctx.get("rows", 0) or 0)
    F = int(ctx.get("features", 0) or 0)
    B = int(ctx.get("bins", 256) or 256)
    # K1's launches on the card; on the CPU, the plain version's calls
    # (the same work, held against the CPU row of the peak table)
    n = int(ctx.get("k1_launches") or ctx.get("k1_plain_calls") or 0)
    if scope == "lgbm/hist_wave" and N and F and n:
        from ..ops.hist_wave import hist_wave_cost
        rows = float(ctx.get("k1_rows") or N * n) / n
        ops, nbytes = hist_wave_cost(
            N, F, B, rows, packed=bool(ctx.get("packed", True)),
            fused=bool(ctx.get("fused", False)),
            quant=str(ctx.get("mode")) in ("int16", "int8"))
        return ops * n, nbytes * n, "hist_wave"
    if scope == "lgbm/hist_channels" and N and F and ctx.get("k2_launches"):
        from ..ops.hist_channels import hist_channels_cost
        n = int(ctx["k2_launches"])
        ops, nbytes = hist_channels_cost(N, F, B, int(ctx.get("channels",
                                                              32)))
        return ops * n, nbytes * n, "hist_channels"
    if scope == "lgbm/partition" and N:
        from ..core.splitter import partition_cost
        splits = max(int(ctx.get("leaves", 31) or 31) - 1, 1)
        ops, nbytes = partition_cost(N, splits=splits, batched=True)
        return ops * iters, nbytes * iters, "partition"
    if scope == "lgbm/boosting (grad/hess)" and ctx.get("query_sizes") \
            is not None and len(ctx["query_sizes"]):
        from ..ops.rank import rank_pair_cost
        ops, nbytes = rank_pair_cost(ctx["query_sizes"], 1)
        return ops * iters, nbytes * iters, "rank_pair"
    if scope == "lgbm/forest_shap" and ctx.get("shap"):
        from ..ops.treeshap import shap_cost
        ops, nbytes = shap_cost(**ctx["shap"])
        return float(ops), float(nbytes), "shap"
    return None


def measured_rooflines(attrib: Dict[str, Any],
                       context: Optional[Dict[str, Any]] = None
                       ) -> List[Dict[str, Any]]:
    """One ``kernel_measured`` row per attributed scope (and one
    ``unattributed`` row per device track with time left): the measured
    ms, and, where a cost function covers the scope, the bound's ms
    (``model_ms``), the fraction of the bound reached (``roofline_frac``,
    bound over measured) and whether bytes or operations bound it."""
    context = context or {}
    window_ms = float(attrib.get("window_ms", 0.0) or 0.0)
    rows: List[Dict[str, Any]] = []
    for scope in sorted(attrib.get("kernels", ())):
        k = attrib["kernels"][scope]
        measured_ms = float(k["measured_ms"])
        row: Dict[str, Any] = {
            "kernel": scope,
            "ops": int(k["ops"]),
            "measured_ms": round(measured_ms, 4),
            "window_ms": window_ms,
            "source": "xprof",
            "device": ",".join(k.get("devices", ())) or "host",
        }
        if window_ms > 0:
            row["occupancy"] = round(measured_ms / window_ms, 4)
        cost = _model_cost(scope, context)
        if cost is not None and measured_ms > 0:
            ops, nbytes, model = cost
            from .profile import device_peaks
            pf, pb = device_peaks()
            t_ops = ops / pf if pf else 0.0
            t_bytes = nbytes / pb if pb else 0.0
            model_ms = max(t_ops, t_bytes) * 1e3
            if model_ms > 0:
                row.update({
                    "flops": float(ops), "bytes": float(nbytes),
                    "model": model,
                    "model_ms": round(model_ms, 6),
                    "roofline_frac": round(model_ms / measured_ms, 6),
                    "bound": "operations" if t_ops >= t_bytes else "bytes",
                })
        rows.append(row)
    for dev in sorted(attrib.get("devices", ())):
        d = attrib["devices"][dev]
        if d.get("unattributed_ms", 0.0) <= 0:
            continue
        row = {
            "kernel": "unattributed",
            "ops": int(d["ops"]),
            "measured_ms": round(float(d["unattributed_ms"]), 4),
            "window_ms": window_ms,
            "source": "xprof",
            "device": dev,
        }
        if window_ms > 0:
            row["occupancy"] = round(row["measured_ms"] / window_ms, 4)
        rows.append(row)
    return rows


# ---------------------------------------------------------------------------
# module state: the digest and the events
# ---------------------------------------------------------------------------

def _fresh_state() -> Dict[str, Any]:
    return {"kernels": {}, "window_ms": 0.0, "devices": {},
            "trace_dir": "", "errors": [], "files": 0, "parsed": 0}


_state = _fresh_state()


def record_measured(attrib: Dict[str, Any],
                    context: Optional[Dict[str, Any]] = None,
                    trace_dir: str = "") -> List[Dict[str, Any]]:
    """Emit the ``kernel_measured`` events and fold them into the
    digest."""
    rows = measured_rooflines(attrib, context)
    _state["window_ms"] = float(attrib.get("window_ms", 0.0) or 0.0)
    _state["devices"] = {
        d: dict(v) for d, v in attrib.get("devices", {}).items()}
    _state["trace_dir"] = trace_dir or str(attrib.get("dir", ""))
    _state["errors"] = list(attrib.get("errors", ()))
    _state["files"] = int(attrib.get("files", 0) or 0)
    _state["parsed"] = int(attrib.get("parsed", 0) or 0)
    for row in rows:
        key = row["kernel"]
        if key == "unattributed" and row.get("device"):
            key = "unattributed(%s)" % row["device"]
        _state["kernels"][key] = {
            f: row[f] for f in (
                "ops", "measured_ms", "model_ms", "roofline_frac",
                "bound", "occupancy", "model") if f in row}
        core.event("kernel_measured", **row)
    return rows


def xprof_digest() -> Dict[str, Any]:
    """The window's block of ``core.digest()`` (``{}`` when none ran)."""
    if not _state["kernels"] and not _state["errors"]:
        return {}
    out = {
        "window_ms": round(_state["window_ms"], 3),
        "trace_files": _state["files"],
        "trace_parsed": _state["parsed"],
        "kernels": {k: dict(v) for k, v in sorted(_state["kernels"].items())},
    }
    if _state["errors"]:
        out["errors"] = list(_state["errors"])
    if _state["trace_dir"]:
        out["trace_dir"] = _state["trace_dir"]
    return out


# ---------------------------------------------------------------------------
# builds and graph captures
# ---------------------------------------------------------------------------

def install_compile_observer() -> bool:
    """Kept for the JAX package's API: ``obs/trace.py`` notes every
    kernel build and graph capture where it happens, so there is nothing
    to install."""
    return True


def compile_digest() -> Dict[str, Any]:
    """The compile plane of ``core.digest()`` (``{}`` when nothing was
    built or captured): the JAX package's keys (no XLA compile in the
    port) and the port's kernel builds and CUDA graph captures."""
    from . import trace
    builds, build_s, captures = trace.build_and_capture_counts()
    if not (builds or captures):
        return {}
    return {
        "compiles": 0,
        "wall_s": 0.0,
        "by_jit": {},
        "cache_hits": 0,
        "cache_misses": 0,
        "retraces": 0,
        "kernel_builds": builds,
        "kernel_build_s": round(build_s, 4),
        "graph_captures": dict(sorted(captures.items())),
    }


# true while a window records: the watched calls open their ranges
_capturing = [False]


class _Watched:
    """A call that opens its named ``record_function`` range while a
    window records (one list lookup otherwise)."""

    def __init__(self, name: str, fn: Callable):
        self._name = name
        self._fn = fn

    def __getattr__(self, item: str) -> Any:
        return getattr(self._fn, item)

    def __call__(self, *args: Any, **kwargs: Any) -> Any:
        if _capturing[0]:
            import torch
            with torch.profiler.record_function(self._name):
                return self._fn(*args, **kwargs)
        return self._fn(*args, **kwargs)


# a window was armed in this process (maybe_window)
_armed_flag = [False]


def watch_jit(name: str, fn: Optional[Callable]) -> Optional[Callable]:
    """*fn* with its calls named ``name`` in a window's trace, once a
    window is armed; *fn* itself otherwise.  The JAX package's form also
    reports retraces (an argument signature that forces ``jax.jit`` to
    compile again); the port compiles nothing per shape, so there is
    nothing of that to report."""
    if fn is None or not _armed_flag[0] or isinstance(fn, _Watched):
        return fn
    return _Watched(name, fn)


# ---------------------------------------------------------------------------
# the window
# ---------------------------------------------------------------------------

class WindowedCapture:
    """``torch.profiler`` around a few training iterations.

    Call :meth:`step` once after each completed iteration.  The profiler
    starts after ``skip + 1`` of them (the JAX package's count: with the
    default ``skip=1`` iterations 0 and 1 pass through), records
    ``iters`` iterations, the device is synchronized, the profiler stops,
    and the trace is written and read (``kernel_measured`` events).  ``close``,
    in a ``finally``, ends a window the loop did not finish.  Outside the
    window a ``step`` is two integer compares (``hook_s`` sums its
    cost)."""

    def __init__(self, out_dir: str, iters: int = 3, skip: int = 1,
                 context: Optional[Dict[str, Any]] = None,
                 sync: Optional[Callable[[], Any]] = None,
                 device: str = "cpu"):
        self.out_dir = out_dir
        self.iters = max(int(iters), 1)
        self.skip = max(int(skip), 0)
        self.context = dict(context or {})
        self.context.setdefault("iters", self.iters)
        self.device = str(device)
        self._sync = sync
        self._prof = None
        self._counts0: Optional[Dict[str, float]] = None
        self._seen = 0
        self._active = False
        self._done = False
        self.hook_s = 0.0
        self.rows: List[Dict[str, Any]] = []
        self.attrib: Optional[Dict[str, Any]] = None
        self.trace_path = ""
        self.error = ""

    @property
    def active(self) -> bool:
        return self._active

    @property
    def done(self) -> bool:
        return self._done

    def step(self) -> None:
        """Call once after each completed training iteration."""
        if self._done:
            return
        t0 = time.perf_counter()
        self._seen += 1
        if not self._active:
            if self._seen > self.skip:
                self._start()
            self.hook_s += time.perf_counter() - t0
            return
        if self._seen >= self.skip + 1 + self.iters:
            self._finish()

    def close(self) -> None:
        """End a window the loop did not finish (from ``finally``)."""
        if self._active:
            self._finish()
        self._done = True
        _armed_flag[0] = False

    def _start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device == "cuda":
            acts.append(ProfilerActivity.CUDA)
        counts = self.context.get("_counts")
        self._counts0 = counts() if counts is not None else None
        try:
            os.makedirs(self.out_dir, exist_ok=True)
            if self.device == "cuda":
                torch.cuda.synchronize()
            self._prof = profile(activities=acts)
            self._prof.start()
        except Exception as exc:  # noqa: BLE001 — another profiler is on
            self.error = "profiler start: %s" % exc
            log.warning("xprof window could not start: %s", exc)
            self._done = True
            return
        self._active = True
        _capturing[0] = True
        core._set_xprof_active(True)
        log.info("xprof window open: %d iteration(s) -> %s", self.iters,
                 self.out_dir)

    def _finish(self) -> None:
        self._active = False
        self._done = True
        _capturing[0] = False
        _armed_flag[0] = False
        core._set_xprof_active(False)
        if self._sync is not None:
            self._sync()
        counts = self.context.get("_counts")
        if counts is not None and self._counts0 is not None:
            now = counts()
            self.context.update({k: now[k] - self._counts0[k] for k in now})
        self._prof.stop()
        self.trace_path = os.path.join(
            self.out_dir, "%s_%d_%d.trace.json" % (
                socket.gethostname(), os.getpid(), int(time.time() * 1e3)))
        self._prof.export_chrome_trace(self.trace_path)
        self._prof = None
        self._ingest()

    def _ingest(self) -> None:
        parsed = parse_trace_dir(self.out_dir)
        self.attrib = attribute(parsed)
        ctx = {k: v for k, v in self.context.items() if k != "_counts"}
        self.rows = record_measured(self.attrib, ctx,
                                    trace_dir=self.out_dir)
        # the same rows as reconciliation units: the profiler's device
        # time of each kernel over its bound
        from .ranks import Reconciler
        units = Reconciler().score_measured(self.rows)
        if units:
            core.event("reconciliation", iteration=int(self._seen),
                       units=units, source="xprof")
        if parsed["files"] and not parsed["parsed"]:
            self.error = "unparseable trace: %s" % "; ".join(
                parsed["errors"][:3])
            log.warning("xprof window %s", self.error)
            return
        n_kern = sum(1 for r in self.rows if r["kernel"] != "unattributed")
        log.info("xprof window closed: %d file(s), %d lgbm scope(s), "
                 "window %.1f ms", parsed["parsed"], n_kern,
                 self.attrib["window_ms"])


# ---------------------------------------------------------------------------
# arming: the environment and the parameters
# ---------------------------------------------------------------------------

_FALSY = ("", "0", "false", "off", "no")


def resolve_window(config: Any = None) -> int:
    """Iterations to record, or 0 when the window is off.

    ``LGBM_TPU_XPROF`` wins over the parameters: ``1``/``true`` arms with
    ``tpu_xprof_iters`` (default 3), a number above 1 sets the iterations,
    a false value disarms even where ``tpu_xprof`` is set."""
    cfg_iters = int(getattr(config, "tpu_xprof_iters", 0) or 0) or 3
    env = os.environ.get("LGBM_TPU_XPROF", "").strip().lower()
    if env:
        if env in _FALSY[1:]:
            return 0
        if env in ("1", "true", "on", "yes"):
            return cfg_iters
        try:
            return max(int(env), 1)
        except ValueError:
            return cfg_iters
    if getattr(config, "tpu_xprof", False):
        return cfg_iters
    return 0


def resolve_trace_dir(config: Any = None) -> str:
    """Where the trace goes: ``LGBM_TPU_XPROF_DIR``, else ``xprof/``
    beside the telemetry sink, else a new temporary directory."""
    env = os.environ.get("LGBM_TPU_XPROF_DIR", "")
    if env:
        return env
    sink = core._path or str(getattr(config, "tpu_telemetry", "") or "")
    if sink:
        if sink.endswith(".jsonl"):
            return sink[:-len(".jsonl")] + "_xprof"
        return os.path.join(sink, "xprof")
    import tempfile
    return tempfile.mkdtemp(prefix="lgbm_xprof_")


def maybe_window(config: Any = None,
                 context: Optional[Dict[str, Any]] = None,
                 sync: Optional[Callable[[], Any]] = None,
                 skip: int = 1, device: str = "cpu"
                 ) -> Optional[WindowedCapture]:
    """A window when ``tpu_xprof``/``LGBM_TPU_XPROF`` asks for one, else
    None."""
    iters = resolve_window(config)
    if iters <= 0:
        return None
    _armed_flag[0] = True
    return WindowedCapture(resolve_trace_dir(config), iters=iters,
                           skip=skip, context=context, sync=sync,
                           device=device)


def reset_xprof() -> None:
    global _state
    _state = _fresh_state()
    _armed_flag[0] = False


core._register_reset(reset_xprof)
