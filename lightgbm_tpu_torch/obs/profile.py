"""Profile mode: each hand kernel's time against its bound (counterpart
of lightgbm_tpu/obs/profile.py, with its ``kernel_profile`` event).

With the gate on (``LGBM_TPU_PROFILE=1`` or ``tpu_profile``) every
launch of a wrapped kernel is timed with CUDA events on its stream (host
clocks around an asynchronous launch would measure the launch), and is
held against the least time the card could take for the same work: the
larger of its bytes over the memory rate and its operations over the f32
rate.  The bytes and operations are the port's own counts of each
kernel, the functions ``chip_smoke.py`` reports with
(``ops/hist_wave.py hist_wave_cost``, ``ops/hist_channels.py
hist_channels_cost``); the JAX package's TPU cost model is not ported.
Profile mode synchronizes every phase and launch: it attributes time and
is no benchmark.

Off, :func:`wrap` returns its argument, and nothing else runs.  Events
reach disk only with a telemetry sink; the per-kernel sums reach
``obs.digest()`` either way.
"""
from __future__ import annotations

import os
import time
from typing import Dict, Optional, Tuple

from ..utils import log
from . import core

# NVIDIA H100 SXM data sheet: HBM3 bytes per second, and f32 operations
# per second outside the tensor cores (the kernels add f32 or integers)
H100_HBM_BYTES_PER_S = 3.35e12
H100_F32_OPS_PER_S = 67e12
H100_F64_OPS_PER_S = 34e12

# (device name substring, peak operations per second, peak bytes per
# second); the first match wins.  The CPU row is a rough one-core figure,
# for exercising the machinery, not for CPU bounds.
DEVICE_PEAKS = (
    ("h100", H100_F32_OPS_PER_S, H100_HBM_BYTES_PER_S),
    ("cpu", 100e9, 20e9),
)

_env = os.environ.get("LGBM_TPU_PROFILE", "")
_on = _env not in ("", "0", "false")

_agg: Dict[str, dict] = {}   # kernel name -> aggregate record
_announced = False
_unknown_kind_warned = set()


def profile_enabled() -> bool:
    """True when profile mode is on (LGBM_TPU_PROFILE or enable)."""
    return _on


def enable_profile(on: bool = True) -> None:
    """Flip the process-wide profile gate (``tpu_profile`` on one Booster
    leaves it on for later ones until ``enable_profile(False)``)."""
    global _on, _announced
    _on = bool(on)
    core._set_profile_active(_on)
    if _on and not _announced:
        _announced = True
        log.info("profile mode ON for the rest of the process: every "
                 "phase and kernel launch is synchronized; do not read "
                 "throughput from this run; obs.enable_profile(False) "
                 "turns it off")


def device_kind() -> str:
    import torch
    if torch.cuda.is_available():
        try:
            return torch.cuda.get_device_name(0)
        except Exception:  # noqa: BLE001
            return "unknown"
    return "cpu"


def device_peaks(device=None) -> Tuple[float, float]:
    """(peak operations per second, peak bytes per second) of the card
    (default: card 0).  ``LGBM_TPU_PEAK_FLOPS`` / ``LGBM_TPU_PEAK_BW``
    override the table; a name the table lacks warns once and takes the
    CPU row."""
    env_f = os.environ.get("LGBM_TPU_PEAK_FLOPS", "")
    env_b = os.environ.get("LGBM_TPU_PEAK_BW", "")
    kind = str(device if device is not None else device_kind()).lower()
    base = None
    for sub, fl, bw in DEVICE_PEAKS:
        if sub in kind:
            base = (fl, bw)
            break
    if base is None:
        if kind not in _unknown_kind_warned:
            _unknown_kind_warned.add(kind)
            log.warning("device %r not in the peak table; bounds use the "
                        "CPU row; set LGBM_TPU_PEAK_FLOPS / LGBM_TPU_PEAK_BW",
                        kind)
        base = DEVICE_PEAKS[-1][1:]
    return (float(env_f) if env_f else base[0],
            float(env_b) if env_b else base[1])


def roofline_seconds(flops: float, nbytes: float,
                     peaks: Optional[Tuple[float, float]] = None) -> float:
    """The bound: the slower of the operations and the bytes."""
    pf, pb = peaks if peaks is not None else device_peaks()
    return max(flops / pf if pf else 0.0, nbytes / pb if pb else 0.0)


def record_kernel(name: str, flops: float, nbytes: float, achieved_s: float,
                  phase: str = None, **extra) -> None:
    """Fold one kernel execution into the sums and emit its
    ``kernel_profile`` event."""
    rf = roofline_seconds(flops, nbytes)
    frac = rf / achieved_s if achieved_s > 0 else 0.0
    a = _agg.get(name)
    if a is None:
        a = _agg[name] = {"calls": 0, "achieved_s": 0.0, "flops": 0.0,
                          "bytes": 0.0, "roofline_s": 0.0, "best_frac": 0.0}
    a["calls"] += 1
    a["achieved_s"] += achieved_s
    a["flops"] += flops
    a["bytes"] += nbytes
    a["roofline_s"] += rf
    a["best_frac"] = max(a["best_frac"], frac)
    core.event("kernel_profile", kernel=name,
               phase=phase if phase is not None else core.current_phase(),
               flops=flops, bytes=nbytes, achieved_s=round(achieved_s, 9),
               roofline_s=round(rf, 9), roofline_frac=round(frac, 6),
               device=device_kind(), **extra)


def _cuda_device(args, kwargs):
    for x in list(args) + list(kwargs.values()):
        if getattr(x, "is_cuda", False):
            return x.device
    return None


class _Profiled:
    """A kernel wrapper timing each call: CUDA events on the current
    stream for CUDA tensors, the host clock for CPU ones (the plain
    version).  ``cost(*args, **kwargs)`` gives the call's (operations,
    bytes)."""

    __slots__ = ("name", "fn", "cost")

    def __init__(self, name: str, fn, cost=None):
        self.name = name
        self.fn = fn
        self.cost = cost

    def __call__(self, *args, **kwargs):
        if not _on:
            return self.fn(*args, **kwargs)
        dev = _cuda_device(args, kwargs)
        if dev is not None:
            import torch
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            out = self.fn(*args, **kwargs)
            stop.record()
            stop.synchronize()
            secs = start.elapsed_time(stop) / 1e3
        else:
            t0 = time.perf_counter()
            out = self.fn(*args, **kwargs)
            secs = time.perf_counter() - t0
        flops, nbytes = (self.cost(*args, **kwargs) if self.cost is not None
                         else (0.0, 0.0))
        record_kernel(self.name, float(flops), float(nbytes), secs)
        return out


def wrap(name: str, fn, cost=None):
    """``fn`` timed and held against ``cost``'s bound while profile mode
    is on; with it off, ``fn`` itself, or, once a profiler window is
    armed, ``fn`` named ``lgbm/<name>`` in its trace
    (``obs/xprof.py watch_jit``)."""
    if fn is None or isinstance(fn, _Profiled):
        return fn
    if not _on:
        from .xprof import watch_jit
        return watch_jit("lgbm/" + name, fn)
    return _Profiled(name, fn, cost)


def profile_digest() -> dict:
    """Per-kernel sums for ``obs.digest()``."""
    out = {}
    for name, a in _agg.items():
        ach = a["achieved_s"]
        out[name] = {
            "calls": a["calls"],
            "achieved_s": round(ach, 9),
            "flops": a["flops"],
            "bytes": a["bytes"],
            "roofline_s": round(a["roofline_s"], 9),
            "roofline_frac": round(a["roofline_s"] / ach, 6) if ach else 0.0,
            "best_frac": round(a["best_frac"], 6),
        }
    return out


def reset_profile() -> None:
    _agg.clear()


core._register_reset(reset_profile)
if _on:
    core._set_profile_active(True)
