"""The device-memory census: attribution, peaks per phase, release audit
(counterpart of lightgbm_tpu/obs/memory.py, with its event schema).

Training's device footprint is a handful of logical buffers: the binned
matrix (feature major for the grower, row major for score replays), the
gradients, the histogram pool, the training and validation scores and
the stacked forest.  ``snapshot`` attributes the bytes of the tensors the
caller names, reads the caching allocator (``torch.cuda.memory_stats``:
``allocated_bytes.all.current``, and ``max_memory_allocated`` for the
peak), reports the unattributed rest, and keeps the run's peak.  In
profile mode every phase exit reads the allocator's peak since the last
exit and resets it (``torch.cuda.reset_peak_memory_stats``), so each
phase has the peak of its own work.  Without a card (the CPU) there are
no allocator statistics: ``snapshot`` returns None and the probes do
nothing, as the JAX module does without device statistics.

The release audit: a caller names a tensor a phase should release
(``expect_released``, a weak reference); ``audit`` warns when it is still
alive, an extra reference pinning device memory.

Every entry point does nothing unless telemetry or profile mode is on.
"""
from __future__ import annotations

import weakref
from typing import Dict, List, Optional, Tuple

from ..utils import log
from . import core

_peak_bytes = 0
_peak_phase = ""
_phase_peaks: Dict[str, int] = {}   # phase name -> its peak bytes
_expected: List[tuple] = []         # (name, weakref, registered-phase)
_warned_survivors = set()
_snapshots = 0


def _active() -> bool:
    from . import profile
    return core.enabled() or profile.profile_enabled()


def _leaves(buf):
    """The tensors of a tensor, a list or tuple, or a dict of them."""
    if isinstance(buf, dict):
        buf = list(buf.values())
    if isinstance(buf, (list, tuple)):
        for part in buf:
            yield from _leaves(part)
    elif buf is not None and hasattr(buf, "element_size"):
        yield buf


def _tensor_bytes(t) -> int:
    return int(t.numel()) * int(t.element_size())


def _tree_bytes(buf) -> int:
    return sum(_tensor_bytes(t) for t in _leaves(buf))


def _device_stats(reset: bool = False) -> Tuple[Optional[int],
                                                Optional[int]]:
    """(bytes allocated now, peak since the last reset) over the local
    cards, or (None, None) without one.  ``reset`` starts a new peak."""
    import torch
    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return None, None
    in_use = peak = 0
    for i in range(torch.cuda.device_count()):
        in_use += int(torch.cuda.memory_allocated(i))
        peak += int(torch.cuda.max_memory_allocated(i))
        if reset:
            torch.cuda.reset_peak_memory_stats(i)
    return in_use, peak


def _note_peak(nbytes: int, phase: str) -> None:
    global _peak_bytes, _peak_phase
    if nbytes > _peak_bytes:
        _peak_bytes = nbytes
        _peak_phase = phase


def snapshot(phase: str, buffers: Optional[dict] = None) -> Optional[dict]:
    """One census point: the bytes of the named buffers, the allocator's
    current and peak bytes, the unattributed rest; emits a
    ``memory_census`` event.  None when inactive or without a card."""
    global _snapshots
    if not _active():
        return None
    in_use, peak = _device_stats()
    if in_use is None:
        return None
    attributed = {}
    seen = set()  # logical names may alias one tensor; count it once
    for name, buf in (buffers or {}).items():
        nb = 0
        for t in _leaves(buf):
            key = (t.data_ptr(), _tensor_bytes(t))
            if key not in seen:
                seen.add(key)
                nb += _tensor_bytes(t)
        if nb:
            attributed[name] = nb
    _note_peak(max(in_use, peak), phase)
    _snapshots += 1
    rec = {
        "phase": phase,
        "buffers": attributed,
        "live_bytes": in_use,
        "live_count": len(seen),
        "unattributed_bytes": max(in_use - sum(attributed.values()), 0),
        "peak_bytes": _peak_bytes,
        "device_bytes_in_use": in_use,
        "device_peak_bytes": peak,
    }
    core.event("memory_census", **rec)
    return rec


def phase_probe(phase: str) -> None:
    """The per-phase-exit hook of profile mode: the allocator's peak since
    the previous exit, kept as this phase's, then reset."""
    in_use, peak = _device_stats(reset=True)
    if in_use is None:
        return
    if peak > _phase_peaks.get(phase, 0):
        _phase_peaks[phase] = peak
    _note_peak(peak, phase)


def expect_released(name: str, arr) -> None:
    """Register tensor ``arr`` as one the current phase should release;
    the next :func:`audit` warns if it is still alive.  A name registered
    again replaces its entry."""
    if not _active() or arr is None:
        return
    try:
        ref = weakref.ref(arr)
    except TypeError:
        return
    _expected[:] = [e for e in _expected if e[0] != name]
    _expected.append((name, ref, core.current_phase()))


def audit(phase: str = "") -> List[str]:
    """Check every registered release; returns the names still alive,
    each warned once, with a ``donation_audit`` event."""
    if not _expected:
        return []
    survivors = []
    for name, ref, reg_phase in _expected:
        a = ref()
        if a is None:
            continue
        survivors.append(name)
        if name not in _warned_survivors:
            _warned_survivors.add(name)
            log.warning(
                "memory census: tensor %r (%s bytes, registered in phase "
                "%r) survived phase %r: an extra reference is pinning "
                "device memory that was expected to be released",
                name, _tree_bytes(a), reg_phase, phase)
    _expected.clear()
    if survivors:
        core.event("donation_audit", phase=phase, survivors=survivors,
                   survived=True)
    return survivors


def peak_bytes() -> int:
    """The largest allocator peak seen by the snapshots and probes."""
    return _peak_bytes


def memory_digest() -> dict:
    """The census summary for ``obs.digest()`` (empty when nothing was
    probed)."""
    if not _snapshots and not _phase_peaks:
        return {}
    out = {"peak_bytes": _peak_bytes, "peak_phase": _peak_phase,
           "snapshots": _snapshots}
    if _phase_peaks:
        out["phase_peak_bytes"] = dict(sorted(_phase_peaks.items()))
    return out


def reset_memory() -> None:
    global _peak_bytes, _peak_phase, _snapshots
    _peak_bytes = 0
    _peak_phase = ""
    _snapshots = 0
    _phase_peaks.clear()
    _expected.clear()
    _warned_survivors.clear()


core._register_reset(reset_memory)
