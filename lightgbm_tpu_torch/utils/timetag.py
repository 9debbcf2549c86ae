"""Per-phase wall-time accumulation — the TIMETAG analog (counterpart of
lightgbm_tpu/utils/timetag.py).

The reference compiles ``std::chrono`` phase accumulators in under
``#ifdef TIMETAG`` and prints them at teardown (reference:
src/treelearner/serial_tree_learner.cpp:21-60, src/boosting/gbdt.cpp:30-56).
Here the switch is the ``LGBM_TPU_TIMETAG`` environment variable (``1``),
read once at import, as in the JAX package:

    with timetag("predict (forest scan)"):
        out = scan(...)
        sync(out)

``sync(x)`` waits for the device only while the gate is on, so normal
runs keep PyTorch's asynchronous launches.  The totals print at process
exit and through :func:`report`.
"""
from __future__ import annotations

import atexit
import os
import time
from collections import defaultdict

from . import log

ENABLED = os.environ.get("LGBM_TPU_TIMETAG", "") not in ("", "0", "false")

_acc = defaultdict(float)       # phase name -> accumulated seconds
_cnt = defaultdict(int)         # phase name -> completed enter/exit pairs


class timetag:
    """Context manager adding its wall time to ``name`` when the gate is
    on; a no-op otherwise."""

    __slots__ = ("name", "t0")

    def __init__(self, name: str):
        self.name = name
        self.t0 = None

    def __enter__(self):
        if ENABLED:
            self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type=None, exc_value=None, tb=None):
        if self.t0 is not None:
            add(self.name, time.perf_counter() - self.t0)
            self.t0 = None
        return False


def sync(x):
    """Wait for the device work behind tensor ``x`` only while the gate is
    on.  Returns ``x``."""
    if ENABLED and x is not None and getattr(x, "is_cuda", False):
        import torch
        torch.cuda.synchronize(x.device)
    return x


def add(name: str, seconds: float) -> None:
    """Accumulate a phase timed elsewhere."""
    if ENABLED:
        _acc[name] += seconds
        _cnt[name] += 1


def reset() -> None:
    _acc.clear()
    _cnt.clear()


def report() -> None:
    """Log the accumulated phase times, largest first."""
    total = sum(_acc.values())
    if not total:
        return
    log.info("TIMETAG phase times:")
    for name, t in sorted(_acc.items(), key=lambda kv: -kv[1]):
        log.info("  %-24s %8.3f s  (%d calls, %4.1f%%)", name, t, _cnt[name],
                 100.0 * t / total)


if ENABLED:
    atexit.register(report)
