"""The build counter (counterpart of lightgbm_tpu/obs/trace.py).

The JAX package counts XLA backend compiles through ``jax.monitoring``: a
retrace of the grower costs tens of seconds and nothing else in the loop
says so.  The port compiles nothing at run time but its CUDA kernels,
which ``ops/build.py`` builds with ``nvcc`` at first use (a changed
source, or a fresh checkout).  So this module counts those builds, under
counter names of its own (``cuda/kernel_builds``, ``cuda/kernel_build_s``),
and the ``iteration`` event's ``recompiles`` field holds the builds made
during that iteration: 0 in a steady state, 1 where the first launch of
a new checkout built the library.  Builds are counted where they happen,
with every gate off too (they are rare), so :func:`install_recompile_hook`
has nothing to install.
"""
from __future__ import annotations

from . import core

BUILD_COUNTER = "cuda/kernel_builds"
BUILD_SECONDS = "cuda/kernel_build_s"


def note_build(seconds: float) -> None:
    """One kernel-library build of ``seconds`` (``ops/build.py``)."""
    core._counters[BUILD_COUNTER] += 1
    core._counters[BUILD_SECONDS] += float(seconds)


def install_recompile_hook() -> bool:
    """Kept for the JAX package's API: builds need no hook."""
    return True


def compile_count() -> int:
    """Kernel builds so far."""
    return int(core._counters.get(BUILD_COUNTER, 0))


def compile_seconds() -> float:
    return float(core._counters.get(BUILD_SECONDS, 0.0))
