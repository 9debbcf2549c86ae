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
has nothing to install.  The serving store's CUDA graph captures are
noted here too (:func:`note_capture`); ``obs/xprof.py compile_digest``
reads both.
"""
from __future__ import annotations

from . import core

BUILD_COUNTER = "cuda/kernel_builds"
BUILD_SECONDS = "cuda/kernel_build_s"


# graph captures by kind (serve/aot.py), for obs/xprof.py compile_digest
_captures: dict = {}


def note_build(seconds: float) -> None:
    """One kernel-library build of ``seconds`` (``ops/build.py``): the
    counters, and a ``compile`` event of kind ``kernel_build``."""
    core._counters[BUILD_COUNTER] += 1
    core._counters[BUILD_SECONDS] += float(seconds)
    core.event("compile", kind="kernel_build", jit="cuda_kernels",
               wall_s=round(float(seconds), 4))


def note_capture(kind: str) -> None:
    """One CUDA graph captured for a serving bucket of ``kind``
    (``serve/aot.py``): a ``compile`` event of kind ``graph_capture``."""
    _captures[kind] = _captures.get(kind, 0) + 1
    core.event("compile", kind="graph_capture", jit=kind)


def _reset_captures() -> None:
    _captures.clear()


core._register_reset(_reset_captures)


def build_and_capture_counts():
    """(kernel builds, their seconds, graph captures by kind) so far."""
    return compile_count(), compile_seconds(), dict(_captures)


def install_recompile_hook() -> bool:
    """Kept for the JAX package's API: builds need no hook."""
    return True


def compile_count() -> int:
    """Kernel builds so far."""
    return int(core._counters.get(BUILD_COUNTER, 0))


def compile_seconds() -> float:
    return float(core._counters.get(BUILD_SECONDS, 0.0))
