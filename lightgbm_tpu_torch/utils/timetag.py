"""Per-phase wall-time accumulation, the TIMETAG analog (counterpart of
lightgbm_tpu/utils/timetag.py).

The reference compiles ``std::chrono`` phase accumulators in under
``#ifdef TIMETAG`` and prints them at teardown (reference:
src/treelearner/serial_tree_learner.cpp:21-60, src/boosting/gbdt.cpp:30-56).
Here the switch is the ``LGBM_TPU_TIMETAG`` environment variable (``1``).
As in the JAX package, this module is a façade over :mod:`..obs.core`: the
same accumulators feed the TIMETAG report and the telemetry stream
(``LGBM_TPU_TELEMETRY``, ``tpu_telemetry``)::

    with timetag("predict (forest scan)"):
        out = scan(...)
        sync(out)

``sync(x)`` waits for the device only while tracing is on, so normal
runs keep PyTorch's asynchronous launches.
"""
from __future__ import annotations

from ..obs.core import (TIMETAG_ENABLED as ENABLED, add, phase as timetag,
                        report, reset, sync)

__all__ = ["ENABLED", "timetag", "sync", "add", "reset", "report"]
