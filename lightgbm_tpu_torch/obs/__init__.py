"""The observability plane (counterpart of lightgbm_tpu/obs/, with its
event schema, so the JAX package's ``obs/report.py`` and
``tools/trace_export.py`` read what the port writes): telemetry events,
counters and phase timers (``core``), the kernel-build counter
(``trace``), spans and the flight recorder (``spans``), the device-memory
census (``memory``), kernel times against their bounds (``profile``),
training-health sentinels (``health``), and the drift and quality plane
(``drift``).

Quick start::

    LGBM_TPU_TELEMETRY=/tmp/telem python train.py

or ``obs.enable("/tmp/telem")`` / the ``tpu_telemetry`` parameter.
``LGBM_TPU_PROFILE=1`` (``tpu_profile``) times each hand kernel with CUDA
events against its bound; ``LGBM_TPU_HEALTH=monitor|strict``
(``tpu_health``) arms the sentinels; ``LGBM_TPU_TRACE=1`` (``tpu_trace``)
writes spans; ``LGBM_TPU_FLIGHT=<n>`` (``tpu_flight_len``) sizes the
flight ring.  ``LGBM_TPU_TRAIN_METRICS=<port>`` (``tpu_train_metrics_port``)
serves the train board (``board``: ``/metrics``, ``/progress``,
``/debug/flight``); ``LGBM_TPU_XPROF=1`` (``tpu_xprof``,
``tpu_xprof_iters``) records a ``torch.profiler`` window of a few
iterations and holds its kernels against their bounds (``xprof``);
across ranks ``ranks`` names a straggler (``tpu_straggler_factor``,
``tpu_straggler_iters``) and scores each iteration against the cost
functions.  ``python -m lightgbm_tpu_torch.obs.report <dir>`` summarizes
a sink (``report``).  With every gate off each hook is a boolean check:
no sink file, no synchronization, no host read.
"""
from .core import (TIMETAG_ENABLED, add, count, counter_value,
                   counters_snapshot, current_phase, digest, disable,
                   enable, enabled, event, gauge, phase, phase_delta,
                   phase_snapshot, record_collective,
                   record_collective_host, report, reset, sink_path, sync,
                   tracing_enabled)
from .drift import (DriftMonitor, DriftSketch, QualityProfile,
                    accumulate_occupancy, bin_features, coarsen,
                    compute_occupancy, device_occupancy, init_occupancy, ks,
                    profile_path, psi)
from .health import (TrainingHealthError, check_gradients, check_score,
                     check_tree, divergence_audit, enable_health,
                     health_enabled, health_mode, model_fingerprint)
from .memory import (audit as memory_audit, expect_released, memory_digest,
                     peak_bytes)
from .memory import snapshot as memory_snapshot
from .profile import (device_peaks, enable_profile, profile_digest,
                      profile_enabled, record_kernel, roofline_seconds)
from .profile import wrap as profile_wrap
from .spans import (Span, begin_span, current_context, emit_span,
                    enable_flight, enable_trace, end_span, flight_dump,
                    flight_enabled, flight_len, flight_len_from_env,
                    flight_snapshot, new_span_id, new_trace_id, span,
                    span_record_enabled, trace_enabled)
from .ranks import RankAggregator, Reconciler, StragglerDetector, skew_table
from .trace import compile_count, compile_seconds, install_recompile_hook
from .xprof import (WindowedCapture, attribute, compile_digest,
                    install_compile_observer, maybe_window,
                    measured_rooflines, parse_trace_dir, record_measured,
                    resolve_trace_dir, resolve_window, trace_files,
                    train_context, watch_jit, xprof_digest)
from .board import TrainBoard
from .board import active as board_active
from .board import current as train_board

__all__ = [
    "TIMETAG_ENABLED", "add", "count", "counter_value",
    "counters_snapshot", "current_phase", "digest", "disable", "enable",
    "enabled", "event", "gauge", "phase", "phase_delta", "phase_snapshot",
    "record_collective", "record_collective_host", "report", "reset",
    "sink_path", "sync", "tracing_enabled",
    "DriftMonitor", "DriftSketch", "QualityProfile",
    "accumulate_occupancy", "bin_features", "coarsen",
    "compute_occupancy", "device_occupancy", "init_occupancy", "ks",
    "profile_path", "psi",
    "compile_count", "compile_seconds", "install_recompile_hook",
    "device_peaks", "enable_profile", "profile_digest", "profile_enabled",
    "profile_wrap", "record_kernel", "roofline_seconds",
    "memory_audit", "memory_digest", "memory_snapshot", "expect_released",
    "peak_bytes",
    "TrainingHealthError", "check_gradients", "check_score", "check_tree",
    "divergence_audit", "enable_health", "health_enabled", "health_mode",
    "model_fingerprint",
    "Span", "begin_span", "current_context", "emit_span", "enable_flight",
    "enable_trace", "end_span", "flight_dump", "flight_enabled",
    "flight_len", "flight_len_from_env", "flight_snapshot", "new_span_id",
    "new_trace_id", "span", "span_record_enabled", "trace_enabled",
    "TrainBoard", "board_active", "train_board",
    "RankAggregator", "Reconciler", "StragglerDetector", "skew_table",
    "WindowedCapture", "attribute", "compile_digest",
    "install_compile_observer", "maybe_window", "measured_rooflines",
    "parse_trace_dir", "record_measured", "resolve_trace_dir",
    "resolve_window", "trace_files", "train_context", "watch_jit",
    "xprof_digest",
]
