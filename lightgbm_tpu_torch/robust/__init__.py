"""Fault tolerance (counterpart of lightgbm_tpu/robust/): atomic
checkpoints with bit-exact resume (``checkpoint``), the device guard
and the serving router's circuit breaker (``watchdog``), and the
``LGBM_TPU_FAULTS`` injection harness (``faults``)."""
from .checkpoint import CheckpointManager, config_digest
from .faults import FaultInjected, FaultTransient
from .watchdog import (CircuitBreaker, DeviceGuard, DeviceWedgedError,
                       classify_error)

__all__ = ["CheckpointManager", "CircuitBreaker", "config_digest",
           "DeviceGuard",
           "DeviceWedgedError", "classify_error", "FaultInjected",
           "FaultTransient"]
