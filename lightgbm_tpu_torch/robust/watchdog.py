"""Device-wedge watchdog: classify, retry, stamp stalls, fail safely
(counterpart of lightgbm_tpu/robust/watchdog.py: ``DeviceGuard`` for
training, ``CircuitBreaker`` for the serving router).

``DeviceGuard`` wraps the trainer's device steps (``boosting/gbdt.py``):

- **classify** — :func:`classify_error` sorts exceptions into
  ``transient`` (the runtime says "try again": a CUDA out-of-memory, the
  gRPC/absl status names, the injection harness's transient) and
  ``fatal`` (everything else, among them CUDA's "illegal memory access"
  and "unspecified launch failure", which leave the CUDA context
  unusable).
- **retry** — transient failures re-run the step after a bounded
  exponential backoff with seeded jitter (a CUDA out-of-memory first
  returns the allocator's cached blocks with ``empty_cache``).
- **stall** — a timer logs a step that outlives its deadline (explicit
  ``tpu_wedge_timeout_s``, else 4x the rolling per-step p99, floored).
  Advisory: Python cannot interrupt a kernel.
- **fatal** — the ``on_fatal`` hook (the trainer's boundary checkpoint),
  then :class:`DeviceWedgedError`, under ``abort`` and ``retry`` alike.
  A failed step never moves to the CPU: the JAX package's ``fallback``
  policy is refused (``config.py``).

A guard is active when ``tpu_watchdog`` is set or the fault harness is
armed; inactive, ``run`` only calls the step.  Active, it synchronizes
the card after the step, so an asynchronous CUDA error surfaces inside
the guarded step.  A stall and a fatal failure dump the flight ring; a
stall and every retry decision are telemetry events, also kept in
``events``.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, List, Optional

import numpy as np
import torch

from .. import obs
from ..utils import log
from . import faults


class DeviceWedgedError(RuntimeError):
    """A device step failed fatally (or exhausted its retries) and the
    policy said abort; the boundary checkpoint hook has run."""


_TRANSIENT_PATTERNS = (
    "UNAVAILABLE", "RESOURCE_EXHAUSTED", "DEADLINE_EXCEEDED", "ABORTED",
    "CANCELLED", "UNKNOWN: ", "injected transient",
    "socket closed", "connection reset", "network error",
    "CUDA out of memory",
)


def classify_error(exc: BaseException) -> str:
    """``'transient'`` or ``'fatal'`` for an in-process exception."""
    if isinstance(exc, faults.FaultTransient):
        return "transient"
    if isinstance(exc, faults.FaultInjected):
        return "fatal"
    if isinstance(exc, torch.cuda.OutOfMemoryError):
        return "transient"
    low = f"{type(exc).__name__}: {exc}".lower()
    if "illegal memory access" in low or "unspecified launch failure" in low:
        return "fatal"
    for pat in _TRANSIENT_PATTERNS:
        if pat.lower() in low:
            return "transient"
    return "fatal"


def backoff_delays(retries: int, base_s: float = 0.05, cap_s: float = 2.0,
                   seed: int = 0) -> list:
    """The deterministic backoff schedule: ``base * 2^k`` capped, plus up
    to 25% seeded jitter."""
    rng = np.random.default_rng(seed)
    return [min(base_s * (2.0 ** k), cap_s) * (1.0 + 0.25 * rng.random())
            for k in range(max(retries, 0))]


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class DeviceGuard:
    """Retry/stall/fatal policy around one trainer's device steps."""

    def __init__(self, policy: str = "retry", retries: int = 3,
                 backoff_base_s: float = 0.05, backoff_cap_s: float = 2.0,
                 stall_timeout_s: float = 0.0, stall_floor_s: float = 60.0,
                 seed: int = 0, enabled: bool = False,
                 on_fatal: Optional[Callable] = None,
                 name: str = "train"):
        if policy not in ("abort", "retry"):
            raise ValueError(f"unknown device-error policy {policy!r}")
        self.policy = policy
        self.retries = max(int(retries), 0)
        self.stall_timeout_s = float(stall_timeout_s)
        self.stall_floor_s = float(stall_floor_s)
        self.enabled = bool(enabled)
        self.on_fatal = on_fatal
        self.name = name
        self._delays = backoff_delays(self.retries, backoff_base_s,
                                      backoff_cap_s, seed)
        self._durations: deque = deque(maxlen=64)
        self._lock = threading.Lock()
        self.retry_count = 0
        self.stall_count = 0
        self.events: List[dict] = []

    @property
    def active(self) -> bool:
        return self.enabled or faults.armed()

    def _deadline_s(self) -> float:
        """Explicit timeout wins (negative: no stall deadline); else 4x
        the rolling per-step p99 once 8 steps are measured, floored."""
        if self.stall_timeout_s < 0:
            return 0.0
        if self.stall_timeout_s > 0:
            return self.stall_timeout_s
        with self._lock:
            samples = sorted(self._durations)
        if len(samples) >= 8:
            p99 = samples[min(int(np.ceil(0.99 * len(samples))) - 1,
                              len(samples) - 1)]
            return max(4.0 * p99, self.stall_floor_s)
        return self.stall_floor_s

    def snapshot(self) -> dict:
        """The guard's retries and stalls for the train board's
        ``watchdog`` provider (``obs/board.py``).  The deadline is read
        before the lock is taken: ``_deadline_s`` takes it itself."""
        deadline = self._deadline_s()
        with self._lock:
            return {"active": self.active, "policy": self.policy,
                    "retries_budget": self.retries,
                    "retry_count": self.retry_count,
                    "stall_count": self.stall_count,
                    "deadline_s": round(deadline, 3)}

    def _on_stall(self, point: str, iteration, t0: float,
                  deadline: float) -> None:
        with self._lock:
            self.stall_count += 1
            self.events.append({"event": "device_stall", "point": point,
                                "iteration": iteration,
                                "elapsed_s": time.perf_counter() - t0})
        log.warning("%s watchdog: step %r stalled past its %.1fs deadline "
                    "(iteration %s)", self.name, point, deadline, iteration)
        obs.event("device_stall", point=point,
                  elapsed_s=round(time.perf_counter() - t0, 3),
                  deadline_s=round(deadline, 3),
                  **({} if iteration is None else {"iteration": iteration}))
        if obs.flight_enabled():
            obs.flight_dump(f"device_stall:{point}")

    def run(self, fn: Callable, point: str = "device_execute",
            iteration: Optional[int] = None):
        """``fn()`` under the policy; inactive, a plain call."""
        if not self.active:
            return fn()
        attempt = 0
        while True:
            deadline = self._deadline_s()
            t0 = time.perf_counter()
            timer = None
            if deadline > 0:
                timer = threading.Timer(deadline, self._on_stall,
                                        (point, iteration, t0, deadline))
                timer.daemon = True
                timer.start()
            try:
                faults.check(point, iteration=iteration)
                out = fn()
                _sync()
                with self._lock:
                    self._durations.append(time.perf_counter() - t0)
                return out
            except Exception as exc:  # noqa: BLE001 — the classify point
                cls = classify_error(exc)
                can_retry = (cls == "transient" and attempt < self.retries
                             and self.policy != "abort")
                self._note(point, attempt, cls, exc, can_retry, iteration)
                if not can_retry:
                    return self._fatal(exc, cls, point, iteration)
                if isinstance(exc, torch.cuda.OutOfMemoryError):
                    torch.cuda.empty_cache()
                time.sleep(self._delays[attempt])
                attempt += 1
            finally:
                if timer is not None:
                    timer.cancel()

    def _note(self, point, attempt, cls, exc, will_retry, iteration) -> None:
        with self._lock:
            self.retry_count += 1
        action = "retry" if will_retry else "abort"
        self.events.append({"event": "retry", "point": point,
                            "attempt": attempt, "classify": cls,
                            "action": action, "iteration": iteration,
                            "error": f"{type(exc).__name__}: {exc}"})
        log.warning("%s watchdog: %s failure at %r (attempt %d): %s: %s — "
                    "%s", self.name, cls, point, attempt + 1,
                    type(exc).__name__, exc, action)
        obs.event("retry", point=point, attempt=attempt, classify=cls,
                  action=action, error=f"{type(exc).__name__}: {exc}",
                  **({} if iteration is None else {"iteration": iteration}))

    def _fatal(self, exc, cls, point, iteration):
        """The flight dump and the boundary-checkpoint hook, then the
        raise."""
        if obs.flight_enabled():
            obs.flight_dump(f"device_wedge:{point}",
                            extra={"error": f"{type(exc).__name__}: {exc}",
                                   "classify": cls})
        if self.on_fatal is not None:
            try:
                self.on_fatal(f"device_wedge:{point}", exc)
            except Exception as hook_exc:  # noqa: BLE001
                log.warning("%s watchdog: on_fatal hook failed (%s: %s)",
                            self.name, type(hook_exc).__name__, hook_exc)
        raise DeviceWedgedError(
            f"device step {point!r} failed ({cls})"
            + (f" at iteration {iteration}" if iteration is not None else "")
            + f": {type(exc).__name__}: {exc}") from exc



class CircuitBreaker:
    """Per-replica circuit breaker of the serving router
    (``serve/router.py``): the serving twin of :class:`DeviceGuard`, with
    the same failure taxonomy (:func:`classify_error`) and bounded seeded
    backoff (:func:`backoff_delays`), but instead of retrying in place it
    takes a replica out of the routing set, so one wedged replica costs
    capacity, not availability.  States:

    - **closed** — healthy; every request is allowed.
    - **open** — tripped (a fatal failure at once, or ``trip_after``
      consecutive transient ones); requests go elsewhere until the backoff
      expires.  Each re-trip walks the backoff schedule, so a flapping
      replica is probed less and less often.
    - **half_open** — the backoff expired; exactly one probe request is
      let through.  Success closes the breaker, failure re-opens it at the
      next backoff step.
    """

    def __init__(self, trip_after: int = 3, backoff_base_s: float = 0.5,
                 backoff_cap_s: float = 30.0, seed: int = 0):
        self.trip_after = max(int(trip_after), 1)
        # long enough that a dead replica keeps being probed at the cap
        self._delays = backoff_delays(16, backoff_base_s, backoff_cap_s,
                                      seed)
        self._lock = threading.Lock()
        self.state = "closed"
        self.failures = 0            # lifetime failures
        self.consecutive = 0         # failures since the last success
        self.opens = 0               # times the breaker tripped
        self._open_until = 0.0
        self._open_step = 0          # index into the backoff schedule
        # a half-open probe that never resolves (a sibling answered first,
        # or its thread died) must not strand the breaker: after this long
        # in half_open without a verdict another probe is allowed
        self._probe_timeout_s = max(float(backoff_cap_s), 1.0)
        self._half_open_since = 0.0
        self.last_error = ""

    def allow(self) -> bool:
        """True when a request may go to this replica.  While open, flips
        to half_open (one probe) once the backoff has expired."""
        with self._lock:
            now = time.monotonic()
            if self.state == "closed":
                return True
            if self.state == "half_open":
                if now - self._half_open_since > self._probe_timeout_s:
                    self._half_open_since = now
                    return True      # the earlier probe never resolved
                return False         # a probe is in flight
            if now >= self._open_until:
                self.state = "half_open"
                self._half_open_since = now
                return True
            return False

    def record_ok(self) -> None:
        with self._lock:
            self.consecutive = 0
            if self.state == "open":
                # only the half-open probe closes a tripped breaker: a
                # late success of a request dispatched before the trip
                # must not re-admit the replica
                return
            self.state = "closed"
            self._open_step = 0

    def record_failure(self, exc: BaseException) -> str:
        """Count one failure; returns its class.  A fatal failure, a
        failed half-open probe or ``trip_after`` consecutive transients
        open the breaker."""
        cls = classify_error(exc)
        with self._lock:
            self.failures += 1
            self.consecutive += 1
            self.last_error = f"{type(exc).__name__}: {exc}"
            if (cls == "fatal" or self.state == "half_open"
                    or self.consecutive >= self.trip_after):
                self.state = "open"
                self.opens += 1
                delay = self._delays[min(self._open_step,
                                         len(self._delays) - 1)]
                self._open_step += 1
                self._open_until = time.monotonic() + delay
        return cls

    def snapshot(self) -> dict:
        with self._lock:
            open_for = (max(self._open_until - time.monotonic(), 0.0)
                        if self.state == "open" else 0.0)
            return {"state": self.state, "failures": self.failures,
                    "consecutive": self.consecutive, "opens": self.opens,
                    "open_for_s": round(open_for, 3),
                    "last_error": self.last_error or None}
