"""Dynamic request microbatching for serving (counterpart of
lightgbm_tpu/serve/batcher.py; pure Python, carried across as it stands).

Requests queue as they arrive and are coalesced into one device batch
when either the row cap (``tpu_serve_max_batch``) fills or the OLDEST
queued request has waited ``tpu_serve_max_wait_ms``: latency is bounded
by the wait knob, throughput by the cap.  The queue itself is bounded in
ROWS (``tpu_serve_queue_depth``): when full, ``submit`` raises
``ServeOverloadError`` at once, explicit backpressure the caller can act
on (shed load, retry elsewhere) instead of unbounded memory growth.

The batcher owns only the queueing policy; padding to power-of-two row
buckets and the device dispatch live in the session's execute callback
(``serve/session.py``), which fails a batch whose device call failed with
:class:`DeviceFailed` (the port never answers from the host).
"""
from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import List, Optional


# priority classes, most- to least-important.  Overload sheds from the
# LOW end first: each class owns a fraction of the queue-row budget, so
# a saturating flood of low-priority bulk traffic hits ITS cap while
# interactive high-priority requests still have headroom.
PRIORITIES = ("high", "normal", "low")
DEFAULT_SHED_FRACS = {"high": 1.0, "normal": 0.85, "low": 0.5}


def normalize_priority(value) -> str:
    """Map a request's priority field to a known class (unknown/absent
    values serve as ``normal`` rather than erroring — shedding is an
    overload policy, not an input validator)."""
    p = str(value or "normal").strip().lower()
    return p if p in PRIORITIES else "normal"


class ServeOverloadError(RuntimeError):
    """The bounded request queue is full — backpressure, not OOM.
    ``priority`` is the class of the rejected request; ``shed`` is True
    when the rejection came from a priority class's partial budget
    (rows remained for higher classes), False at the absolute cap."""

    def __init__(self, msg: str, priority: str = "normal",
                 shed: bool = False):
        super().__init__(msg)
        self.priority = priority
        self.shed = shed


class DeadlineExceeded(RuntimeError):
    """The request outlived its deadline before results were ready."""


class DeviceFailed(RuntimeError):
    """The device could not answer: the batch's device call failed, or
    the session is degraded and its device re-probe is not due (or
    failed).  The port never answers such a request from the host; the
    HTTP edge maps this to 503 with ``Retry-After``.  The message carries
    the device error's own text, so ``robust/watchdog.py classify_error``
    sorts it as that error."""


class Request:
    """One queued prediction request: binned rows for the device path,
    the raw rows kept alongside (the arena bins them at execute time).
    Request-level accounting lives in the session's ``result()`` (one
    count per ticket); this carries only the batching state plus the
    trace context (trace_id minted at the HTTP edge, parent_id = the
    request's root span) the session's span emission attributes to.

    ``model`` is the cross-model coalescing lane (serve/arena.py): an
    arena batcher mixes requests for DIFFERENT resident tenants in one
    device launch, so each request carries its tenant and the execute
    callback builds the per-row model-id vector from it.  None outside
    an arena — single-model sessions never read it."""

    __slots__ = ("bins", "raw", "n", "future", "deadline", "t_submit",
                 "t_submit_wall", "trace_id", "parent_id", "priority",
                 "model")

    def __init__(self, bins, raw, deadline: Optional[float] = None,
                 trace_id: Optional[str] = None,
                 parent_id: Optional[str] = None,
                 priority: str = "normal",
                 model: Optional[str] = None):
        self.bins = bins
        self.raw = raw
        self.n = int(bins.shape[0])
        self.future: Future = Future()
        self.deadline = deadline        # absolute time.monotonic() or None
        self.t_submit = time.monotonic()
        self.t_submit_wall = time.time()  # span timestamps are wall clock
        self.trace_id = trace_id
        self.parent_id = parent_id
        self.priority = normalize_priority(priority)
        self.model = model


class MicroBatcher:
    """Coalesce queued requests into batches of <= ``max_batch`` rows on
    a single worker thread; dispatch order is arrival order (whole
    requests only — a request is never split across batches)."""

    def __init__(self, execute, max_batch: int, max_wait_s: float,
                 max_queue_rows: int, name: str = "lgbm-serve-batcher",
                 shed_fracs: Optional[dict] = None):
        self._execute = execute
        self.max_batch = max(int(max_batch), 1)
        self.max_wait_s = max(float(max_wait_s), 0.0)
        self.max_queue_rows = max(int(max_queue_rows), self.max_batch)
        # per-priority queue-row budgets (fraction of max_queue_rows);
        # high priority always owns the full queue, and normal/high
        # budgets floor at one full batch so default traffic can always
        # be admitted to an idle queue — only LOW may be configured
        # below a batch (bulk traffic on a tiny queue is shed by design)
        fracs = dict(DEFAULT_SHED_FRACS)
        fracs.update(shed_fracs or {})
        fracs["high"] = 1.0
        self.shed_caps = {p: max(int(self.max_queue_rows
                                     * min(max(float(fracs.get(p, 1.0)),
                                               0.0), 1.0)),
                                 0 if p == "low" else self.max_batch)
                          for p in PRIORITIES}
        self._q: deque = deque()
        self._rows = 0
        self._closed = False
        self._cv = threading.Condition()
        self._thread = threading.Thread(target=self._loop, name=name,
                                        daemon=True)
        self._thread.start()

    @property
    def queue_rows(self) -> int:
        with self._cv:
            return self._rows

    def submit(self, req: Request) -> Future:
        with self._cv:
            if self._closed:
                raise RuntimeError("batcher is closed")
            cap = self.shed_caps.get(req.priority, self.max_queue_rows)
            if self._rows + req.n > cap:
                raise ServeOverloadError(
                    f"serve queue full for priority {req.priority!r} "
                    f"({self._rows} rows queued, cap {cap} of "
                    f"{self.max_queue_rows})",
                    priority=req.priority,
                    shed=cap < self.max_queue_rows)
            self._q.append(req)
            self._rows += req.n
            self._cv.notify_all()
        return req.future

    # ------------------------------------------------------------------
    def _take_batch(self) -> Optional[List[Request]]:
        """Block until a batch is ready; None once closed AND drained."""
        with self._cv:
            while not self._q and not self._closed:
                self._cv.wait()
            if not self._q:
                return None
            # linger until the cap fills or the oldest request's wait
            # budget runs out; close drains immediately
            deadline = self._q[0].t_submit + self.max_wait_s
            while self._rows < self.max_batch and not self._closed:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._cv.wait(remaining)
            batch: List[Request] = []
            total = 0
            while self._q and (not batch
                               or total + self._q[0].n <= self.max_batch):
                r = self._q.popleft()
                batch.append(r)
                total += r.n
            self._rows -= total
            return batch

    def _loop(self) -> None:
        while True:
            batch = self._take_batch()
            if batch is None:
                return
            try:
                self._execute(batch)
            except BaseException as exc:  # noqa: BLE001 — worker must live
                for r in batch:
                    if not r.future.done():
                        try:
                            r.future.set_exception(exc)
                        except BaseException:  # noqa: BLE001 cancel race
                            pass

    # ------------------------------------------------------------------
    def close(self, timeout: float = 10.0) -> None:
        """Stop accepting work, drain the queue, join the worker.  Any
        request the worker could not drain fails loudly rather than
        hanging its caller."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._thread.join(timeout)
        with self._cv:
            leftovers = list(self._q)
            self._q.clear()
            self._rows = 0
        for r in leftovers:
            if not r.future.done():
                try:
                    r.future.set_exception(RuntimeError("batcher closed"))
                except BaseException:  # noqa: BLE001 — cancel race
                    pass
