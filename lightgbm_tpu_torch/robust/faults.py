"""Deterministic fault injection, ``LGBM_TPU_FAULTS`` (counterpart of
lightgbm_tpu/robust/faults.py, same grammar and variable).

    spec      := leg (';' leg)*
    leg       := point ':' action ('@' cond ('&' cond)*)?
    action    := raise | transient | sleep=SECONDS | hang
    cond      := iter=N     fire only during boosting iteration N
               | call=N     fire on the N-th check() at this point (1-based)
               | p=F        fire with probability F (seeded, deterministic)
               | n=N        fire at most N times (default 1; -1 = always)

Example: ``LGBM_TPU_FAULTS='device_execute:raise@iter=7'``.  ``raise``
throws :class:`FaultInjected` (fatal to the watchdog), ``transient``
:class:`FaultTransient` (its retry path), ``sleep=S`` delays the step
(the stall path), ``hang`` sleeps 3600 s.  Probabilistic conditions draw
from one numpy generator seeded by ``LGBM_TPU_FAULTS_SEED`` (default 0).
The points the port reaches are ``device_execute`` (each tree's growth,
``boosting/gbdt.py``), ``gradients``, ``checkpoint_write``
(``robust/checkpoint.py``) and the serving ones: ``serve_device``,
``serve_explain_device`` and ``serve_explain_submit``
(``serve/session.py``), ``serve_replica`` and ``serve_replica_<i>`` (each
dispatch of ``serve/router.py``, so one replica can be wedged alone),
``serve_canary`` and ``serve_swap`` (``serve/registry.py``),
``serve_arena_device`` and ``serve_arena_swap`` (``serve/arena.py``),
and the online loop's (``online/loop.py``): ``online_ingest`` on every
ingest batch, ``online_refit`` at the top of a refresh and
``online_swap`` before the registry push.  Disarmed, :func:`check` is
one ``None`` test.
"""
from __future__ import annotations

import os
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from ..utils import log


class FaultInjected(RuntimeError):
    """An injected fault (classified fatal by the watchdog)."""

    def __init__(self, point: str, detail: str = ""):
        super().__init__(f"INVALID_ARGUMENT: injected fault at {point}"
                         + (f" ({detail})" if detail else ""))
        self.point = point


class FaultTransient(FaultInjected):
    """An injected transient fault (the watchdog's retry path)."""

    def __init__(self, point: str, detail: str = ""):
        RuntimeError.__init__(
            self, f"UNAVAILABLE: injected transient fault at {point}"
            + (f" ({detail})" if detail else ""))
        self.point = point


@dataclass
class FaultSpec:
    point: str
    action: str                      # raise | transient | sleep
    arg: float = 0.0                 # sleep seconds
    iter_: Optional[int] = None
    call: Optional[int] = None
    p: Optional[float] = None
    remaining: int = 1               # -1 = unlimited
    fired: int = field(default=0)


_PLAN: Optional[List[FaultSpec]] = None
_RNG: Optional[np.random.Generator] = None
_calls = defaultdict(int)            # point -> check() count
# what fired, in order: (point, action, call, iteration); each is also a
# fault_injected telemetry event
events: List[tuple] = []


def parse_spec(spec: str) -> List[FaultSpec]:
    """Parse the grammar; ``ValueError`` on a malformed spec."""
    out: List[FaultSpec] = []
    for leg in spec.split(";"):
        leg = leg.strip()
        if not leg:
            continue
        head, _, conds = leg.partition("@")
        point, sep, action = head.partition(":")
        if not sep or not point.strip() or not action.strip():
            raise ValueError(f"fault leg {leg!r}: expected point:action")
        action = action.strip()
        arg = 0.0
        if action.startswith("sleep"):
            _, _, v = action.partition("=")
            arg = float(v) if v else 0.1
            action = "sleep"
        elif action == "hang":
            action, arg = "sleep", 3600.0
        elif action not in ("raise", "transient"):
            raise ValueError(f"fault leg {leg!r}: unknown action "
                             f"{action!r}")
        fs = FaultSpec(point=point.strip(), action=action, arg=arg)
        for cond in conds.split("&"):
            cond = cond.strip()
            if not cond:
                continue
            k, sep, v = cond.partition("=")
            if not sep:
                raise ValueError(f"fault leg {leg!r}: bad cond {cond!r}")
            k = k.strip()
            if k == "iter":
                fs.iter_ = int(v)
            elif k == "call":
                fs.call = int(v)
            elif k == "p":
                fs.p = float(v)
            elif k == "n":
                fs.remaining = int(v)
            else:
                raise ValueError(f"fault leg {leg!r}: unknown cond key "
                                 f"{k!r}")
        out.append(fs)
    return out


def configure(spec: str, seed: Optional[int] = None) -> None:
    """Arm the harness with ``spec`` (empty disarms); resets the per-point
    call counters so a spec replays identically."""
    global _PLAN, _RNG
    plan = parse_spec(spec) if spec else []
    _calls.clear()
    events.clear()
    if not plan:
        _PLAN = _RNG = None
        return
    if seed is None:
        try:
            seed = int(os.environ.get("LGBM_TPU_FAULTS_SEED", "0") or 0)
        except ValueError:
            seed = 0
    _RNG = np.random.default_rng(seed)
    _PLAN = plan
    log.warning("fault injection ARMED: %s (seed %d)", spec, seed)


def disarm() -> None:
    configure("")


def armed() -> bool:
    return _PLAN is not None


def check(point: str, iteration: Optional[int] = None) -> None:
    """The injection point: fires the first matching spec's action."""
    if _PLAN is None:
        return
    _calls[point] += 1
    call_idx = _calls[point]
    for fs in _PLAN:
        if fs.point != point or fs.remaining == 0:
            continue
        if fs.iter_ is not None and fs.iter_ != iteration:
            continue
        if fs.call is not None and fs.call != call_idx:
            continue
        if fs.p is not None and not (_RNG.random() < fs.p):
            continue
        if fs.remaining > 0:
            fs.remaining -= 1
        fs.fired += 1
        events.append((point, fs.action, call_idx, iteration))
        from .. import obs
        obs.event("fault_injected", point=point, action=fs.action,
                  call=call_idx,
                  **({} if iteration is None else {"iteration": iteration}))
        detail = (f"iter={iteration}" if iteration is not None
                  else f"call={call_idx}")
        if fs.action == "sleep":
            log.warning("fault injection: sleeping %.3fs at %s (%s)",
                        fs.arg, point, detail)
            time.sleep(fs.arg)
            return
        if fs.action == "transient":
            raise FaultTransient(point, detail)
        raise FaultInjected(point, detail)


def fired_counts() -> dict:
    """{point: times fired} across the armed plan."""
    out = defaultdict(int)
    for fs in _PLAN or []:
        out[fs.point] += fs.fired
    return dict(out)


_env_spec = os.environ.get("LGBM_TPU_FAULTS", "")
if _env_spec:
    try:
        configure(_env_spec)
    except ValueError as _exc:   # the env path cannot raise at import
        log.warning("ignoring malformed LGBM_TPU_FAULTS=%r (%s)",
                    _env_spec, _exc)
