"""Logging for lightgbm_tpu_torch (a copy of lightgbm_tpu/utils/log.py).

TPU-native rebuild of the reference's static ``Log`` class
(reference: include/LightGBM/utils/log.h:21-108): four levels gated by a
global verbosity, with ``fatal`` raising instead of ``abort()``-ing so the
Python API surfaces errors as exceptions (like the C API's error string path).
"""
from __future__ import annotations

import sys

FATAL = -1
WARNING = 0
INFO = 1
DEBUG = 2

_level = INFO


def set_verbosity(verbosity: int) -> None:
    """Map the LightGBM ``verbosity`` parameter onto a log level.

    <0 → fatal only, 0 → warnings, 1 → info, >=2 → debug.
    """
    global _level
    if verbosity < 0:
        _level = FATAL
    elif verbosity == 0:
        _level = WARNING
    elif verbosity == 1:
        _level = INFO
    else:
        _level = DEBUG


def verbosity() -> int:
    """The current level as a ``verbosity`` value (-1, 0, 1 or 2)."""
    return _level


class LightGBMError(Exception):
    """Raised on fatal errors (the rebuild's analog of Log::Fatal)."""


def debug(msg: str, *args) -> None:
    if _level >= DEBUG:
        _emit("Debug", msg % args if args else msg)


def info(msg: str, *args) -> None:
    if _level >= INFO:
        _emit("Info", msg % args if args else msg)


def warning(msg: str, *args) -> None:
    if _level >= WARNING:
        _emit("Warning", msg % args if args else msg)


def fatal(msg: str, *args) -> None:
    raise LightGBMError(msg % args if args else msg)


def _emit(tag: str, msg: str) -> None:
    sys.stderr.write(f"[LightGBM-Torch] [{tag}] {msg}\n")
    sys.stderr.flush()


def refuse(what: str, item: str) -> None:
    """Raise for something the port does not do yet, naming the ROADMAP.md
    port-queue item that brings it."""
    fatal(f"{what} is not in the PyTorch port yet (ROADMAP.md port queue: "
          f"{item})")


def check(cond: bool, msg: str = "check failed") -> None:
    if not cond:
        fatal(msg)
