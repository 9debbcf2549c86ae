"""Compile-cache switch and the store plumbing of ``serve/aot.py``
(counterpart of lightgbm_tpu/utils/compile_cache.py).

The JAX package points XLA's persistent compilation cache at
``tpu_compile_cache_dir`` / ``$LGBM_TPU_COMPILE_CACHE`` so a restart
skips the grower's compile.  The port has no XLA compile to cache: its
device code is eager torch ops, and its hand kernels are built once per
source digest into ``build/`` (``ops/build.py``), where a restart finds
them.  ``enable_compile_cache`` and ``compile_cache_info`` keep the JAX
signatures and record the directory only; the parameter stays accepted
with no effect.

``atomic_write_bytes`` and ``store_entries`` are the on-disk hygiene the
serving store shares: durable atomic writes and the listing of a store's
entries.
"""
from __future__ import annotations

import os
from typing import Optional

from . import log

_state = {"dir": None, "warm": None}


def _entry_count(path: str) -> int:
    try:
        return sum(len(fs) for _, _, fs in os.walk(path))
    except OSError:
        return 0


def enable_compile_cache(path: Optional[str] = None) -> Optional[str]:
    """Record ``path`` (else ``$LGBM_TPU_COMPILE_CACHE``) as the cache
    directory; no-op when neither is set.  Nothing is compiled into it:
    returns the directory recorded, or None."""
    p = path or os.environ.get("LGBM_TPU_COMPILE_CACHE", "")
    if not p:
        return _state["dir"]
    p = os.path.abspath(os.path.expanduser(str(p)))
    if _state["dir"] == p:
        return p
    _state["dir"] = p
    _state["warm"] = _entry_count(p) > 0
    log.info("tpu_compile_cache_dir %s recorded; the port has no XLA "
             "compile to cache (its kernels are built into build/)", p)
    return p


def compile_cache_info() -> dict:
    """{"dir": path-or-None, "warm": bool-or-None} as of enable time."""
    return dict(_state)


def atomic_write_bytes(path: str, data: bytes) -> None:
    """Write ``data`` to ``path`` through a temporary file in the same
    directory and ``os.replace``, so a concurrent reader (another serving
    process loading the store) sees the old entry or the whole new one,
    never a torn write.  Raises on failure: the caller decides how loud a
    failed store write is."""
    d = os.path.dirname(path) or "."
    os.makedirs(d, exist_ok=True)
    tmp = os.path.join(d, f".{os.path.basename(path)}.tmp.{os.getpid()}")
    try:
        with open(tmp, "wb") as fh:
            fh.write(data)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
    finally:
        try:
            if os.path.exists(tmp):
                os.remove(tmp)
        except OSError:
            pass


def store_entries(path: Optional[str], suffix: str = ".aot") -> list:
    """Entry file names under a store directory, sorted; empty for a
    missing or unreadable directory (a cold store, not an error)."""
    if not path:
        return []
    try:
        return sorted(f for f in os.listdir(path) if f.endswith(suffix))
    except OSError:
        return []
