"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Every source is compiled by its own ``nvcc`` process, all started
together, into an object under ``build/``; the objects are linked into
one shared library with a plain C interface, loaded through ctypes.  The
library's name is keyed by the content of every source and the flags, so
a changed source rebuilds at first use and an unchanged one is reused.
The compilers' output (ptxas register and shared-memory reports) is kept
beside the library as ``.log``; each build is counted
(``obs/trace.py``).  ``-fmad=false``: no kernel may contract
a multiply and an add into one rounding where the reference rounds twice.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build"
_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = _ARCH + ["-std=c++17", "-O3", "-fmad=false", "-Xcompiler",
                      "-fPIC", "-Xptxas", "-v"]

_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
# C entry points: name -> (argument types, result type)
_SIGNATURES = {
    "lgbm_hist_wave": ([_P] * 4 + [_I] * 6 + [_P] * 9, _I),
    "lgbm_hist_wave_int": ([_P] * 6 + [_I] * 5 + [_P] * 8, _I),
    "lgbm_hist_channels": ([_P] * 2 + [_I] * 6 + [_P] * 3, _I),
    "lgbm_hist_channels_smem_bytes": ([_I], _I),
    "lgbm_split_scan": ([_P] * 10 + [_I] * 6 + [_D] * 7 + [_P] * 2, _I),
}

_lib = None
_lib_lock = threading.Lock()


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    return str(cand) if cand.exists() else "nvcc"


def build() -> Path:
    """Compile every ``csrc/*.cu`` and link them into
    ``build/lgbm_kernels_<key>.so``; returns the library path."""
    srcs = sorted(SRC_DIR.glob("*.cu"))
    key = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in srcs:
        key.update(src.name.encode() + b"\0" + src.read_bytes())
    key = key.hexdigest()[:12]
    lib = BUILD_DIR / f"lgbm_kernels_{key}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    tag = f"{key}.{os.getpid()}"
    jobs = []
    for src in srcs:
        obj = BUILD_DIR / f"{src.stem}_{tag}.o"
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((src, obj, proc))
    log, failed = [], []
    for src, obj, proc in jobs:
        out, _ = proc.communicate()
        log.append(f"== {src.name}\n{out.strip()}")
        if proc.returncode != 0:
            failed.append(src.name)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    if not failed:
        res = subprocess.run(
            [_nvcc(), *_ARCH, "-shared", "-o", str(tmp),
             *(str(obj) for _, obj, _ in jobs)],
            capture_output=True, text=True)
        log.append(f"== link\n{(res.stdout + res.stderr).strip()}")
        if res.returncode != 0:
            failed.append("link")
    for _, obj, _ in jobs:
        obj.unlink(missing_ok=True)
    text = "\n".join(log)
    lib.with_suffix(".log").write_text(text)
    if failed:
        raise RuntimeError(f"nvcc failed on {', '.join(failed)}:\n{text}")
    os.replace(tmp, lib)
    from ..obs.trace import note_build
    note_build(time.perf_counter() - t0)
    return lib


def load():
    """The kernels' library (built at first use) with every entry point's
    ctypes signature set."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, (args, res) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = args
                fn.restype = res
            _lib = lib
    return _lib


def check_launch(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
