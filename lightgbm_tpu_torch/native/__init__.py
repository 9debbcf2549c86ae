"""ctypes loader for the native binning and text-parsing loops
(counterpart of lightgbm_tpu/native/__init__.py, the entry points that
binning and text loading use), and ``capi_abi_lib``, which builds the
loadable C ABI (``capi_abi.c``).

``binning_native.cpp`` is compiled with ``g++ -O3 -fopenmp`` at first use
into ``build/_binning_<hash>.so`` beside the CUDA kernels' library (keyed
by the source's content, so an edited source rebuilds).  Every caller
handles ``lib() is None``: without g++ the numpy implementations in
``io/binning.py`` and ``np.loadtxt`` run instead, and give the same
results.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SRC = Path(__file__).resolve().parent / "binning_native.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build"
CXX_FLAGS = ["-O3", "-fopenmp", "-shared", "-fPIC"]

_lib = None
_tried = False
_lock = threading.Lock()


def _build(so_path: Path) -> bool:
    """Compile into a temporary file, then rename: atomic under concurrent
    first use by several processes."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=str(BUILD_DIR))
    os.close(fd)
    try:
        r = subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, str(SRC)],
                           capture_output=True, timeout=120)
        if r.returncode != 0:
            return False
        os.replace(tmp, so_path)
        return True
    except (OSError, subprocess.TimeoutExpired):
        return False
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _bind(L: ctypes.CDLL) -> ctypes.CDLL:
    i64, i32 = ctypes.c_int64, ctypes.c_int32
    pd = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    pi64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    pi32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    sigs = {
        "distinct_with_zero": ([pd, i64, i64, pd, pi64], i64),
        "greedy_find_bin": ([pd, pi64, i64, i64, i64, i64, pd], i64),
        "binarize_numerical": ([ctypes.c_void_p, i64, i64, pd, i64, i32, i32,
                                pi32], None),
        "binarize_numerical_u8": ([ctypes.c_void_p, i64, i64, pd, i64, i32,
                                   i32, ctypes.c_void_p, i64], None),
        "csv_parse": ([ctypes.c_void_p, i64, ctypes.c_char, i64, pd, i64],
                      i64),
        "csv_count_lines": ([ctypes.c_void_p, i64], i64),
        "csv_line_offsets": ([ctypes.c_void_p, i64, pi64, i64], i64),
        "libsvm_parse": ([ctypes.c_void_p, i64, pd, pi64, pi64, pi32, pd,
                          i64, i64, ctypes.POINTER(i64),
                          ctypes.POINTER(i64)], i64),
    }
    for name, (args, res) in sigs.items():
        fn = getattr(L, name)
        fn.argtypes = args
        fn.restype = res
    return L


def lib() -> Optional[ctypes.CDLL]:
    """The loaded native library, or None when it cannot be built."""
    global _lib, _tried
    with _lock:
        if _lib is None and not _tried:
            _tried = True
            tag = hashlib.sha256(SRC.read_bytes() + " ".join(
                CXX_FLAGS).encode()).hexdigest()[:16]
            so_path = BUILD_DIR / f"_binning_{tag}.so"
            if so_path.exists() or _build(so_path):
                try:
                    _lib = _bind(ctypes.CDLL(str(so_path)))
                except OSError:
                    _lib = None
    return _lib


def _f64_column(col: np.ndarray) -> np.ndarray:
    """An f64 view the native loops read in place (strided columns of a
    C-order matrix included), or a contiguous copy."""
    col = np.asarray(col)
    if col.dtype != np.float64 or col.strides[0] % 8 != 0:
        col = np.ascontiguousarray(col, np.float64)
    return col


def distinct_with_zero(values: np.ndarray, zero_cnt: int):
    """Sorted distinct values and counts with the implicit zeros inserted;
    ``values``: sorted f64 without zeros and NaNs."""
    n = len(values)
    out_v = np.empty(n + 2, np.float64)
    out_c = np.empty(n + 2, np.int64)
    m = lib().distinct_with_zero(np.ascontiguousarray(values, np.float64),
                                 n, int(zero_cnt), out_v, out_c)
    return out_v[:m], out_c[:m]


def greedy_find_bin(distinct: np.ndarray, counts: np.ndarray, max_bin: int,
                    total_cnt: int, min_data_in_bin: int):
    out = np.empty(int(max_bin) + 2, np.float64)
    nb = lib().greedy_find_bin(np.ascontiguousarray(distinct, np.float64),
                               np.ascontiguousarray(counts, np.int64),
                               len(distinct), int(max_bin), int(total_cnt),
                               int(min_data_in_bin), out)
    return list(out[:nb])


def binarize_numerical(col: np.ndarray, bounds: np.ndarray, n_bounds: int,
                       missing_type: int, num_bin: int) -> np.ndarray:
    """value -> bin (int32) over the first ``n_bounds`` ascending bounds."""
    col = _f64_column(col)
    out = np.empty(len(col), np.int32)
    lib().binarize_numerical(col.ctypes.data, len(col), col.strides[0] // 8,
                             np.ascontiguousarray(bounds, np.float64),
                             int(n_bounds), int(missing_type), int(num_bin),
                             out)
    return out


def binarize_numerical_u8(col: np.ndarray, bounds: np.ndarray, n_bounds: int,
                          missing_type: int, num_bin: int,
                          out: np.ndarray) -> None:
    """Bin straight into a uint8 column view (``X[:, j]`` of a C-order
    [N, F] matrix)."""
    col = _f64_column(col)
    if out.dtype != np.uint8 or len(out) != len(col):
        raise ValueError("out must be a uint8 column as long as col")
    lib().binarize_numerical_u8(col.ctypes.data, len(col),
                                col.strides[0] // 8,
                                np.ascontiguousarray(bounds, np.float64),
                                int(n_bounds), int(missing_type),
                                int(num_bin), out.ctypes.data,
                                out.strides[0])


def _window(buf, offset: int, length: Optional[int]):
    if length is None:
        length = len(buf) - offset
    view = np.frombuffer(buf, np.uint8, count=length, offset=offset)
    return view, view.ctypes.data, length


def csv_parse(buf, delim: str, ncol: int, offset: int = 0,
              length: Optional[int] = None):
    """Parse ``buf[offset:offset+length]`` (bytes or any buffer, such as a
    read-only mmap, read in place) of delimiter-separated numbers into a
    row-major f64 [rows, ncol] array.  None on malformed input (the caller
    falls back to np.loadtxt, which is lenient)."""
    view, addr, length = _window(buf, offset, length)  # view: kept alive
    L = lib()
    max_rows = L.csv_count_lines(addr, length)
    out = np.empty((max_rows, ncol), np.float64)
    n = L.csv_parse(addr, length, delim.encode()[:1], int(ncol), out,
                    max_rows)
    return None if n < 0 else out[:n]


def csv_line_offsets(buf, offset: int = 0, length: Optional[int] = None):
    """Line start offsets (relative to ``offset``) as int64 [rows]."""
    view, addr, length = _window(buf, offset, length)
    L = lib()
    n = max(L.csv_count_lines(addr, length), 1)
    out = np.empty(n, np.int64)
    m = L.csv_line_offsets(addr, length, out, n)
    return out[:m]


def libsvm_parse(buf, offset: int = 0, length: Optional[int] = None):
    """Parse LibSVM lines (``label [qid:Q] idx:val ...``) of
    ``buf[offset:offset+length]`` -> (labels f64 [n], qids i64 [n] (-1:
    none), indptr i64 [n+1], indices i32 [nnz], values f64 [nnz], largest
    feature index).  None on malformed input (the caller falls back to the
    Python parser)."""
    view, addr, length = _window(buf, offset, length)
    L = lib()
    max_rows = L.csv_count_lines(addr, length)
    # a pair holds one ':' and a qid token one more: the colon count
    # bounds the stored entries
    max_nnz = int(np.count_nonzero(view == ord(":")))
    labels = np.empty(max_rows, np.float64)
    qids = np.empty(max_rows, np.int64)
    indptr = np.empty(max_rows + 1, np.int64)
    idx = np.empty(max(max_nnz, 1), np.int32)
    vals = np.empty(max(max_nnz, 1), np.float64)
    nnz_out = ctypes.c_int64(0)
    mf_out = ctypes.c_int64(-1)
    n = L.libsvm_parse(addr, length, labels, qids, indptr, idx, vals,
                       max_rows, max_nnz, ctypes.byref(nnz_out),
                       ctypes.byref(mf_out))
    if n < 0:
        return None
    nnz = nnz_out.value
    return (labels[:n], qids[:n], indptr[:n + 1], idx[:nnz], vals[:nnz],
            int(mf_out.value))


ABI_SRC = Path(__file__).resolve().parent / "capi_abi.c"
ABI_CFLAGS = ["-O2", "-shared", "-fPIC"]


def capi_abi_lib() -> str:
    """The loadable C ABI (``capi_abi.c``), built once with gcc against
    this interpreter's libpython into ``build/liblgbm_torch_<hash>.so``
    (keyed by the source and the flags); returns its path.  A program
    that links it embeds CPython and needs ``PYTHONPATH`` to hold the
    repository root and the site-packages of torch and numpy.  No
    fallback: a missing libpython or a failed build raises with gcc's
    output."""
    import sysconfig
    inc = sysconfig.get_paths()["include"]
    libdir = sysconfig.get_config_var("LIBDIR") or "/usr/local/lib"
    ldver = sysconfig.get_config_var("LDVERSION")
    if not ldver or not sysconfig.get_config_var("Py_ENABLE_SHARED"):
        raise RuntimeError("capi_abi_lib: this Python has no shared "
                           "libpython to link the C ABI against")
    flags = ABI_CFLAGS + [f"-I{inc}", f"-L{libdir}",
                          f"-Wl,-rpath,{libdir}", f"-lpython{ldver}"]
    tag = hashlib.sha256(ABI_SRC.read_bytes() + " ".join(
        flags).encode()).hexdigest()[:16]
    so_path = BUILD_DIR / f"liblgbm_torch_{tag}.so"
    if so_path.exists():
        return str(so_path)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=str(BUILD_DIR))
    os.close(fd)
    try:
        r = subprocess.run(["gcc", str(ABI_SRC), *flags, "-o", tmp],
                           capture_output=True, text=True, timeout=120)
        if r.returncode != 0:
            raise RuntimeError(f"gcc failed on {ABI_SRC.name}:\n"
                               f"{r.stdout}{r.stderr}")
        os.replace(tmp, so_path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return str(so_path)
