"""Text dataset loading for the CLI (counterpart of
lightgbm_tpu/io/text_loader.py, its dense delimited path).

The analog of the reference's DatasetLoader text path (reference:
src/io/dataset_loader.cpp:168,807-1042): dense TSV/CSV/space-separated
files with the label in a configurable column, optional weight and group
(query id) columns, an optional header and ignored columns.  The file is parsed in place from an mmap by the native
parser (``native/binning_native.cpp`` ``csv_parse``), bit-equal to
``np.loadtxt``, which is the lenient fallback when the strict parser
rejects a file or g++ is missing.  LibSVM input, ``two_round`` loading
and the ``.weight``/``.query``/``.init`` sidecars are not in the port yet
and raise ``LightGBMError`` naming their ROADMAP.md item.
"""
from __future__ import annotations

import mmap
import os
from typing import List, Optional, Tuple

import numpy as np

from .. import native as _native
from ..utils import log

_CHUNK_BYTES = 64 * 1024 * 1024


class _ParseError(Exception):
    """The native parser rejected the file; fall back to np.loadtxt."""


def _sniff_delimiter(line: str) -> str:
    for d in ("\t", ",", " "):
        if d in line:
            return d
    return "\t"


def _file_ncol(mm, pos: int, size: int, delim: str) -> int:
    nl = mm.find(b"\n", pos)
    first = mm[pos:(nl if nl >= 0 else size)].decode(
        "utf-8", "replace").rstrip("\r")
    return len(first.split() if delim == " " else first.split(delim))


def _mmap_windows(path: str, skiprows: int, chunk_bytes: int = _CHUNK_BYTES):
    """Yield ``(mm, lo, hi)`` newline-aligned windows over an mmap of the
    file: the parser reads the page cache in place, no copies."""
    with open(path, "rb") as fh:
        size = os.fstat(fh.fileno()).st_size
        if size == 0:
            return
        mm = mmap.mmap(fh.fileno(), 0, access=mmap.ACCESS_READ)
        try:
            pos = 0
            for _ in range(skiprows):
                nl = mm.find(b"\n", pos)
                pos = (nl + 1) if nl >= 0 else size
            while pos < size:
                hi = min(pos + chunk_bytes, size)
                if hi < size:
                    nl = mm.rfind(b"\n", pos, hi)
                    if nl < pos:  # a single line longer than the window
                        nl = mm.find(b"\n", hi)
                        hi = size if nl < 0 else nl + 1
                    else:
                        hi = nl + 1
                yield mm, pos, hi
                pos = hi
        finally:
            mm.close()


def _iter_dense_chunks(path: str, delim: str, skiprows: int,
                       chunk_bytes: int = _CHUNK_BYTES):
    """Stream-parse a dense numeric text file with the native parser (the
    reference's TextReader/PipelineReader analog, utils/text_reader.h),
    yielding row-major f64 arrays.  Raises ``_ParseError`` when the native
    library is unavailable or the file needs np.loadtxt's leniency."""
    if _native.lib() is None:
        raise _ParseError("native library unavailable")
    ncol = None
    for mm, lo, hi in _mmap_windows(path, skiprows, chunk_bytes):
        if ncol is None:
            ncol = _file_ncol(mm, lo, len(mm), delim)
        arr = _native.csv_parse(mm, delim, ncol, offset=lo, length=hi - lo)
        if arr is None:
            raise _ParseError("malformed row (inconsistent columns?)")
        if len(arr):
            yield arr


def _read_dense(path: str, delim: str, skiprows: int) -> np.ndarray:
    """Whole-file dense parse: the native mmap parse, with np.loadtxt as
    the lenient fallback."""
    try:
        # one window over the whole file: one exactly sized output array
        size = max(os.path.getsize(path), 1)
        parts = list(_iter_dense_chunks(path, delim, skiprows,
                                        chunk_bytes=size))
        if parts:
            return parts[0] if len(parts) == 1 else np.vstack(parts)
    except _ParseError as exc:
        log.info("Native text parse unavailable (%s); using np.loadtxt",
                 exc)
    return np.loadtxt(path, delimiter=None if delim == " " else delim,
                      skiprows=skiprows, ndmin=2, dtype=np.float64)


def _resolve_column(spec: str, names: List[str], what: str) -> Optional[int]:
    """Column spec: "" -> None, "3" -> 3, "name:foo" -> index of foo
    (reference: dataset_loader.cpp; naming a column needs a header)."""
    if spec == "":
        return None
    if spec.startswith("name:"):
        name = spec[5:]
        if name not in names:
            log.fatal(f"{what} column {name!r} not found in header")
        return names.index(name)
    try:
        return int(spec)
    except ValueError:
        log.fatal(f"Bad {what} column spec {spec!r}")


def _column_plan(names: List[str], ncol: int, config):
    """The label/weight/group/ignore column layout of a data file ->
    (names, label_col, weight_col, group_col, keep_columns).  Integer
    weight/group/ignore indices do not count the label column (reference:
    config.h weight_column doc); ``name:`` specs are absolute header
    positions."""
    if not names:
        names = [f"Column_{i}" for i in range(ncol)]
    label_col = _resolve_column(config.label_column, names, "label")
    if label_col is None:
        label_col = 0

    def skip_label(spec: str, what: str) -> Optional[int]:
        c = _resolve_column(spec, names, what)
        if c is None or spec.startswith("name:") or c < label_col:
            return c
        return c + 1

    weight_col = skip_label(str(config.weight_column or ""), "weight")
    group_col = skip_label(str(config.group_column or ""), "group")
    drop = {label_col, weight_col, group_col} - {None}
    for tok in str(config.ignore_column or "").split(","):
        c = skip_label(tok.strip(), "ignore")
        if c is not None:
            drop.add(c)
    keep = [i for i in range(ncol) if i not in drop]
    return names, label_col, weight_col, group_col, keep


def _group_from_col(ids: Optional[np.ndarray]) -> Optional[np.ndarray]:
    """Per-row query ids (rows of a query adjacent) -> query sizes."""
    if ids is None:
        return None
    ids = ids.astype(np.int64)
    change = np.flatnonzero(np.diff(ids)) + 1
    return np.diff(np.concatenate([[0], change, [len(ids)]]))


def _refuse_sidecars(path: str) -> None:
    for suffix, what in ((".weight", "sample weights (.weight file)"),
                         (".query", "ranking (.query file)"),
                         (".group", "ranking (.group file)"),
                         (".init", "init scores (.init file)")):
        if os.path.exists(path + suffix):
            log.refuse(what, "libsvm and two_round loading")


def load_text(path: str, config) -> Tuple[np.ndarray, np.ndarray,
                                          Optional[np.ndarray],
                                          Optional[np.ndarray], List[str]]:
    """Load a dense text data file -> (X, label, weight, group,
    feature_names); weight and group (query sizes) are None without a
    ``weight_column`` / ``group_column``.  ``label_column`` counts every
    file column; the other columns are dropped from X."""
    if not os.path.exists(path):
        log.fatal(f"Data file {path} does not exist")
    if config.two_round:
        log.refuse("two_round loading", "libsvm and two_round loading")
    _refuse_sidecars(path)
    with open(path) as fh:
        first = fh.readline()
    if ":" in first and not config.header:
        log.refuse("LibSVM input", "libsvm and two_round loading")
    delim = _sniff_delimiter(first.rstrip("\n"))
    names: List[str] = []
    skip = 0
    if config.header:
        names = [t.strip() for t in first.rstrip("\n").split(delim)]
        skip = 1
    data = _read_dense(path, delim, skip)
    names, label_col, weight_col, group_col, keep = _column_plan(
        names, data.shape[1], config)
    weight = data[:, weight_col] if weight_col is not None else None
    group = _group_from_col(data[:, group_col] if group_col is not None
                            else None)
    return (data[:, keep], data[:, label_col], weight, group,
            [names[i] for i in keep])
