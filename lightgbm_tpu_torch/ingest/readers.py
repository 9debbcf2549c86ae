"""Chunked row sources for streaming ingestion (counterpart of
lightgbm_tpu/ingest/readers.py).

A source is a re-iterable of ``(X_chunk, side)`` pairs: ``X_chunk`` a
2-D f64 ndarray (a scipy-sparse row block for LibSVM input) and ``side``
a dict that may hold the chunk's ``label`` / ``weight`` / ``qid`` rows.
Ingestion (``ingest/stream.py``) walks a source twice, so every walk must
yield the same rows in the same order (the reference's two_round re-read,
dataset_loader.cpp:807-827).  Optional attributes the driver reads:
``feature_names``, ``group_sizes`` (whole-stream query sizes given out of
band) and ``n_features`` (None until a LibSVM source finished a walk).
The text readers use the port's text loader's mmap windows and native
parser (``io/text_loader.py``).
"""
from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from ..utils import log


def _is_sparse(x) -> bool:
    return hasattr(x, "tocsr") and hasattr(x, "shape")


class ArraySource:
    """Chunks of an in-memory or ``np.memmap``-backed matrix (dense or
    scipy sparse); with a memmap the raw values never all sit in RAM."""

    kind = "array"

    def __init__(self, data, label=None, weight=None, group=None,
                 chunk_rows: int = 65536, feature_names=None):
        self.data = data
        self.label = None if label is None else np.asarray(label).ravel()
        self.weight = (None if weight is None
                       else np.asarray(weight).ravel())
        # per-query sizes (LightGBM convention), whole stream
        self.group_sizes = (None if group is None
                            else np.asarray(group).ravel())
        self.chunk_rows = max(int(chunk_rows), 1)
        self.n_features = int(data.shape[1])
        self.feature_names = feature_names

    def __iter__(self):
        n = int(self.data.shape[0])
        sparse = _is_sparse(self.data)
        mat = self.data.tocsr() if sparse else self.data
        for lo in range(0, n, self.chunk_rows):
            hi = min(lo + self.chunk_rows, n)
            X = mat[lo:hi]
            if not sparse:
                X = np.asarray(X, dtype=np.float64)
            side = {}
            if self.label is not None:
                side["label"] = self.label[lo:hi]
            if self.weight is not None:
                side["weight"] = self.weight[lo:hi]
            yield X, side


class SyntheticSource:
    """A generated stream, each chunk from its own child seed: a long
    stream never holds more than one chunk of raw values."""

    kind = "synthetic"

    def __init__(self, n_rows: int, n_features: int = 16,
                 chunk_rows: int = 65536, seed: int = 0,
                 tail_shift: float = 0.0):
        self.n_rows = int(n_rows)
        self.n_features = int(n_features)
        self.chunk_rows = max(int(chunk_rows), 1)
        self.seed = int(seed)
        # added to the last 10% of the rows: a drifting stream, whose tail
        # a head-only sample cannot bin
        self.tail_shift = float(tail_shift)
        self.feature_names = None
        self.group_sizes = None

    def __iter__(self):
        for ci, lo in enumerate(range(0, self.n_rows, self.chunk_rows)):
            m = min(self.chunk_rows, self.n_rows - lo)
            rng = np.random.default_rng((self.seed, ci))
            X = rng.normal(size=(m, self.n_features))
            if self.tail_shift:
                gi = lo + np.arange(m)
                X[gi >= int(0.9 * self.n_rows)] += self.tail_shift
            y = (X[:, 0] + 0.5 * X[:, 1 % self.n_features]
                 - 0.25 * X[:, 2 % self.n_features] > 0).astype(np.float64)
            yield X, {"label": y}


class NpzSource:
    """Chunks of a ``.npy`` matrix, opened as a read-only memmap (the OS
    pages rows in a chunk at a time) with optional ``<base>.y.npy`` /
    ``<base>.weight.npy`` / ``<base>.query.npy`` sidecars; or of a
    ``.npz`` archive (``X``, optional ``y`` / ``weight`` / ``group``),
    whose members are read whole (zip members cannot be memmapped)."""

    kind = "npz"

    def __init__(self, path: str, chunk_rows: int = 65536):
        self.path = path
        self.chunk_rows = max(int(chunk_rows), 1)
        self.feature_names = None
        self._X = None
        self._label = None
        self._weight = None
        self.group_sizes = None
        self._open()
        self.n_features = int(self._X.shape[1])

    def _open(self) -> None:
        if self.path.endswith(".npy"):
            self._X = np.lib.format.open_memmap(self.path, mode="r")
            base = self.path[:-len(".npy")]
            for attr, suffix in (("_label", ".y.npy"),
                                 ("_weight", ".weight.npy")):
                p = base + suffix
                if os.path.exists(p):
                    setattr(self, attr,
                            np.lib.format.open_memmap(p, mode="r"))
            q = base + ".query.npy"
            if os.path.exists(q):
                self.group_sizes = np.asarray(
                    np.lib.format.open_memmap(q, mode="r")).ravel()
        else:
            with np.load(self.path, allow_pickle=False) as z:
                if "X" not in z:
                    log.fatal(f"{self.path} has no 'X' array")
                self._X = z["X"]
                self._label = z["y"] if "y" in z else None
                self._weight = z["weight"] if "weight" in z else None
                self.group_sizes = (np.asarray(z["group"]).ravel()
                                    if "group" in z else None)
        if self._X.ndim != 2:
            log.fatal(f"{self.path}: 'X' must be 2-D, got shape "
                      f"{self._X.shape}")

    def __iter__(self):
        n = int(self._X.shape[0])
        for lo in range(0, n, self.chunk_rows):
            hi = min(lo + self.chunk_rows, n)
            side = {}
            if self._label is not None:
                side["label"] = np.asarray(self._label[lo:hi],
                                           np.float64).ravel()
            if self._weight is not None:
                side["weight"] = np.asarray(self._weight[lo:hi],
                                            np.float64).ravel()
            yield np.asarray(self._X[lo:hi], dtype=np.float64), side


class TextSource:
    """Chunks of a dense CSV/TSV file through the native mmap parser
    (``io/text_loader._iter_dense_chunks``), with the label / weight /
    group / ignore columns resolved as the in-memory loader resolves
    them.  Raises ``io.text_loader._ParseError`` where the strict parser
    is missing or rejects the file (callers then load in memory)."""

    kind = "text"

    def __init__(self, path: str, config, chunk_bytes: Optional[int] = None):
        from ..io.text_loader import _CHUNK_BYTES, _sniff_delimiter
        self.path = path
        self.config = config
        self.chunk_bytes = int(chunk_bytes or _CHUNK_BYTES)
        with open(path) as fh:
            first = fh.readline()
        self.delim = _sniff_delimiter(first.rstrip("\n"))
        self.names: List[str] = []
        self.skip = 0
        if getattr(config, "header", False):
            self.names = [t.strip()
                          for t in first.rstrip("\n").split(self.delim)]
            self.skip = 1
        self._plan = None
        self.feature_names = None
        self.n_features = None
        self.group_sizes = None

    def _resolve_plan(self, ncol: int):
        from ..io.text_loader import _column_plan
        if self._plan is None:
            self._plan = _column_plan(list(self.names), ncol, self.config)
            names, _, _, _, keep = self._plan
            self.feature_names = [names[i] for i in keep]
            self.n_features = len(keep)
        return self._plan

    def __iter__(self):
        from ..io.text_loader import _iter_dense_chunks
        for arr in _iter_dense_chunks(self.path, self.delim, self.skip,
                                      self.chunk_bytes):
            _, label_col, weight_col, group_col, keep = \
                self._resolve_plan(arr.shape[1])
            side = {"label": arr[:, label_col]}
            if weight_col is not None:
                side["weight"] = arr[:, weight_col]
            if group_col is not None:
                side["qid"] = arr[:, group_col].astype(np.int64)
            yield np.ascontiguousarray(arr[:, keep]), side


class LibSVMSource:
    """Chunks of a sparse ``label [qid:Q] idx:val`` file (the MSLR-WEB30K
    format): the native parser over mmap windows, else a per-line Python
    parse of ``chunk_rows`` lines a chunk.  It yields CSR blocks as wide
    as the largest index seen so far; ``n_features`` is final after one
    walk, and ingestion's second walk pads every chunk to it."""

    kind = "libsvm"

    def __init__(self, path: str, chunk_rows: int = 65536,
                 chunk_bytes: Optional[int] = None):
        from ..io.text_loader import _CHUNK_BYTES
        self.path = path
        self.chunk_rows = max(int(chunk_rows), 1)
        self.chunk_bytes = int(chunk_bytes or _CHUNK_BYTES)
        self.n_features: Optional[int] = None   # final after one walk
        self._max_idx = -1
        self.feature_names = None
        self.group_sizes = None

    def _emit(self, label, qid, indptr, indices, values):
        import scipy.sparse as sp
        self._max_idx = max(self._max_idx,
                            int(indices.max()) if len(indices) else -1)
        X = sp.csr_matrix((values, indices, indptr),
                          shape=(len(label), max(self._max_idx + 1, 1)))
        return X, {"label": np.asarray(label, np.float64),
                   "qid": np.asarray(qid, np.int64)}

    def __iter__(self):
        from .. import native as _native
        from ..io.text_loader import _mmap_windows
        if _native.lib() is not None:
            for mm, lo, hi in _mmap_windows(self.path, 0, self.chunk_bytes):
                out = _native.libsvm_parse(mm, offset=lo, length=hi - lo)
                if out is None:
                    from .stream import IngestError
                    raise IngestError(
                        f"{self.path}: malformed LibSVM chunk at byte "
                        f"{lo} (the strict parser rejected it)")
                lab, qid, indptr, idx, vals, _ = out
                yield self._emit(lab, qid, np.asarray(indptr, np.int64),
                                 np.asarray(idx, np.int32),
                                 np.asarray(vals, np.float64))
        else:
            yield from self._iter_python()
        self.n_features = max(self._max_idx + 1, 1)

    def _iter_python(self):
        """The lenient per-line parse, ``chunk_rows`` lines a chunk."""
        labels: List[float] = []
        qids: List[int] = []
        indptr = [0]
        idx: List[int] = []
        vals: List[float] = []

        def flush():
            return self._emit(
                labels, qids, np.asarray(indptr, np.int64),
                np.asarray(idx, np.int32), np.asarray(vals, np.float64))

        with open(self.path) as fh:
            for line in fh:
                toks = line.split()
                if not toks:
                    continue
                labels.append(float(toks[0]))
                q = -1
                for tok in toks[1:]:
                    i, _, v = tok.partition(":")
                    if i == "qid":
                        q = int(v)
                        continue
                    idx.append(int(i))
                    vals.append(float(v))
                qids.append(q)
                indptr.append(len(idx))
                if len(labels) >= self.chunk_rows:
                    yield flush()
                    labels, qids, indptr = [], [], [0]
                    idx, vals = [], []
        if labels:
            yield flush()


def open_source(path: str, config, chunk_rows: int = 65536):
    """The chunked reader of a data file: ``.npy``/``.npz`` ->
    :class:`NpzSource`, headerless ``idx:val`` rows ->
    :class:`LibSVMSource`, else :class:`TextSource` (the sniff of
    ``io/text_loader.load_text``)."""
    if not os.path.exists(path):
        log.fatal(f"Data file {path} does not exist")
    if path.endswith((".npy", ".npz")):
        return NpzSource(path, chunk_rows=chunk_rows)
    with open(path) as fh:
        first = fh.readline()
    if ":" in first and not getattr(config, "header", False):
        return LibSVMSource(path, chunk_rows=chunk_rows)
    return TextSource(path, config)
