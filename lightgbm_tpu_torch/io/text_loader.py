"""Text dataset loading for the CLI (counterpart of
lightgbm_tpu/io/text_loader.py).

The analog of the reference's DatasetLoader text path (reference:
src/io/dataset_loader.cpp:168,807-1042): dense TSV/CSV/space-separated
files with the label in a configurable column, optional weight and group
(query id) columns, an optional header and ignored columns; LibSVM files
(``label [qid:Q] idx:val ...``, the MSLR-WEB30K format) as a scipy CSR
matrix, ``qid:`` tokens giving the query boundaries; the ``.weight`` and
``.query``/``.group`` sidecars beside a data file.  The file is parsed in
place from an mmap by the native parser (``native/binning_native.cpp``
``csv_parse``, ``libsvm_parse``), bit-equal to ``np.loadtxt``, which is
the lenient fallback when the strict parser rejects a file or g++ is
missing.  ``load_text_two_round`` builds the binned dataset while
streaming the file, without its raw matrix in memory.
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


def _load_sidecars(path: str, weight, group):
    """The ``<data>.weight`` and ``<data>.query`` / ``<data>.group`` files
    where the data gives none (reference: dataset_loader.cpp LoadWeights /
    LoadQueryBoundaries; reference package: text_loader.py
    ``_load_sidecars``)."""
    wpath = path + ".weight"
    if weight is None and os.path.exists(wpath):
        weight = np.loadtxt(wpath, dtype=np.float64, ndmin=1)
        log.info("Loading weights from %s", wpath)
    if group is None:
        for suffix in (".query", ".group"):
            qpath = path + suffix
            if os.path.exists(qpath):
                group = np.loadtxt(qpath, dtype=np.int64, ndmin=1)
                log.info("Loading query boundaries from %s", qpath)
                break
    return weight, group


def _is_libsvm(first: str, config) -> bool:
    return ":" in first and not config.header


def _parse_libsvm(path: str):
    """(labels, qids, CSR triplets, largest feature index) of a LibSVM
    file: the native parser window by window, else a Python parse."""
    labels_l, qids_l, trip = [], [], []
    max_idx = -1
    if _native.lib() is not None:
        for mm, lo, hi in _mmap_windows(path, 0):
            out = _native.libsvm_parse(mm, offset=lo, length=hi - lo)
            if out is None:
                labels_l = []
                break           # malformed for the strict parser
            lab, qid, indptr, idx, vals, mf = out
            labels_l.append(lab)
            qids_l.append(qid)
            trip.append((np.diff(indptr), idx, vals))
            max_idx = max(max_idx, mf)
    if labels_l:
        counts = np.concatenate([t[0] for t in trip])
        return (np.concatenate(labels_l), np.concatenate(qids_l),
                np.concatenate([[0], np.cumsum(counts)]).astype(np.int64),
                np.concatenate([t[1] for t in trip]),
                np.concatenate([t[2] for t in trip]), max_idx)
    labels, qids, indptr, idx, vals = [], [], [0], [], []
    with open(path) as fh:
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
                max_idx = max(max_idx, int(i))
            qids.append(q)
            indptr.append(len(idx))
    return (np.asarray(labels), np.asarray(qids, np.int64),
            np.asarray(indptr, np.int64), np.asarray(idx, np.int32),
            np.asarray(vals, np.float64), max_idx)


def _qid_group(qids: np.ndarray) -> Optional[np.ndarray]:
    """Query sizes from per-row ``qid:`` tokens, when every row has one."""
    has_q = qids >= 0
    if not len(qids) or not has_q.any():
        return None
    if not has_q.all():
        log.warning("LibSVM file has qid: on only %d of %d rows; ignoring "
                    "qids (provide a .query sidecar or annotate every row)",
                    int(has_q.sum()), len(qids))
        return None
    return _group_from_col(qids)


def _load_libsvm(path: str):
    """A LibSVM file -> (CSR X, label, weight, group, names) (reference
    package: text_loader.py ``_load_libsvm``): implicit entries are 0.0;
    ``qid:`` tokens become query sizes unless a ``.query`` sidecar gives
    them."""
    import scipy.sparse as sp
    label, qids, indptr, indices, values, max_idx = _parse_libsvm(path)
    X = sp.csr_matrix((values, indices, indptr),
                      shape=(len(label), max_idx + 1))
    weight, group = _load_sidecars(path, None, None)
    return (X, label, weight, group if group is not None else
            _qid_group(qids), [f"Column_{i}" for i in range(max_idx + 1)])


def load_init_scores(path: str, initscore_path: str = ""):
    """Init scores: ``initscore_filename``, else the ``<data>.init`` sidecar
    (reference: Metadata::LoadInitialScore; reference package: app.py
    ``_load_init_scores``); a file of N rows x K columns comes back class
    major ([K * N]).  None without either."""
    if initscore_path and not os.path.exists(initscore_path):
        log.fatal(f"Initial score file {initscore_path} does not exist")
    for cand in ([initscore_path] if initscore_path else []) + [
            path + ".init"]:
        if cand and os.path.exists(cand):
            arr = np.loadtxt(cand, dtype=np.float64)
            log.info("Loaded %d init scores from %s", arr.size, cand)
            return arr.T.ravel() if arr.ndim == 2 else arr.ravel()
    return None


def load_text(path: str, config):
    """Load a text data file -> (X, label, weight, group, feature_names):
    X dense f64, or a scipy CSR matrix for a LibSVM file; weight and group
    (query sizes) are None without a ``weight_column`` / ``group_column``,
    ``qid:`` tokens or a sidecar.  ``label_column`` counts every file
    column; the other columns are dropped from X."""
    if not os.path.exists(path):
        log.fatal(f"Data file {path} does not exist")
    with open(path) as fh:
        first = fh.readline()
    if _is_libsvm(first, config):
        return _load_libsvm(path)
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
    weight, group = _load_sidecars(path, weight, None)
    if group is None:
        group = _group_from_col(data[:, group_col] if group_col is not None
                                else None)
    return (data[:, keep], data[:, label_col], weight, group,
            [names[i] for i in keep])


def _categorical_indices(categorical_features, names: List[str]) -> List[int]:
    """Categorical specs (indices, or names of the kept columns) as
    sorted indices."""
    out = []
    for c in categorical_features or ():
        if isinstance(c, str):
            if c in names:
                out.append(names.index(c))
            else:
                log.warning("categorical_feature %r not found in feature "
                            "names; ignored", c)
        else:
            out.append(int(c))
    return sorted(set(out))


def load_text_two_round(path: str, config, categorical_features=(),
                        reference=None):
    """Build a ``BinnedDataset`` from a text file while streaming it, never
    holding its raw matrix (reference: config.h two_round,
    dataset_loader.cpp:807-827; reference package: text_loader.py
    ``load_text_two_round``) -> (handle, label, weight, group, names).
    With ``reference`` (a constructed ``BinnedDataset``) its bin space is
    reused and no sample is drawn.

    Dense files: pass 1 counts the rows, keeps the label / weight / group
    columns and reservoir-samples the byte ranges of
    ``bin_construct_sample_cnt`` lines (``np.random.default_rng(
    data_random_seed)``, chunk by chunk, as the JAX package draws them);
    the sampled lines are parsed once for the mappers; pass 2 bins each
    chunk into ``X_bin``.  LibSVM files: pass 1 counts the rows and keeps
    the labels and ``qid:`` tokens, pass 2 gathers the sample rows that
    ``from_csr`` would draw, pass 3 bins each window's stored entries;
    the dataset is the in-memory one's.  A file the strict native parser
    rejects loads in memory instead."""
    from .dataset import BinnedDataset
    if not os.path.exists(path):
        log.fatal(f"Data file {path} does not exist")
    with open(path) as fh:
        first = fh.readline()
    try:
        if _native.lib() is None:
            raise _ParseError("native library unavailable")
        if _is_libsvm(first, config):
            return _two_round_libsvm(path, config, categorical_features,
                                     reference)
        delim = _sniff_delimiter(first.rstrip("\n"))
        names: List[str] = []
        skip = 0
        if config.header:
            names = [t.strip() for t in first.rstrip("\n").split(delim)]
            skip = 1
        return _two_round_dense(path, config, categorical_features,
                                reference, names, skip, delim)
    except _ParseError as exc:
        log.warning("two_round streaming unavailable (%s); loading in "
                    "memory", exc)
    X, label, weight, group, names = load_text(path, config)
    build = (BinnedDataset.from_csr if hasattr(X, "tocsr")
             else BinnedDataset.from_matrix)
    handle = build(X, config, categorical_features=_categorical_indices(
        categorical_features, names), feature_names=names,
        reference=reference)
    return handle, label, weight, group, names


def _two_round_dense(path, config, categorical_features, reference, names,
                     skip, delim):
    from .dataset import BinnedDataset
    sample_cnt = int(config.bin_construct_sample_cnt)
    rng = np.random.default_rng(config.data_random_seed)
    plan = None
    n_rows = 0
    res_off = res_len = None        # the sampled lines' byte ranges
    sides = []
    for mm, lo, hi in _mmap_windows(path, skip):
        if plan is None:
            ncol = _file_ncol(mm, lo, len(mm), delim)
            plan = _column_plan(names, ncol, config)
            names, label_col, weight_col, group_col, keep = plan
            side_cols = [c for c in (label_col, weight_col, group_col)
                         if c is not None]
        arr = _native.csv_parse(mm, delim, ncol, offset=lo, length=hi - lo)
        if arr is None:
            raise _ParseError("malformed row (inconsistent columns?)")
        sides.append(arr[:, side_cols].copy())
        if reference is None:
            offs = _native.csv_line_offsets(mm, offset=lo, length=hi - lo)
            offs = offs[:len(arr)]          # a trailing blank line
            lens = np.diff(np.append(offs, hi - lo)).astype(np.int64)
            offs = offs + lo
            if res_off is None:
                res_off = np.empty(sample_cnt, np.int64)
                res_len = np.empty(sample_cnt, np.int64)
            filled = min(n_rows, sample_cnt)
            take = min(max(sample_cnt - filled, 0), len(offs))
            if take:
                res_off[filled:filled + take] = offs[:take]
                res_len[filled:filled + take] = lens[:take]
            if take < len(offs):
                # Algorithm R, vectorized a chunk: the row of global index
                # g replaces a random slot with probability cnt / (g + 1)
                gi = np.arange(n_rows + take, n_rows + len(offs))
                slots = rng.integers(0, gi + 1)
                hit = slots < sample_cnt
                res_off[slots[hit]] = offs[take:][hit]
                res_len[slots[hit]] = lens[take:][hit]
        n_rows += len(arr)
    if n_rows == 0:
        log.fatal(f"Data file {path} is empty")
    side = np.concatenate(sides)
    label = side[:, 0]
    weight = side[:, 1] if weight_col is not None else None
    group_raw = side[:, -1] if group_col is not None else None
    feat_names = [names[i] for i in keep]
    if reference is None:
        m = min(n_rows, sample_cnt)
        with open(path, "rb") as fh:
            mm = mmap.mmap(fh.fileno(), 0, access=mmap.ACCESS_READ)
            try:
                pieces = []
                for o, ln in zip(res_off[:m], res_len[:m]):
                    b = bytes(mm[int(o):int(o + ln)])
                    pieces.append(b if b.endswith(b"\n") else b + b"\n")
            finally:
                mm.close()
        sample = _native.csv_parse(b"".join(pieces), delim, len(names))
        if sample is None:
            raise _ParseError("malformed sampled row")
        handle = BinnedDataset.from_sample(
            sample[:, keep], n_rows, config,
            _categorical_indices(categorical_features, feat_names),
            feat_names)
    else:
        handle = BinnedDataset._like(reference, n_rows, len(keep))
    handle._alloc_X()
    row0 = 0
    for chunk in _iter_dense_chunks(path, delim, skip):
        handle._binarize(chunk[:, keep], row0)
        row0 += len(chunk)
    log.check(row0 == n_rows, "data file changed between two_round passes")
    weight, group = _load_sidecars(path, weight, None)
    if group is None:
        group = _group_from_col(group_raw)
    return handle, label, weight, group, feat_names


def _libsvm_windows(path: str):
    """(labels, qids, CSR triplets, largest index) of each mmap window."""
    for mm, lo, hi in _mmap_windows(path, 0):
        out = _native.libsvm_parse(mm, offset=lo, length=hi - lo)
        if out is None:
            raise _ParseError("malformed LibSVM line")
        yield out


def _two_round_libsvm(path, config, categorical_features, reference):
    import scipy.sparse as sp

    from ..utils.random import Random
    from .dataset import BinnedDataset
    labels, qids, max_idx = [], [], -1
    for lab, qid, _, _, _, mf in _libsvm_windows(path):
        labels.append(lab)
        qids.append(qid)
        max_idx = max(max_idx, mf)
    label, qids = np.concatenate(labels), np.concatenate(qids)
    n, p = len(label), max_idx + 1
    names = [f"Column_{i}" for i in range(p)]
    if reference is None:
        cnt = min(int(config.bin_construct_sample_cnt), n)
        pick = (np.arange(n, dtype=np.int64) if cnt >= n
                else Random(config.data_random_seed).sample(n, cnt).astype(
                    np.int64))
        parts, row0 = [], 0
        for _, _, indptr, idx, vals, _ in _libsvm_windows(path):
            rows = len(indptr) - 1
            sel = pick[(pick >= row0) & (pick < row0 + rows)] - row0
            if len(sel):
                parts.append(sp.csr_matrix((vals, idx, indptr),
                                           shape=(rows, p))[sel])
            row0 += rows
        handle = BinnedDataset.from_sample(
            sp.vstack(parts, format="csr"), n, config,
            _categorical_indices(categorical_features, names), names)
    else:
        handle = BinnedDataset._like(reference, n, p)
    handle._alloc_X()
    row0 = 0
    for _, _, indptr, idx, vals, _ in _libsvm_windows(path):
        rows = len(indptr) - 1
        handle._binarize_csc(sp.csr_matrix((vals, idx, indptr),
                                           shape=(rows, p)).tocsc(), row0)
        row0 += rows
    log.check(row0 == n, "data file changed between two_round passes")
    weight, group = _load_sidecars(path, None, None)
    return handle, label, weight, (group if group is not None
                                   else _qid_group(qids)), names
