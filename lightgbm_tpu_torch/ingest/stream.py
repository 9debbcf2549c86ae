"""Two-pass streaming construction of a ``BinnedDataset`` (counterpart of
lightgbm_tpu/ingest/stream.py): bounded host memory, no raw [N, F]
matrix, shard-aware.

The reference splits the work the same way (reference:
dataset_loader.cpp:574,807-827): sample, find bins, then stream the rows
through the ``BinMapper``s.  Here:

- pass 1, one guarded walk of the chunk source: count the rows, feed the
  seeded reservoir (``ingest/sample.py``, ``bin_construct_sample_cnt``
  rows) and keep the streamed label / weight / query columns;
- bin finding: ``BinnedDataset.from_sample`` on the reservoir;
- pass 2, a second guarded walk: each chunk is binned by
  ``BinnedDataset._binarize`` (``_binarize_csc`` for sparse chunks) into
  a preallocated bin matrix, in RAM or ``np.memmap``-backed
  (``_alloc_X(path)``); a shard bins only its rows of the
  :class:`~.shard.RowShardPlan`.

Peak host memory is O(chunk + sample + bin matrix).  Given the same
sample, the streamed dataset (bins, mappers, metadata) and the trees
trained from it are byte-equal to ``from_matrix`` / ``from_csr``'s and
to the JAX package's ingested dataset (``tests/test_torch_ingest.py``).

Every chunk fetch passes the ``ingest_chunk`` fault point under a
``robust/watchdog.DeviceGuard``: a transient read fault retries, a fatal
one aborts, and with ``tpu_wedge_timeout_s`` a stalled read is stamped
(``device_stall`` event and a flight dump).  A chunk whose geometry
disagrees with the stream raises :class:`IngestError`.
"""
from __future__ import annotations

import hashlib
import json
import os
import time
from typing import List, Optional, Sequence

import numpy as np

from ..config import Config
from ..utils import log
from .readers import open_source
from .sample import ReservoirSampler, sample_seed
from .shard import local_query_sizes, plan_row_shards, resolve_shard

_DONE = object()


class IngestError(RuntimeError):
    """Corrupt or inconsistent stream input: ingestion aborts rather than
    bin garbage."""


def chunk_rows_from_config(config) -> int:
    """``tpu_ingest_chunk_rows``, overridden by
    ``LGBM_TPU_INGEST_CHUNK_ROWS``."""
    env = os.environ.get("LGBM_TPU_INGEST_CHUNK_ROWS", "")
    if env:
        try:
            return max(int(env), 1)
        except ValueError:
            log.warning("ignoring malformed LGBM_TPU_INGEST_CHUNK_ROWS=%r",
                        env)
    return max(int(getattr(config, "tpu_ingest_chunk_rows", 65536)), 1)


def memmap_from_config(config) -> str:
    """``tpu_ingest_memmap``, overridden by ``LGBM_TPU_INGEST_MEMMAP``."""
    env = os.environ.get("LGBM_TPU_INGEST_MEMMAP", "")
    return env or str(getattr(config, "tpu_ingest_memmap", "") or "")


def _memmap_file(base: str, shard_id: int, num_shards: int) -> str:
    """The memmap file: a directory (or a trailing separator) gets a
    per-shard file inside it; a file path gains a shard suffix when
    sharding.  An existing file is never reused (``open_memmap(mode=
    'w+')`` would truncate what a live dataset still maps): the name
    walks to the first free ``.k`` suffix."""
    if os.path.isdir(base) or base.endswith(os.sep):
        os.makedirs(base, exist_ok=True)
        path = os.path.join(base, f"X_bin.shard{shard_id}.npy")
    elif num_shards > 1:
        root, ext = os.path.splitext(base)
        path = f"{root}.shard{shard_id}{ext or '.npy'}"
    else:
        path = base
    if os.path.exists(path):
        root, ext = os.path.splitext(path)
        k = 1
        while os.path.exists(f"{root}.{k}{ext}"):
            k += 1
        log.warning("ingest: memmap target %s already exists (another "
                    "dataset may still map it); writing %s.%d%s instead",
                    path, root, k, ext)
        path = f"{root}.{k}{ext}"
    return path


def _guard(config):
    from ..robust.watchdog import DeviceGuard
    timeout = float(getattr(config, "tpu_wedge_timeout_s", 0.0) or 0.0)
    return DeviceGuard(
        policy="retry",
        retries=int(getattr(config, "tpu_device_retries", 3)),
        stall_timeout_s=timeout if timeout > 0 else -1.0,
        enabled=bool(getattr(config, "tpu_watchdog", False)),
        name="ingest")


def _iter_guarded(source, guard, pass_no: int):
    """``(chunk_index, stream_row0, X, side)`` of every chunk, each fetch
    through the guard at the ``ingest_chunk`` point and validated."""
    from .. import obs
    it = iter(source)

    def _next():
        try:
            return next(it)
        except StopIteration:
            return _DONE

    ci = 0
    row0 = 0
    cols = None
    while True:
        out = guard.run(_next, point="ingest_chunk")
        if out is _DONE:
            break
        try:
            X, side = out
        except (TypeError, ValueError):
            raise IngestError(
                f"ingest pass {pass_no}: chunk {ci} is not an "
                f"(X, side) pair (got {type(out).__name__})")
        if getattr(X, "ndim", 2) != 2:
            raise IngestError(
                f"ingest pass {pass_no}: chunk {ci} is not 2-D "
                f"(shape {getattr(X, 'shape', None)})")
        if not hasattr(X, "tocsr"):
            if cols is None:
                cols = int(X.shape[1])
            elif int(X.shape[1]) != cols:
                raise IngestError(
                    f"ingest pass {pass_no}: chunk {ci} has "
                    f"{int(X.shape[1])} columns, stream started with "
                    f"{cols}: corrupt chunk, aborting")
        m = int(X.shape[0])
        for name, arr in (side or {}).items():
            if arr is not None and len(arr) != m:
                raise IngestError(
                    f"ingest pass {pass_no}: chunk {ci} side column "
                    f"{name!r} has {len(arr)} rows for {m} data rows")
        if obs.enabled():
            obs.event("ingest_chunk", **{"pass": int(pass_no)},
                      chunk=ci, rows=m, stream_row0=row0)
        yield ci, row0, X, side or {}
        ci += 1
        row0 += m


def dataset_digest(ds) -> str:
    """Content digest of a constructed dataset: the bin matrix (hashed in
    row blocks: it may be a memmap larger than RAM), the mappers, the
    offsets and the labels, weights and query boundaries.  Two re-streams
    of one source give one digest (the JAX package's function: equal
    datasets of the two packages give equal digests)."""
    h = hashlib.sha256()
    X = ds.X_bin
    if X is not None:
        h.update(str(X.dtype).encode())
        h.update(np.asarray(X.shape, np.int64).tobytes())
        step = max((1 << 24) // max(int(X.shape[1]), 1), 1)
        for lo in range(0, int(X.shape[0]), step):
            h.update(np.ascontiguousarray(X[lo:lo + step]).tobytes())
    h.update(json.dumps([m.to_dict() for m in ds.bin_mappers],
                        sort_keys=True).encode())
    if ds.bin_offsets is not None:
        h.update(np.asarray(ds.bin_offsets, np.int64).tobytes())
    md = ds.metadata
    for arr in (md.label, md.weights, md.query_boundaries):
        if arr is not None:
            h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()[:16]


def ingest_dataset(source, config=None, *, categorical_features: Sequence = (),
                   feature_names: Optional[List[str]] = None,
                   reference=None, num_shards: Optional[int] = None,
                   shard_id: Optional[int] = None,
                   memmap_path: Optional[str] = None,
                   group=None, weight=None, seed: Optional[int] = None):
    """A ``BinnedDataset`` from a chunked ``source``, without the raw
    matrix.  Returns this shard's dataset (the whole stream unsharded);
    ``ds.ingest_row_range`` is the global ``[lo, hi)`` it holds and
    ``ds.ingest_num_rows`` the stream's rows, so callers can cut other
    whole-stream arrays (init scores) to the shard.

    ``reference``: a constructed ``BinnedDataset`` whose bin space is
    reused (a validation set; no sample is drawn).  ``num_shards`` /
    ``shard_id`` default to ``resolve_shard(config)``; ``memmap_path``
    (default ``memmap_from_config``) backs the bin matrix with an
    ``np.memmap`` file.  ``group`` (query sizes) and ``weight`` override
    the stream's, whole-stream length, cut to the shard here."""
    from .. import obs
    from ..io.dataset import BinnedDataset, Metadata
    from ..io.text_loader import _categorical_indices, _qid_group
    from ..obs.drift import accumulate_occupancy, init_occupancy
    from ..utils.timetag import timetag

    config = config if config is not None else Config()
    t_start = time.perf_counter()
    guard = _guard(config)
    if num_shards is None or shard_id is None:
        d_cfg, s_cfg = resolve_shard(config)
        num_shards = d_cfg if num_shards is None else int(num_shards)
        shard_id = s_cfg if shard_id is None else int(shard_id)
    num_shards = max(int(num_shards), 1)
    shard_id = int(shard_id)
    log.check(0 <= shard_id < num_shards,
              f"shard_id {shard_id} out of range for {num_shards} shards")
    if memmap_path is None:
        memmap_path = memmap_from_config(config) or None

    # ---- pass 1: count, sample, side columns ------------------------------
    sampler = None
    if reference is None:
        sampler = ReservoirSampler(
            int(getattr(config, "bin_construct_sample_cnt", 200000)),
            seed=sample_seed(config) if seed is None else int(seed))
    n_rows = 0
    chunks_seen = 0
    labels, weights, qids = [], [], []
    with timetag("ingest pass1"):
        for ci, _, X, side in _iter_guarded(source, guard, 1):
            if sampler is not None:
                sampler.add(X)
            if side.get("label") is not None:
                labels.append(np.asarray(side["label"], np.float64))
            if side.get("weight") is not None:
                weights.append(np.asarray(side["weight"], np.float64))
            if side.get("qid") is not None:
                qids.append(np.asarray(side["qid"], np.int64))
            n_rows += int(X.shape[0])
            chunks_seen = ci + 1
    if n_rows == 0:
        raise IngestError("ingest: the source yielded no rows")

    label = np.concatenate(labels) if labels else None
    # a weight column in the stream wins over a sidecar's; an explicit
    # query override (a sidecar) wins over the stream's qids
    if weights:
        weight = np.concatenate(weights)
    elif weight is not None:
        weight = np.asarray(weight, np.float64).ravel()
    if label is not None and len(label) != n_rows:
        raise IngestError(f"ingest: stream carried {len(label)} labels "
                          f"for {n_rows} rows")
    if weight is not None and len(weight) != n_rows:
        raise IngestError(f"ingest: {len(weight)} weights for {n_rows} "
                          "rows")
    if group is None:
        group = getattr(source, "group_sizes", None)
    if group is None and qids:
        group = _qid_group(np.concatenate(qids))
    group = None if group is None else np.asarray(group).ravel()
    if group is not None and int(group.sum()) != n_rows:
        raise IngestError(f"ingest: query sizes sum to {int(group.sum())} "
                          f"for {n_rows} rows")
    boundaries = (np.concatenate([[0], np.cumsum(group)]).astype(np.int64)
                  if group is not None else None)

    # a sparse stream's width is known after pass 1 (LibSVM's max index)
    n_cols = getattr(source, "n_features", None)
    if feature_names is None:
        feature_names = getattr(source, "feature_names", None)

    # ---- shard plan -------------------------------------------------------
    plan = (plan_row_shards(n_rows, num_shards, boundaries)
            if num_shards > 1 else None)
    lo, hi = plan.shard_range(shard_id) if plan is not None else (0, n_rows)
    local_n = hi - lo

    # ---- bin mappers ------------------------------------------------------
    sample_rows = 0
    if reference is not None:
        if n_cols is not None:
            log.check(int(n_cols) <= reference.num_total_features,
                      "ingest stream has more features than the "
                      "reference dataset")
        n_cols = reference.num_total_features
        ds = BinnedDataset._like(reference, local_n, n_cols)
    else:
        sample, _ = sampler.finish()
        sample_rows = int(sample.shape[0])
        if n_cols is None:
            n_cols = int(sample.shape[1])
        if hasattr(sample, "tocsr") and int(sample.shape[1]) < n_cols:
            import scipy.sparse as sp
            s = sample.tocsr()
            sample = sp.csr_matrix((s.data, s.indices, s.indptr),
                                   shape=(s.shape[0], n_cols))
        # mappers and bundles of the whole stream; this process fills
        # only its shard's rows
        ds = BinnedDataset.from_sample(
            sample, n_rows, config,
            _categorical_indices(categorical_features, feature_names or []),
            feature_names)
        ds.num_data = local_n
        ds.metadata = Metadata(local_n)

    # ---- the bin matrix (RAM or memmap) ------------------------------------
    memmap_file = (_memmap_file(memmap_path, shard_id, num_shards)
                   if memmap_path else None)
    ds._alloc_X(memmap_file)

    # ---- pass 2: bin chunk by chunk into [lo, hi) ---------------------------
    # the quality profile's bin occupancy (obs/drift.py) folds each binned
    # slice in as it lands: no extra scan of a memmap-backed matrix
    occupancy = init_occupancy(ds)
    with timetag("binarize"):
        seen = 0
        filled = 0
        for ci, row0, X, _ in _iter_guarded(source, guard, 2):
            m = int(X.shape[0])
            s = max(lo - row0, 0)
            e = min(hi - row0, m)
            if s < e:
                sub = X[s:e]
                if hasattr(sub, "tocsr"):
                    csr = sub.tocsr()
                    if csr.shape[1] < n_cols:
                        import scipy.sparse as sp
                        csr = sp.csr_matrix(
                            (csr.data, csr.indices, csr.indptr),
                            shape=(csr.shape[0], n_cols))
                    ds._binarize_csc(csr.tocsc(), filled)
                else:
                    sub = np.asarray(sub, np.float64)
                    if sub.shape[1] != n_cols:
                        raise IngestError(
                            f"ingest pass 2: chunk {ci} width "
                            f"{sub.shape[1]} != stream width {n_cols}")
                    ds._binarize(sub, filled)
                accumulate_occupancy(ds, occupancy, filled, e - s)
                filled += e - s
            seen += m
    ds.quality_occupancy = occupancy
    if seen != n_rows:
        raise IngestError(
            f"ingest: stream changed between passes ({seen} rows on "
            f"pass 2, {n_rows} on pass 1)")
    if filled != local_n:
        raise IngestError(f"ingest: shard {shard_id} binned {filled} rows, "
                          f"plan expected {local_n}")
    if memmap_file:
        ds.X_bin.flush()

    # ---- metadata ---------------------------------------------------------
    if label is not None:
        ds.metadata.set_label(label[lo:hi])
    if weight is not None:
        ds.metadata.set_weights(weight[lo:hi])
    if group is not None:
        sizes = (local_query_sizes(plan, shard_id, boundaries)
                 if plan is not None else group)
        if sizes is not None and len(sizes):
            ds.metadata.set_query(sizes)
    ds.ingest_row_range = (int(lo), int(hi))
    ds.ingest_num_rows = int(n_rows)

    # ---- telemetry ---------------------------------------------------------
    wall = time.perf_counter() - t_start
    fields = dict(rows=int(n_rows), local_rows=int(local_n),
                  chunks=int(chunks_seen), sample_rows=int(sample_rows),
                  shards=int(num_shards), shard_id=int(shard_id),
                  memmap=bool(memmap_file), wall_s=round(wall, 4),
                  rows_per_s=round(n_rows / wall, 1) if wall > 0 else 0.0,
                  source=str(getattr(source, "kind",
                                     type(source).__name__)))
    if obs.enabled() or obs.flight_enabled():
        fields["digest"] = dataset_digest(ds)
    obs.event("ingest_summary", **fields)
    log.info("ingest: %d rows (%d local, shard %d/%d) through %d "
             "chunk(s), %d-row sample, %.2fs (%s rows/s)%s",
             n_rows, local_n, shard_id, num_shards, chunks_seen,
             sample_rows, wall, f"{fields['rows_per_s']:,.0f}",
             f", memmap {memmap_file}" if memmap_file else "")
    return ds


def ingest_file(path: str, config, categorical_features: Sequence = (),
                reference=None, **kw):
    """A data file (CSV/TSV through the native parser, LibSVM,
    ``.npy``/``.npz``) streamed through :func:`ingest_dataset`; returns
    ``(handle, label, weight, group, feature_names)``, the contract of
    ``io/text_loader.load_text_two_round``, with the side arrays this
    shard's.  The ``<data>.weight`` / ``.query`` sidecars are read first,
    so the shard plan can cut on a sidecar's query boundaries."""
    from ..io.text_loader import _load_sidecars

    sc_weight, sc_group = _load_sidecars(path, None, None)
    src = open_source(path, config, chunk_rows=chunk_rows_from_config(config))
    ds = ingest_dataset(src, config, categorical_features=categorical_features,
                        reference=reference, weight=sc_weight,
                        group=sc_group, **kw)
    md = ds.metadata
    group = (np.diff(md.query_boundaries)
             if md.query_boundaries is not None else None)
    return ds, md.label, md.weights, group, list(ds.feature_names)


def dataset_from_stream(source, params=None, *,
                        categorical_features: Sequence = (),
                        feature_names=None, **kw):
    """``source`` streamed into a constructed ``lightgbm_tpu_torch.
    Dataset`` for ``train``, the stream's labels, weights and queries in
    its metadata."""
    from ..basic import Dataset

    params = dict(params or {})
    handle = ingest_dataset(source, Config.from_params(params),
                            categorical_features=categorical_features,
                            feature_names=feature_names, **kw)
    ds = Dataset(None, params=params,
                 feature_name=list(handle.feature_names))
    ds._handle = handle
    return ds
