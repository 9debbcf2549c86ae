"""Single-pass reservoir sampling for out-of-core bin finding
(counterpart of lightgbm_tpu/ingest/sample.py; the same draw, bit for
bit, from the same seed).

The reference samples ``bin_construct_sample_cnt`` rows before it builds
the dataset, and draws them from the whole file (reference:
dataset_loader.cpp:574 ConstructFromSampleData, SampleFromFile).  A
stream must keep that property: the first ``sample_cnt`` rows would bias
the bin bounds toward the head of a stream whose distribution drifts.
:class:`ReservoirSampler` is Algorithm R, vectorised a chunk, over dense
chunks or scipy-sparse row blocks: the row of global index ``g`` replaces
a uniform slot of [0, g] and survives when that slot is below ``k``.  The
bounded-integer draws consume ``np.random.default_rng(seed)`` row by row,
so the sample does not depend on the chunking; numpy's fancy assignment
keeps the last write to a slot, as the sequential algorithm does.

Pre-sharded ranks (each streams only its rows) pool their local samples
in rank order before bin finding; :func:`merge_shard_samples` is that
pooling on the host, the oracle of ``parallel/distributed.py
global_bin_sample``.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np


class ReservoirSampler:
    """A uniform ``sample_cnt``-row reservoir over a chunked row stream.

    ``add`` one chunk at a time (a 2-D ndarray or scipy-sparse rows, all
    of one kind); ``finish`` returns the sampled rows (dense [m, F] f64,
    or CSR for a sparse stream) and their global stream indices in slot
    order."""

    def __init__(self, sample_cnt: int, seed: int = 1):
        self.k = int(sample_cnt)
        if self.k < 1:
            raise ValueError("sample_cnt must be >= 1")
        self._rng = np.random.default_rng(int(seed))
        self.n = 0                       # stream rows seen so far
        self._dense: Optional[np.ndarray] = None     # [k, F] f64
        self._sparse_parts: List[Tuple[np.ndarray, object]] = []
        self._sparse_cols = 0
        self._sparse = None              # None until the first chunk
        self.indices = np.full(self.k, -1, dtype=np.int64)

    def _slots_for(self, m: int) -> Tuple[np.ndarray, np.ndarray]:
        """(slots, local rows) this chunk's ``m`` rows write: the fill
        phase takes rows as they come, then one draw a row in global row
        order, so chunk boundaries cannot change the schedule."""
        filled = min(self.n, self.k)
        take = min(self.k - filled, m) if filled < self.k else 0
        slots = [np.arange(filled, filled + take, dtype=np.int64)]
        local = [np.arange(take, dtype=np.int64)]
        if take < m:
            gi = np.arange(self.n + take, self.n + m, dtype=np.int64)
            draws = self._rng.integers(0, gi + 1)
            hit = draws < self.k
            slots.append(draws[hit])
            local.append(np.arange(take, m, dtype=np.int64)[hit])
        return np.concatenate(slots), np.concatenate(local)

    def add(self, chunk) -> None:
        sparse = hasattr(chunk, "tocsr")
        if self._sparse is None:
            self._sparse = sparse
        elif self._sparse != sparse:
            raise ValueError("reservoir stream mixed dense and sparse "
                             "chunks")
        m = int(chunk.shape[0])
        if m == 0:
            return
        slots, local = self._slots_for(m)
        if len(slots):
            if sparse:
                self._sparse_parts.append((slots, chunk.tocsr()[local]))
                self._sparse_cols = max(self._sparse_cols,
                                        int(chunk.shape[1]))
                self._maybe_compact()
            else:
                arr = np.asarray(chunk, dtype=np.float64)
                if self._dense is None:
                    self._dense = np.empty((self.k, arr.shape[1]),
                                           np.float64)
                elif arr.shape[1] != self._dense.shape[1]:
                    raise ValueError(
                        f"chunk has {arr.shape[1]} columns, stream "
                        f"started with {self._dense.shape[1]}")
                self._dense[slots] = arr[local]
            self.indices[slots] = self.n + local
        self.n += m

    def _live_sparse(self):
        """slot -> (part, row in part) of the last write to each slot."""
        live = {}
        for pi, (slots, _) in enumerate(self._sparse_parts):
            for r, s in enumerate(slots):
                live[int(s)] = (pi, r)
        return live

    def _maybe_compact(self) -> None:
        """Past ~4x the reservoir's rows of stored blocks, rewrite them
        down to the live rows: memory stays O(sample) on any stream."""
        stored = sum(p[1].shape[0] for p in self._sparse_parts)
        if stored <= max(4 * self.k, self.k + 64):
            return
        sample = self._assemble_sparse()
        live_slots = np.asarray(sorted(self._live_sparse()), np.int64)
        self._sparse_parts = [(live_slots, sample)]

    def _assemble_sparse(self):
        import scipy.sparse as sp

        order = sorted(self._live_sparse().items())          # by slot
        if not order:
            return sp.csr_matrix((0, self._sparse_cols))
        by_part = {}
        for pos, (_, (pi, r)) in enumerate(order):
            by_part.setdefault(pi, []).append((pos, r))
        pos_parts, row_parts = [], []
        for pi, lst in by_part.items():
            blk = self._sparse_parts[pi][1][[r for _, r in lst]]
            row_parts.append(sp.csr_matrix(
                (blk.data, blk.indices, blk.indptr),
                shape=(blk.shape[0], self._sparse_cols)))
            pos_parts.append(np.asarray([p for p, _ in lst], np.int64))
        stacked = sp.vstack(row_parts, format="csr")
        return stacked[np.argsort(np.concatenate(pos_parts),
                                  kind="stable")]

    def finish(self) -> Tuple[object, np.ndarray]:
        """``(sample_rows, global_indices)`` in slot order; a stream
        shorter than the reservoir gives every row."""
        m = min(self.n, self.k)
        if self._sparse:
            sample = self._assemble_sparse()[:m]
        elif self._dense is not None:
            sample = self._dense[:m]
        else:
            sample = np.empty((0, 0), np.float64)
        return sample, self.indices[:m].copy()


def merge_shard_samples(samples, shard_rows) -> Tuple[object, int]:
    """The rank-ordered concatenation of the shards' samples and their
    summed row count: what ``global_bin_sample`` gives every rank over
    the collectives."""
    mats = list(samples)
    if not mats:
        return np.empty((0, 0), np.float64), 0
    if hasattr(mats[0], "tocsr"):
        import scipy.sparse as sp
        pooled = sp.vstack([m.tocsr() for m in mats], format="csc")
    else:
        pooled = np.concatenate([np.asarray(m, np.float64) for m in mats])
    return pooled, int(sum(int(r) for r in shard_rows))


def sample_seed(config) -> int:
    """The reservoir's seed: ``tpu_ingest_sample_seed`` when set (>= 0),
    else ``data_random_seed``, the in-memory sampler's knob."""
    s = int(getattr(config, "tpu_ingest_sample_seed", -1))
    if s >= 0:
        return s
    return int(getattr(config, "data_random_seed", 1))
