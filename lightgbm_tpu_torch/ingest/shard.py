"""Row-shard plans (counterpart of lightgbm_tpu/ingest/shard.py).

A :class:`RowShardPlan` is the geometry both ingestion passes agree on:
contiguous ``[cuts[d], cuts[d + 1])`` row ranges, near-equal by rows, and
for ranking data cut on query boundaries by
``parallel/rank_shard.plan_query_shards``'s balanced partition (the
reference's data-parallel learner never splits a query across workers).
A shard's identity comes from ``tpu_ingest_shards`` /
``tpu_ingest_shard_id``, else from the process rank that
``parallel/distributed.py`` recorded.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np

from ..utils import log


@dataclass
class RowShardPlan:
    """Contiguous row ranges per shard; ``query_cuts`` is set when the
    cuts lie on query boundaries."""
    num_shards: int
    n_rows: int
    cuts: np.ndarray                       # int64 [num_shards + 1]
    query_cuts: Optional[np.ndarray] = field(default=None)

    def shard_range(self, shard_id: int) -> Tuple[int, int]:
        return int(self.cuts[shard_id]), int(self.cuts[shard_id + 1])

    def local_rows(self, shard_id: int) -> int:
        lo, hi = self.shard_range(shard_id)
        return hi - lo

    @property
    def query_aligned(self) -> bool:
        return self.query_cuts is not None

    def replan(self, num_shards: int,
               query_boundaries=None) -> "RowShardPlan":
        """The same rows cut for another world size (the elastic fleet's
        shrink or heal).  Alignment comes from ``query_boundaries``,
        passed again, never from the old cuts."""
        return plan_row_shards(self.n_rows, num_shards, query_boundaries)


def plan_row_shards(n_rows: int, num_shards: int,
                    query_boundaries=None) -> RowShardPlan:
    """Near-equal contiguous cuts over ``num_shards``; with
    ``query_boundaries`` (int [Q + 1], last == n_rows) every cut lies on
    a query boundary."""
    D = max(int(num_shards), 1)
    n = int(n_rows)
    if query_boundaries is None:
        cuts = (np.arange(D + 1, dtype=np.int64) * n) // D
        return RowShardPlan(D, n, cuts)
    from ..parallel.rank_shard import plan_query_shards
    b = np.asarray(query_boundaries, dtype=np.int64)
    log.check(int(b[-1]) == n,
              "query boundaries do not cover the row stream "
              f"({int(b[-1])} != {n})")
    qp = plan_query_shards(b, D)
    cuts = np.asarray(qp.row_cuts, dtype=np.int64)
    if (np.diff(cuts) == 0).any():
        log.warning("row-shard plan: %d of %d shards got zero rows "
                    "(fewer queries than shards?)",
                    int((np.diff(cuts) == 0).sum()), D)
    return RowShardPlan(D, n, cuts,
                        query_cuts=np.asarray(qp.query_cuts, np.int64))


def local_query_sizes(plan: RowShardPlan, shard_id: int,
                      query_boundaries) -> Optional[np.ndarray]:
    """Sizes of the queries inside ``shard_id`` (an aligned plan has no
    query across two shards); None for a plan that is not aligned."""
    if plan.query_cuts is None:
        return None
    b = np.asarray(query_boundaries, dtype=np.int64)
    q0, q1 = int(plan.query_cuts[shard_id]), int(plan.query_cuts[shard_id + 1])
    return np.diff(b[q0:q1 + 1]).astype(np.int64)


def resolve_shard(config) -> Tuple[int, int]:
    """``(num_shards, shard_id)`` of this process: the explicit knobs,
    an unset id taking the recorded process rank
    (``parallel/mesh.NETWORK``); no sharding below two shards."""
    D = int(getattr(config, "tpu_ingest_shards", 0) or 0)
    if D <= 1:
        return 1, 0
    sid = int(getattr(config, "tpu_ingest_shard_id", -1))
    if sid < 0:
        from ..parallel.mesh import NETWORK
        sid = int(NETWORK.get("rank") or 0)
    log.check(0 <= sid < D,
              f"tpu_ingest_shard_id {sid} out of range for {D} shards")
    return D, sid
