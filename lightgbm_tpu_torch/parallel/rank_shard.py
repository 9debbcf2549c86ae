"""Query-aligned shards of the lambdarank pair pass under the
data-parallel learner (counterpart of lightgbm_tpu/parallel/rank_shard.py).

The row blocks of ``parallel/mesh.py`` know nothing of queries, so a
query may straddle two ranks.  The pair pass is per query (O(P^2) pairs
of a query's documents), so it is split on QUERY boundaries instead (the
reference keeps the boundaries in ``Metadata`` for this; its
data-parallel learner never cuts a query):

- ``plan_query_shards``: a greedy balanced cut of the query list into D
  contiguous shards, each cut at the query boundary nearest d*N/D rows,
  every shard padded to the largest's ``S`` rows, and the map of padded
  position -> row (sentinel N for padding);
- ``build_shard_blocks``: each shard's padded query buckets
  (``core/query.py``) with shard-local row indices;
- ``ShardedRankGrads``: each rank runs the pair pass on its own whole
  queries and local scores, and the g/h of the shards are all-gathered
  into the [N] vectors every rank then grows on.  Every row's lambdas
  are sums over its own query, so the result equals the single-process
  pass bit for bit.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..core.query import build_query_blocks
from ..utils import log
from .mesh import _all_gather


class QueryShardPlan:
    """Static shard geometry: query cuts, row cuts, the padded shard rows
    ``S``, and the [D*S] padded-position -> row map."""
    __slots__ = ("D", "S", "n_rows", "query_cuts", "row_cuts", "gather")

    def __init__(self, D, S, n_rows, query_cuts, row_cuts, gather):
        self.D = int(D)
        self.S = int(S)
        self.n_rows = int(n_rows)
        self.query_cuts = query_cuts
        self.row_cuts = row_cuts
        self.gather = gather


def plan_query_shards(query_boundaries, D: int) -> QueryShardPlan:
    """Greedy balanced partition of the contiguous queries over ``D``
    shards: cut ``d`` lands on the query boundary nearest ``d*N/D`` rows,
    monotone in ``d``, so no query straddles two shards."""
    b = np.asarray(query_boundaries, dtype=np.int64)
    nq = len(b) - 1
    N = int(b[-1])
    cuts = np.zeros(D + 1, dtype=np.int64)
    cuts[D] = nq
    for d in range(1, D):
        target = (d * N) // D
        j = int(np.searchsorted(b, target))
        if j > 0 and (j > nq or abs(int(b[j - 1]) - target)
                      <= abs(int(b[min(j, nq)]) - target)):
            j -= 1
        cuts[d] = min(max(j, int(cuts[d - 1])), nq)
    row_cuts = b[cuts]
    S = int(max((row_cuts[1:] - row_cuts[:-1]).max(initial=1), 1))
    gather = np.full(D * S, N, dtype=np.int64)
    for d in range(D):
        lo, hi = int(row_cuts[d]), int(row_cuts[d + 1])
        gather[d * S:d * S + (hi - lo)] = np.arange(lo, hi, dtype=np.int64)
    return QueryShardPlan(D, S, N, cuts, row_cuts, gather)


def build_shard_blocks(plan: QueryShardPlan, query_boundaries, label,
                       label_gain, optimize_pos_at: int, device="cpu",
                       shards=None) -> List:
    """One ``QueryBlocks`` per shard (of ``shards``, default all), its row
    indices shard-local: shard d's queries re-based at its first row, the
    sentinel its row count."""
    b = np.asarray(query_boundaries, dtype=np.int64)
    label = np.asarray(label, dtype=np.float64)
    out = []
    for d in (range(plan.D) if shards is None else shards):
        q0, q1 = int(plan.query_cuts[d]), int(plan.query_cuts[d + 1])
        r0, r1 = int(plan.row_cuts[d]), int(plan.row_cuts[d + 1])
        out.append(build_query_blocks(
            b[q0:q1 + 1] - r0, label[r0:r1], label_gain,
            optimize_pos_at=optimize_pos_at, sentinel=r1 - r0,
            device=device))
    return out


class ShardedRankGrads:
    """``score [N] -> (g, h) [N]``: the pair pass over this rank's
    query-aligned shard, the shards' g/h all-gathered."""

    def __init__(self, mesh, plan: QueryShardPlan, blocks, sigmoid: float,
                 norm: bool):
        self.mesh = mesh
        self.plan = plan
        self.blocks = blocks               # this rank's QueryBlocks
        self.sigmoid = float(sigmoid)
        self.norm = bool(norm)
        self._gather = None

    def __call__(self, score):
        from ..objective.rank import pair_lambdas
        plan, dev = self.plan, score.device
        lo = int(plan.row_cuts[self.mesh.rank])
        hi = int(plan.row_cuts[self.mesh.rank + 1])
        g_l, h_l = pair_lambdas(score[lo:hi].contiguous(), self.blocks,
                                self.sigmoid, self.norm)
        pad = plan.S - (hi - lo)
        gh = torch.stack([g_l, h_l])
        if pad:
            gh = torch.nn.functional.pad(gh, (0, pad))
        every = _all_gather(gh.contiguous(), self.mesh)     # [D, 2, S]
        flat = every.permute(1, 0, 2).reshape(2, -1)        # [2, D*S]
        if self._gather is None or self._gather.device != dev:
            self._gather = torch.as_tensor(plan.gather).to(dev)
        out = torch.zeros((2, plan.n_rows + 1), dtype=torch.float32,
                          device=dev)
        out[:, self._gather] = flat
        return out[0, :plan.n_rows], out[1, :plan.n_rows]


def enable_query_sharded_grads(objective, mesh):
    """Arm ``objective`` (an initialized ``LambdarankNDCG``) with the
    sharded pair pass; returns the ``ShardedRankGrads``.  Idempotent per
    (objective, mesh)."""
    D = int(mesh.size)
    cur = getattr(objective, "_shard", None)
    if cur is not None and cur.mesh == mesh:
        return cur
    plan = plan_query_shards(objective.query_boundaries, D)
    blocks = build_shard_blocks(
        plan, objective.query_boundaries, objective.label,
        objective.label_gain, objective.optimize_pos_at,
        device=objective.device, shards=[mesh.rank])[0]
    objective._shard = ShardedRankGrads(mesh, plan, blocks,
                                        objective.sigmoid, objective.norm)
    log.info("query-aligned lambdarank sharding: %d queries over %d "
             "ranks, %d rows a shard (padded from %s)",
             len(objective.query_boundaries) - 1, D, plan.S,
             (plan.row_cuts[1:] - plan.row_cuts[:-1]).tolist())
    return objective._shard
