"""Tree learning across ranks over ``torch.distributed`` (counterpart of
lightgbm_tpu/parallel/; reference: src/network/network.cpp,
src/treelearner/{data,feature,voting}_parallel_tree_learner.cpp):

- data parallel: rows sharded, histograms summed across ranks (the
  reference's ReduceScatter + SyncUpGlobalBestSplit);
- feature parallel: features sharded for the search, every rank holding
  all rows; each rank's best split combined by an all-gather and argmax;
- voting parallel: rows sharded, a per-rank top-k feature vote before the
  histogram exchange (PV-Tree);
- query-aligned lambdarank shards (``rank_shard.py``): the pair pass of
  the data-parallel learner on each rank's whole queries.

One process is one rank (``distributed.py init_distributed``).
"""
from .mesh import (NETWORK, build_mesh, make_data_parallel_grower,
                   make_feature_parallel_grower, make_voting_parallel_grower,
                   shard_rows)
from .rank_shard import (ShardedRankGrads, enable_query_sharded_grads,
                         plan_query_shards)
