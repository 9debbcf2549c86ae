"""Out-of-core streaming ingestion (counterpart of lightgbm_tpu/ingest/).

Every other way into training holds the raw [N, F] f64 matrix in host
RAM before binning; this one never does.  Two walks over a re-iterable
chunk source: a seeded reservoir sample for bin finding (uniform over
the whole stream), then chunk-by-chunk binning into a preallocated bin
matrix, in RAM or ``np.memmap``-backed.  Row-shard plans (query-aligned
for ranking) let each rank of a fleet bin only its rows.  Peak host
memory: O(chunk + sample + bin matrix).

::

    from lightgbm_tpu_torch import ingest
    src = ingest.NpzSource("higgs.npy", chunk_rows=65536)  # + higgs.y.npy
    ds = ingest.dataset_from_stream(src, params)   # a lightgbm_tpu_torch.Dataset
    bst = lightgbm_tpu_torch.train(params, ds, 100)

CLI: ``task=train tpu_ingest=true`` loads the data files through the
chunked readers (CSV/TSV, LibSVM, ``.npy``/``.npz``); ``two_round=true``
streams LibSVM input through here.
"""
from .readers import (ArraySource, LibSVMSource, NpzSource,
                      SyntheticSource, TextSource, open_source)
from .sample import ReservoirSampler, merge_shard_samples, sample_seed
from .shard import (RowShardPlan, local_query_sizes, plan_row_shards,
                    resolve_shard)
from .stream import (IngestError, chunk_rows_from_config, dataset_digest,
                     dataset_from_stream, ingest_dataset, ingest_file,
                     memmap_from_config)

__all__ = [
    "ArraySource", "LibSVMSource", "NpzSource", "SyntheticSource",
    "TextSource", "open_source",
    "ReservoirSampler", "merge_shard_samples", "sample_seed",
    "RowShardPlan", "local_query_sizes", "plan_row_shards",
    "resolve_shard",
    "IngestError", "chunk_rows_from_config", "dataset_digest",
    "dataset_from_stream", "ingest_dataset", "ingest_file",
    "memmap_from_config",
]
