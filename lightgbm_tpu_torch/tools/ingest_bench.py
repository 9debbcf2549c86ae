"""The streamed-ingestion bench on the port (counterpart of
tools/ingest_bench.py): a throughput leg and a correctness leg in one
process.

- **throughput leg**: a ``SyntheticSource`` (``INGEST_ROWS``, default
  120,000 rows; chunks are generated on the fly, so the raw matrix never
  exists) ingested in two passes under ``tracemalloc``, over at least 20
  chunks.  The host peak stays within O(chunk + sample + bin matrix +
  labels), below the raw [N, F] f64 bytes, and below half of them once
  the stream dwarfs the sample (a million rows of 12 features do).  The
  wall becomes ``ingest_rows_per_s``.
- **correctness leg**: a small stream whose last tenth is shifted.  The
  streamed dataset equals the in-memory construction from the same
  reservoir sample bit for bit, the chunk size changes nothing, and the
  sample covers the shifted tail.

Ingestion is host work: ``--device`` only decides whether a card must be
present.  Nothing is written into the repository: the record goes to
standard output, and ``--out DIR`` adds an ``INGEST_rN.json`` there.

    python -m lightgbm_tpu_torch.tools.ingest_bench --json
    INGEST_ROWS=100000000 INGEST_MEMMAP=1 \\
        python -m lightgbm_tpu_torch.tools.ingest_bench --device cpu

Knobs: ``INGEST_ROWS``, ``INGEST_FEATURES``, ``INGEST_CHUNK_ROWS``,
``INGEST_SAMPLE`` (``bin_construct_sample_cnt``), ``INGEST_MAXBIN``,
``INGEST_MEMMAP`` (=1 backs the bin matrix with a temporary memmap).
"""
from __future__ import annotations

import os
import sys
import tempfile
import time
import tracemalloc

import numpy as np

from ._verdict import (Verdict, device_parser, emit, resolve_device,
                       write_round)

# JAX check name -> (port check name or None, why); none differ
DEPARTURES: dict = {}

# past these sizes the O(N) differential and tracemalloc are skipped: the
# big leg measures throughput, the small leg proves the bits
_DIFF_MAX_ROWS = 300_000
_TRACE_MAX_ROWS = 10_000_000


def _env_int(name: str, default: int) -> int:
    try:
        return int(float(os.environ.get(name, "") or default))
    except ValueError:
        return default


def run_bench(device: str, quiet: bool = False) -> dict:
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.ingest import (ReservoirSampler, SyntheticSource,
                                           ingest_dataset)
    from lightgbm_tpu_torch.io.dataset import BinnedDataset

    v = Verdict("ingest", quiet=quiet)
    rows = _env_int("INGEST_ROWS", 120_000)
    features = _env_int("INGEST_FEATURES", 12)
    chunk_rows = _env_int("INGEST_CHUNK_ROWS", 4096)
    sample_cnt = _env_int("INGEST_SAMPLE", 20_000)
    max_bin = _env_int("INGEST_MAXBIN", 63)
    use_memmap = os.environ.get("INGEST_MEMMAP", "") in ("1", "true")

    P = {"verbose": -1, "max_bin": max_bin,
         "bin_construct_sample_cnt": sample_cnt,
         "tpu_ingest_chunk_rows": chunk_rows}
    cfg = Config.from_params(P)
    art = tempfile.mkdtemp(prefix="ingest_bench_")
    memmap_path = os.path.join(art, "X_bin.npy") if use_memmap else None

    # ---- throughput + bounded-memory leg ---------------------------------
    src = SyntheticSource(rows, n_features=features, chunk_rows=chunk_rows,
                          seed=0)
    raw_bytes = rows * features * 8
    trace = rows <= _TRACE_MAX_ROWS
    if trace:
        tracemalloc.start()
        tracemalloc.reset_peak()
        base = tracemalloc.get_traced_memory()[0]
    t1 = time.perf_counter()
    ds = ingest_dataset(src, cfg, memmap_path=memmap_path)
    ingest_s = time.perf_counter() - t1
    peak = None
    if trace:
        peak = tracemalloc.get_traced_memory()[1] - base
        tracemalloc.stop()
    rows_per_s = rows / ingest_s if ingest_s > 0 else 0.0

    v.check("rows_complete", ds.num_data == rows, f"{ds.num_data} != {rows}")
    v.check("stream_20x_chunk", rows >= 20 * chunk_rows,
            f"{rows} rows / {chunk_rows} chunk")
    if trace:
        # O(chunk + sample + bins + the [N] label array), never the raw
        # [N, F] matrix: half the raw bytes is the ceiling, with room for
        # the chunk transposes, the sample copies and the labels' life
        bin_bytes = 0 if use_memmap else (
            np.asarray(ds.X_bin).nbytes if ds.X_bin is not None else 0)
        budget = max(raw_bytes // 2,
                     bin_bytes + 8 * chunk_rows * features * 8
                     + 4 * sample_cnt * features * 8
                     + 3 * rows * 8 + (2 << 20))
        v.check("bounded_memory", peak < budget,
                f"peak {peak:,} >= budget {budget:,} "
                f"(raw would be {raw_bytes:,})")
        v.check("raw_never_materialized", peak < raw_bytes,
                f"peak {peak:,} vs raw {raw_bytes:,}")
    v.check("throughput_recorded", rows_per_s > 0)

    # ---- correctness leg (small, a shifted tail) -------------------------
    diff_rows = min(rows, 40_000)
    if rows > _DIFF_MAX_ROWS:
        print(f"# differential leg at {diff_rows} rows (INGEST_ROWS={rows} "
              f"is above the {_DIFF_MAX_ROWS} differential cap)", flush=True)
    dP = dict(P, bin_construct_sample_cnt=2000)
    dcfg = Config.from_params(dP)
    dsrc = SyntheticSource(diff_rows, n_features=features, chunk_rows=1024,
                           seed=3, tail_shift=6.0)
    dds = ingest_dataset(dsrc, dcfg)
    # the oracle sees the same rows and the same sample
    Xs = [Xc for Xc, _ in dsrc]
    Xfull = np.concatenate(Xs)
    samp = ReservoirSampler(2000, seed=dcfg.data_random_seed)
    for Xc in Xs:
        samp.add(Xc)
    _, idx = samp.finish()
    oracle = BinnedDataset.from_sample(Xfull[idx], len(Xfull), dcfg)
    oracle._binarize(Xfull)
    v.check("differential_bit_identical",
            np.array_equal(np.asarray(dds.X_bin), np.asarray(oracle.X_bin))
            and np.array_equal(dds.bin_offsets, oracle.bin_offsets))
    dds2 = ingest_dataset(
        SyntheticSource(diff_rows, n_features=features, chunk_rows=1024,
                        seed=3, tail_shift=6.0),
        Config.from_params(dict(dP, tpu_ingest_chunk_rows=333)))
    v.check("chunk_size_invariant",
            np.array_equal(np.asarray(dds.X_bin), np.asarray(dds2.X_bin)))
    # head bias: a sample of the first 2,000 rows could place no bound
    # past the shift
    tail0 = int(0.9 * diff_rows)
    frac_tail = float((idx >= tail0).mean())
    ub = np.asarray(dds.bin_mappers[0].bin_upper_bound)
    top = float(ub[np.isfinite(ub)].max())
    v.check("sample_covers_tail", 0.02 < frac_tail < 0.25 and top > 3.0,
            f"tail frac {frac_tail:.3f}, top bound {top:.2f}")

    return v.record(device=device, rows=int(rows), features=int(features),
                    chunk_rows=int(chunk_rows), sample_cnt=int(sample_cnt),
                    memmap=bool(use_memmap),
                    ingest_rows_per_s=round(rows_per_s, 1),
                    ingest_wall_s=round(ingest_s, 3),
                    peak_traced_bytes=int(peak) if peak is not None
                    else None,
                    raw_matrix_bytes=int(raw_bytes), artifacts_dir=art)


def main(argv=None) -> int:
    ap = device_parser("The streamed-ingestion bench on the port")
    ap.add_argument("--out", default="",
                    help="also write INGEST_rN.json into this directory")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if device is None:
        return 2
    record = run_bench(device)
    if args.out:
        write_round(record, args.out, "INGEST")
    print(f"# ingest: {record['ingest_rows_per_s']:,.1f} rows/s", flush=True)
    return emit(record, args.json)


if __name__ == "__main__":
    sys.exit(main())
