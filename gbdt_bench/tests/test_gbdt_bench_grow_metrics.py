"""The readers of the wave grower's ranges on a small recorded trace."""
from types import SimpleNamespace

import pytest

from gbdt_bench.reference import model_text
from gbdt_bench.tests.test_gbdt_bench_metrics import EVENTS, _ev, read
from gbdt_bench.tests.test_gbdt_bench_yardstick import MODEL
from gbdt_bench.tracing import Trace

# the wave grower's ranges (``lgbm/*``, the program's own) over two traced
# iterations of one tree each: a commit loop, a partition, a compaction
# with its count's wait, a histogram pass with K1, a scan with its read's
# wait, and a wait outside the grower
GROW_EVENTS = [
    _ev("bench/traced", "user_annotation", 0, 2000),
    _ev("bench/grow", "user_annotation", 10, 1500),
    _ev("lgbm/grow.commit", "user_annotation", 20, 30),
    _ev("lgbm/grow.partition", "user_annotation", 60, 40),
    _ev("cudaLaunchKernel", "cuda_runtime", 70, 5, correlation=11),
    _ev("lgbm/grow.compact", "user_annotation", 110, 200),
    _ev("cudaLaunchKernel", "cuda_runtime", 120, 5, correlation=12),
    _ev("lgbm/wait", "user_annotation", 130, 150),
    _ev("lgbm/grow.hist", "user_annotation", 320, 100),
    _ev("cudaLaunchKernel", "cuda_runtime", 330, 5, correlation=13),
    _ev("cudaLaunchKernel", "cuda_runtime", 340, 5, correlation=14),
    _ev("lgbm/grow.scan", "user_annotation", 430, 600),
    _ev("cudaLaunchKernel", "cuda_runtime", 440, 5, correlation=15),
    _ev("lgbm/wait", "user_annotation", 450, 500),
    _ev("lgbm/grow.commit", "user_annotation", 1040, 10),
    _ev("lgbm/wait", "user_annotation", 1600, 20),
    _ev("index_elementwise_kernel", "kernel", 80, 60, tid=7,
        correlation=11),
    _ev("nonzero_kernel", "kernel", 140, 100, tid=7, correlation=12),
    _ev("_ZN12_GLOBAL__N_120hist_wave_float_rowsE", "kernel", 350, 300,
        tid=7, correlation=13),
    _ev("vectorized_elementwise_kernel", "kernel", 650, 50, tid=7,
        correlation=14),
    _ev("reduce_kernel", "kernel", 700, 240, tid=7, correlation=15),
]

GROW_READS = {"commit_ms_per_iter": 0.02, "partition_ms_per_iter": 0.03,
              "compact_ms_per_iter": 0.05, "hist_ms_per_iter": 0.175,
              "scan_ms_per_iter": 0.12, "host_waits_per_tree": 1.5,
              "host_wait_ms_per_iter": 0.335}


@pytest.fixture
def run():
    """Two traced iterations of one tree each, on the trace of
    ``test_gbdt_bench_metrics.py``, which opens no ``lgbm/*`` range."""
    tree = model_text.parse_trees(MODEL)[0]
    return SimpleNamespace(
        bin_s=1.5, rows=100, features=28, max_bin=255, pair_slots=0.0,
        window_s=0.004, window_iters=4, iter_s=0.001,
        window_trees=[tree] * 4, window_wave_stats=[(3, 10), (5, 10)],
        traced_trees=[tree, tree], traced_iters=2, trace=Trace(EVENTS),
        device_type="cuda")


def test_grow_range_readers(run):
    run.trace = Trace(GROW_EVENTS)
    for name, want in GROW_READS.items():
        assert read(name, run) == pytest.approx(want), name
    # K1's part of the histogram pass
    assert read("k1_ms_per_iter", run) == pytest.approx(0.15)


def test_grow_range_readers_find_nothing_without_the_ranges(run):
    """The parent's program opens no ``lgbm/*`` range: every reader of
    one gives nothing, and none raises."""
    for name in GROW_READS:
        assert read(name, run) is None, name
    run.trace = None
    for name in GROW_READS:
        assert read(name, run) is None, name
    # a trace without a device (a CPU run) holds no device time
    run.trace = Trace([e for e in GROW_EVENTS if e["cat"] != "kernel"])
    for name in ("partition_ms_per_iter", "compact_ms_per_iter",
                 "hist_ms_per_iter", "scan_ms_per_iter"):
        assert read(name, run) is None, name
    assert read("host_waits_per_tree", run) == 1.5
