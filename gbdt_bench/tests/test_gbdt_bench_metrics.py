"""Each per-layer reader on a small recorded trace."""
import importlib
import json
from types import SimpleNamespace

import pytest

from gbdt_bench import yardstick
from gbdt_bench.reference import model_text
from gbdt_bench.tests.test_gbdt_bench_yardstick import MODEL
from gbdt_bench.tracing import Trace


def _ev(name, cat, ts, dur, tid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "pid": 1, "tid": tid, "args": args}


EVENTS = [
    _ev("bench/traced", "user_annotation", 0, 1000),
    _ev("bench/gradients", "user_annotation", 100, 100),
    _ev("cudaLaunchKernel", "cuda_runtime", 150, 5, correlation=1),
    _ev("aten::item", "cpu_op", 270, 30),
    _ev("cudaLaunchKernel", "cuda_runtime", 300, 5, correlation=2),
    _ev("aten::nonzero", "cpu_op", 750, 150),
    _ev("elementwise_kernel", "kernel", 160, 100, tid=7, correlation=1),
    _ev("_ZN12_GLOBAL__N_120hist_wave_float_rowsE", "kernel", 310, 400,
        tid=7, correlation=2),
    _ev("Memset (Device)", "gpu_memset", 700, 50, tid=7, correlation=3),
    {"ph": "i", "name": "instant", "ts": 5},
]


@pytest.fixture
def trace(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": EVENTS}))
    return Trace.load(path)


@pytest.fixture
def run(trace):
    tree = model_text.parse_trees(MODEL)[0]
    return SimpleNamespace(
        bin_s=1.5, rows=100, features=28, max_bin=255, pair_slots=0.0,
        window_s=0.004, window_iters=4, iter_s=0.001,
        window_trees=[tree] * 4, window_wave_stats=[(3, 10), (5, 10)],
        traced_trees=[tree, tree], traced_iters=2, trace=trace,
        device_type="cuda")


def read(name, run):
    return importlib.import_module(f"gbdt_bench.metrics.{name}").read(run)


def test_trace_arithmetic(trace):
    assert trace.busy_us() == 100 + (750 - 310)
    assert trace.kernel_us("hist_wave") == 400
    assert trace.under_range_us("bench/gradients") == 100
    assert trace.top_ops(2) == [
        ["_ZN12_GLOBAL__N_120hist_wave_float_rowsE", 400e-6],
        ["elementwise_kernel", 100e-6]]
    gaps = dict(trace.idle_gaps((0, 1000)))
    assert gaps == pytest.approx({"bench/traced > python": 160e-6,
                                  "bench/traced > aten::item": 50e-6,
                                  "bench/traced > aten::nonzero": 250e-6})


def test_readers(run):
    tree = run.traced_trees[0]
    need_hist = yardstick.least_seconds(*yardstick.hist_cost(tree, 28, 255))
    need_iter = yardstick.least_seconds(*yardstick.iteration_cost(
        tree, 100, 28, 255))
    assert read("bin_s", run) == 1.5
    assert read("waves_per_tree", run) == 4.0
    assert read("k1_ms_per_iter", run) == pytest.approx(0.2)
    assert read("grad_ms_per_iter", run) == pytest.approx(0.05)
    assert read("device_idle_pct", run) == pytest.approx(
        100 * (1 - 270e-6 / 1e-3))
    assert read("k1_roofline", run) == pytest.approx(
        100 * 2 * need_hist / 400e-6)
    assert read("iter_mfu_pct", run) == pytest.approx(
        100 * 4 * need_iter / 0.004)


def test_readers_find_nothing_without_a_device(run):
    run.trace = Trace([e for e in EVENTS if e.get("cat") not in
                       ("kernel", "gpu_memset")])
    run.device_type = "cpu"
    for name in ("k1_ms_per_iter", "k1_roofline", "grad_ms_per_iter",
                 "device_idle_pct", "iter_mfu_pct"):
        assert read(name, run) is None, name
    run.window_wave_stats = [(-1, 0)]
    assert read("waves_per_tree", run) is None
