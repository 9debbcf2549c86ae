"""The cells ``epsilon.train`` and ``higgs.int16``: the readers of the
leaf histograms' stores on a small recorded trace (the roofline's bytes
worked by hand for a 3-leaf tree), and whole runs on the CPU at a small
size (the harness's look for a card skipped): the reference agrees with
the port, and the control, each planted fault and each planted departure
read ``correct`` false."""
from types import SimpleNamespace

import pytest

from gbdt_bench import faults
from gbdt_bench.metrics import hist_store_roofline
from gbdt_bench.reference import model_text
from gbdt_bench.tests import test_gbdt_bench_run as run_tests
from gbdt_bench.tests.test_gbdt_bench_metrics import EVENTS, _ev, read
from gbdt_bench.tests.test_gbdt_bench_yardstick import MODEL
from gbdt_bench.tracing import Trace

# two traced iterations: each wave's first grow.hist gathers the parents
# under a store range; the second launches K1 outside it, then the
# layouts and the stores inside it
STORE_EVENTS = [
    _ev("bench/traced", "user_annotation", 0, 2000),
    _ev("lgbm/grow.hist", "user_annotation", 100, 50),
    _ev("lgbm/grow.hist_store", "user_annotation", 110, 30),
    _ev("cudaLaunchKernel", "cuda_runtime", 120, 5, correlation=21),
    _ev("lgbm/grow.hist", "user_annotation", 300, 400),
    _ev("cudaLaunchKernel", "cuda_runtime", 310, 5, correlation=22),
    _ev("lgbm/grow.hist_store", "user_annotation", 600, 90),
    _ev("cudaLaunchKernel", "cuda_runtime", 610, 5, correlation=23),
    _ev("cudaLaunchKernel", "cuda_runtime", 620, 5, correlation=24),
    _ev("index_elementwise_kernel", "kernel", 130, 60, tid=7,
        correlation=21),
    _ev("_ZN12_GLOBAL__N_118hist_wave_int_rowsE", "kernel", 320, 300,
        tid=7, correlation=22),
    _ev("CatArrayBatchedCopy", "kernel", 630, 80, tid=7, correlation=23),
    _ev("index_put_kernel", "kernel", 710, 140, tid=7, correlation=24),
]
STORE_US = 60 + 80 + 140
F, B = 28, 255


@pytest.fixture
def run():
    tree = model_text.parse_trees(MODEL)[0]
    return SimpleNamespace(
        bin_s=1.5, rows=100, features=F, max_bin=B, pair_slots=0.0,
        window_s=0.004, window_iters=4, iter_s=0.001,
        window_trees=[tree] * 4, window_wave_stats=[(3, 10), (5, 10)],
        traced_trees=[tree, tree], traced_iters=2,
        trace=Trace(STORE_EVENTS), device_type="cuda")


def test_store_bytes_by_hand():
    """MODEL's first tree has 3 leaves: two splits, each reading its
    parent's [28, 255, 3] f32 histogram and writing its two children's,
    and the root written once: 7 histograms of 85,680 bytes."""
    grown, stump = model_text.parse_trees(MODEL)
    assert F * B * 3 * 4 == 85_680
    assert hist_store_roofline.store_bytes(grown, F, B) == 7 * 85_680
    assert hist_store_roofline.store_bytes(stump, F, B) == 0.0


def test_store_readers(run):
    assert read("hist_store_ms_per_iter", run) == pytest.approx(
        STORE_US / 1e3 / 2)
    need_s = 2 * 7 * 85_680 / 3.35e12
    assert read("hist_store_roofline", run) == pytest.approx(
        100.0 * need_s / (STORE_US / 1e6))
    # K1 is outside the stores' range and read by its own readers
    assert read("k1_ms_per_iter", run) == pytest.approx(0.15)
    assert read("hist_ms_per_iter", run) == pytest.approx(
        (STORE_US + 300) / 1e3 / 2)


def test_store_readers_find_nothing_without_the_range(run):
    """A program that opens no ``lgbm/grow.hist_store`` range (the parent
    of the change that added it), no trace, or a trace without a device
    track: nothing, and nothing raises."""
    run.trace = Trace(EVENTS)
    for name in ("hist_store_ms_per_iter", "hist_store_roofline"):
        assert read(name, run) is None, name
    run.trace = None
    for name in ("hist_store_ms_per_iter", "hist_store_roofline"):
        assert read(name, run) is None, name
    run.trace = Trace([e for e in STORE_EVENTS if e["cat"] != "kernel"])
    for name in ("hist_store_ms_per_iter", "hist_store_roofline"):
        assert read(name, run) is None, name


# The whole-run tests of test_gbdt_bench_run.py for the two new cells,
# whose CPU sizes its ROWS table lacks: Epsilon's 2,000 features on few
# rows, HIGGS at higgs.train's test size.
ROWS = {"epsilon.train": 3000, "higgs.int16": 20_000}


@pytest.fixture(autouse=True)
def _new_cells_rows(monkeypatch):
    for workload, rows in ROWS.items():
        monkeypatch.setitem(run_tests.ROWS, workload, rows)


@pytest.mark.parametrize("workload", sorted(ROWS))
def test_reference_agrees_with_the_port(workload):
    run_tests.test_reference_agrees_with_the_port(workload)


@pytest.mark.parametrize("workload", sorted(ROWS))
def test_lower_precision_control_is_not_correct(workload):
    run_tests.test_lower_precision_control_is_not_correct(workload)


def test_int8_is_not_correct_in_higgs_int16():
    """int8, the precision one step below the int16 the cell states."""
    result, checks = run_tests.small("higgs.int16",
                                     params={"tpu_hist_dtype": "int8"})
    assert not result["correct"], checks


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("workload", sorted(ROWS))
def test_planted_fault_is_not_correct(workload, fault):
    run_tests.test_planted_fault_is_not_correct(workload, fault)


@pytest.mark.parametrize("departure", sorted(faults.DEPARTURES))
@pytest.mark.parametrize("workload", sorted(ROWS))
def test_planted_departure_is_not_correct(workload, departure):
    run_tests.test_planted_departure_is_not_correct(workload, departure)
