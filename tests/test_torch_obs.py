"""The port's telemetry plane (``obs/core.py``, ``obs/profile.py``,
``obs/memory.py``) against the JAX package's readers (twins of the
``tests/test_obs.py`` cases whose behavior the port has).

Off, training writes no file, accumulates no phase, and calls
``torch.cuda.synchronize`` no more than it does without the plane; on,
it streams the JAX package's ``dataset``, ``train_start``,
``iteration``, ``kernel_profile`` and ``summary`` events, which the JAX
package's ``obs/report.py`` and ``tools/telemetry_report.py`` summarize.
Profile mode records each K1 launch against the port's own bound
(``ops/hist_wave.py hist_wave_cost``).  The collectives of the learners
across ranks are counted once a call (``parallel/mesh.py``), under the
JAX package's counter names.  The memory census reads the CUDA caching
allocator, so on the CPU it records nothing (its card case is marked
``cuda``)."""
import importlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import obs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PARAMS = {"objective": "binary", "metric": "auc", "num_leaves": 7,
           "min_data_in_leaf": 5, "verbose": -1}


def _toy(n=500, f=6, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f))
    y = (X[:, 0] + 0.5 * X[:, 1] > 0).astype(np.float64)
    return X, y


def _train(n_iter=5, with_valid=False, params=_PARAMS, device="cpu"):
    X, y = _toy()
    ds = lt.Dataset(X, label=y, params=params)
    bst = lt.Booster(params=params, train_set=ds, device=device)
    if with_valid:
        bst.add_valid(lt.Dataset(X, label=y, params=params, reference=ds),
                      "v0")
    for _ in range(n_iter):
        bst.update()
    return bst


@pytest.fixture(scope="module")
def report():
    pytest.importorskip("jax")
    return importlib.import_module("lightgbm_tpu.obs.report")


# ---------------------------------------------------------------------------
# off path
# ---------------------------------------------------------------------------

def test_telemetry_off_no_file_no_sync(monkeypatch):
    """With every plane off, training opens no file, accumulates no
    phase, and no obs hook synchronizes the device."""
    assert not obs.tracing_enabled(), \
        "LGBM_TPU_TIMETAG/TELEMETRY leaked into the test environment"
    from lightgbm_tpu_torch.obs import core
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **k: calls.append(a))
    orig = core._cuda_device
    monkeypatch.setattr(core, "_cuda_device",
                        lambda x: calls.append(x) or orig(x))
    _train(3)
    assert calls == []
    assert obs.sink_path() is None
    assert obs.phase_snapshot() == {}


@pytest.fixture(scope="module")
def telem_run(tmp_path_factory):
    sink = tmp_path_factory.mktemp("telem")
    obs.reset()
    obs.enable(str(sink))
    obs.enable_profile()
    try:
        _train(5, with_valid=True)
        digest = obs.digest()
        obs.event("summary", **digest)
    finally:
        obs.enable_profile(False)
        obs.disable()
        obs.reset()
    return sink, digest


def test_iteration_records(telem_run):
    sink, _ = telem_run
    events = [json.loads(ln) for ln in
              (sink / "telemetry.0.jsonl").read_text().splitlines()]
    iters = [e for e in events if e["event"] == "iteration"]
    assert [e["iteration"] for e in iters] == list(range(5))
    for e in iters:
        assert "tree growth" in e["phase_s"]
        assert "boosting (grad/hess)" in e["phase_s"]
        assert e["metrics"]["training.auc"] > 0.5
        assert e["metrics"]["v0.auc"] > 0.5
        assert e["leaves"] == [7]
        assert e["waves"] >= 1 and e["kernel_rows"] >= 1
        assert e["recompiles"] == 0     # no kernel build on the CPU
        assert e["cum_row_iters_per_s"] > 0
        assert e["hist_mode"] == "2xbf16"
    starts = [e for e in events if e["event"] == "train_start"]
    assert starts and starts[0]["num_leaves"] == 7 and starts[0]["wave"]


def test_report_roundtrip_and_tool(telem_run, report, capsys, monkeypatch):
    sink, _ = telem_run
    assert report.telemetry_files(str(sink)) == [
        str(sink / "telemetry.0.jsonl")]
    events = report.load_events(str(sink))
    assert report.validate_events(events) == []
    digest = report.summarize(events)
    assert digest["processes"] == [0] and digest["iterations"] == 5
    assert digest["phase_s"]["tree growth"] > 0
    assert digest["metrics_last"]["training.auc"] > 0.5
    assert digest["parse_errors"] == 0
    text = report.render(digest)
    assert "tree growth" in text and "training.auc" in text
    import runpy
    tool = os.path.join(REPO, "tools", "telemetry_report.py")
    monkeypatch.setattr(sys, "argv", [tool, str(sink), "--json"])
    with pytest.raises(SystemExit) as ei:
        runpy.run_path(tool, run_name="__main__")
    assert ei.value.code == 0
    assert json.loads(capsys.readouterr().out)["iterations"] == 5


def test_profile_records_k1_against_its_bound(telem_run, report):
    """Each K1 launch is a ``kernel_profile`` event whose operations and
    bytes are ``hist_wave_cost``'s and whose bound is over the device's
    peaks; the digest sums them.  Each wave's split scan is one more
    event, in the scan's range."""
    from lightgbm_tpu_torch.obs import profile
    sink, digest = telem_run
    events = report.load_events(str(sink))
    kp_all = [e for e in events if e["event"] == "kernel_profile"]
    assert {e["kernel"] for e in kp_all} == {"hist_wave", "split_scan"}
    kp = [e for e in kp_all if e["kernel"] == "hist_wave"]
    scans = [e for e in kp_all if e["kernel"] == "split_scan"]
    waves = sum(e["waves"] for e in events if e["event"] == "iteration")
    assert len(kp) == waves and len(scans) == waves
    assert all(e["phase"] == "grow.scan" and e["bytes"] > 0 for e in scans)
    for e in kp:
        assert e["flops"] > 0 and e["bytes"] > 0 and e["achieved_s"] > 0
        # the event rounds the bound to 1e-9 s
        assert e["roofline_s"] == pytest.approx(
            profile.roofline_seconds(e["flops"], e["bytes"]), rel=0,
            abs=1e-9)
        # the innermost phase: the wave grower's histogram range
        assert e["phase"] == "grow.hist"
    k = digest["kernels"]["hist_wave"]
    assert k["calls"] == len(kp) and k["roofline_frac"] > 0
    assert report.summarize(events)["kernels"]["hist_wave"]["calls"] \
        == len(kp)


def test_hist_wave_cost_is_the_bound_of_a_launch():
    """The cost of a call is the cost function's at the call's shapes."""
    from lightgbm_tpu_torch.ops import hist_wave as hw
    F, N, B = 4, 100, 64
    bins = torch.zeros((F, N), dtype=torch.uint8)
    v = torch.ones(N)
    slot = torch.full((128,), -1, dtype=torch.int32)
    got = hw.hist_wave_call_cost(bins, v, v, v, v, slot, B,
                                 highest="int16", packed=True, parent=1)
    assert got == hw.hist_wave_cost(N, F, B, N, packed=True, fused=True,
                                    quant=True)
    ops, nbytes = hw.hist_wave_cost(N, F, B, N, packed=True, fused=True,
                                    quant=True)
    assert ops == 3 * F * N + 2 * F * B * 128
    assert nbytes == F * N + 8 * N + 128 * 4 + 6 * F * B * 128 * 4
    from lightgbm_tpu_torch.ops import hist_channels as hc
    assert hc.hist_channels_cost(N, F, B, 32) == (F * N * 32,
                                                  F * N + 4 * N * 32
                                                  + 4 * F * B * 32)


def test_collective_accounting_unit(tmp_path):
    obs.reset()
    obs.enable(str(tmp_path / "c"))
    try:
        obs.record_collective("psum", torch.zeros((4, 8)))
        obs.record_collective_host("process_allgather", 1024)
        snap = obs.counters_snapshot()
        assert snap["collective/psum/traced_calls"] == 1
        assert snap["collective/psum/traced_bytes"] == 4 * 8 * 4
        assert snap["collective/process_allgather/bytes"] == 1024
        events = [json.loads(ln) for ln in open(obs.sink_path())]
        assert [e["kind"] for e in events if e["event"] == "collective"] \
            == ["psum", "process_allgather"]
    finally:
        obs.disable()
        obs.reset()


def test_memory_census_and_release_audit(tmp_path):
    """Without a card the allocator has no statistics: the census records
    nothing, as the JAX module does without device stats.  The release
    audit keeps weak references to tensors."""
    obs.reset()
    obs.enable(str(tmp_path / "aud"))
    obs.enable_profile()
    try:
        if not torch.cuda.is_available():
            assert obs.memory_snapshot("p", {"x": torch.ones(4)}) is None
        pinned = torch.ones(128) * 2
        obs.expect_released("pinned_buf", pinned)
        dropped = torch.ones(64) * 3
        obs.expect_released("dropped_buf", dropped)
        del dropped
        assert obs.memory_audit("test_phase") == ["pinned_buf"]
        events = [json.loads(ln) for ln in open(obs.sink_path())]
        aud = [e for e in events if e["event"] == "donation_audit"]
        assert aud and aud[0]["survivors"] == ["pinned_buf"]
        assert pinned.shape == (128,)
    finally:
        obs.enable_profile(False)
        obs.disable()
        obs.reset()


@pytest.mark.cuda
def test_memory_census_on_the_card(tmp_path, report):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    sink = tmp_path / "mem"
    obs.reset()
    obs.enable(str(sink))
    obs.enable_profile()
    try:
        _train(3, device="cuda")
        digest = obs.digest()
    finally:
        obs.enable_profile(False)
        obs.disable()
        obs.reset()
    events = report.load_events(str(sink))
    mc = [e for e in events if e["event"] == "memory_census"]
    assert {"train_init", "iteration_0"} <= {e["phase"] for e in mc}
    assert mc[-1]["buffers"]["binned_matrix"] > 0
    assert digest["memory"]["peak_bytes"] > 0
    assert digest["memory"]["phase_peak_bytes"].get("tree growth", 0) > 0
    assert report.validate_events(events) == []


def test_profile_off_is_identity_and_roofline_math():
    assert not obs.profile_enabled()
    fn = lambda x: x  # noqa: E731
    assert obs.profile_wrap("k", fn) is fn
    from lightgbm_tpu_torch.obs import profile as P
    assert P.roofline_seconds(2e12, 1e6, peaks=(1e12, 1e9)) == 2.0
    assert P.roofline_seconds(1e9, 5e9, peaks=(1e12, 1e9)) == 5.0
    assert P.device_peaks("NVIDIA H100 80GB HBM3") == (67e12, 3.35e12)


def test_telemetry_env_smoke_subprocess(tmp_path, report):
    """``LGBM_TPU_TELEMETRY`` in a fresh interpreter: the dataset event
    before training, one summary at exit."""
    sink = tmp_path / "t"
    code = (
        "import numpy as np, lightgbm_tpu_torch as lt\n"
        "rng = np.random.default_rng(0)\n"
        "X = rng.normal(size=(300, 4)); y = (X[:, 0] > 0).astype(float)\n"
        "p = {'objective': 'binary', 'num_leaves': 4,\n"
        "     'min_data_in_leaf': 5, 'verbose': -1, 'device_type': 'cpu'}\n"
        "bst = lt.train(p, lt.Dataset(X, label=y, params=p), 3)\n"
        "assert bst.num_trees() == 3\n")
    env = dict(os.environ, LGBM_TPU_TELEMETRY=str(sink),
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=240)
    assert r.returncode == 0, r.stdout + r.stderr
    events = report.load_events(str(sink))
    names = [e["event"] for e in events]
    assert names.count("iteration") == 3
    assert names.count("summary") == 1
    assert names.index("dataset") < names.index("train_start")


def test_off_path_overhead_guard(monkeypatch):
    """The disabled plane adds under 5% to a 5-iteration train: the time
    spent inside its entry points (phase enter/exit, sync) against the
    train's wall time."""
    assert not obs.tracing_enabled()
    from lightgbm_tpu_torch.boosting import gbdt
    spent = [0.0]
    orig_tag, orig_sync = gbdt.timetag, gbdt.sync

    class TimedTag:
        def __init__(self, name):
            t0 = time.perf_counter()
            self._inner = orig_tag(name)
            spent[0] += time.perf_counter() - t0

        def __enter__(self):
            t0 = time.perf_counter()
            self._inner.__enter__()
            spent[0] += time.perf_counter() - t0
            return self

        def __exit__(self, *exc):
            t0 = time.perf_counter()
            r = self._inner.__exit__(*exc)
            spent[0] += time.perf_counter() - t0
            return r

    def timed_sync(x):
        t0 = time.perf_counter()
        r = orig_sync(x)
        spent[0] += time.perf_counter() - t0
        return r
    monkeypatch.setattr(gbdt, "timetag", TimedTag)
    monkeypatch.setattr(gbdt, "sync", timed_sync)
    t0 = time.perf_counter()
    _train(5)
    total = time.perf_counter() - t0
    assert spent[0] < 0.05 * total, \
        f"telemetry off-path spent {spent[0]:.4f}s of {total:.4f}s"
