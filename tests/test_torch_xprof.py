"""The profiler window (``lightgbm_tpu_torch/obs/xprof.py``) on the CPU:
a window over a tiny training attributes the ``lgbm/*`` phase ranges;
the port's and the JAX package's trace parsers agree on empty, truncated
and corrupt files (neither raises); the ``kernel_measured`` rows pass
the JAX package's schema; on a Kineto-shaped trace the port's rules
attribute the hand kernels by symbol, other device work by the range
around it, and leave the rest ``unattributed``; the window's switches
resolve as the JAX package's do.  On the card (marked ``cuda``) the
window finds K1's launches."""
import gzip
import json

import numpy as np
import pytest

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import obs
from lightgbm_tpu_torch.obs import xprof
from lightgbm_tpu_torch.obs.report import load_events, validate_events


@pytest.fixture(autouse=True)
def _one_cpu_thread():
    """One intra-op thread a test; restored after."""
    import torch
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _data(n=300, f=4, seed=1):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f))
    return X, (X[:, 0] + 0.5 * X[:, 1] > 0).astype(np.float64)


@pytest.fixture(scope="module")
def cpu_window(tmp_path_factory):
    """4 rounds with a 2-iteration window, telemetry into ``telem``."""
    d = tmp_path_factory.mktemp("xprof") / "telem"
    X, y = _data()
    params = {"objective": "binary", "num_leaves": 7, "verbose": -1,
              "min_data_in_leaf": 10, "tpu_telemetry": str(d),
              "tpu_xprof": True, "tpu_xprof_iters": 2}
    try:
        lt.train(params, lt.Dataset(X, label=y), 4, device="cpu")
    finally:
        obs.disable()
        obs.reset()
    return d


def test_cpu_window_attributes_phase_ranges(cpu_window):
    files = xprof.trace_files(str(cpu_window / "xprof"))
    assert len(files) == 1 and files[0].endswith(".trace.json")
    rows = [e for e in load_events(str(cpu_window))
            if e.get("event") == "kernel_measured"]
    scopes = {r["kernel"]: r for r in rows}
    assert {"lgbm/tree growth", "lgbm/boosting (grad/hess)"} <= set(scopes)
    growth = scopes["lgbm/tree growth"]
    assert growth["ops"] == 2           # one range an iteration, 2 recorded
    assert growth["device"] == "host"   # a CPU window: the host ranges
    assert 0 < growth["measured_ms"] <= growth["window_ms"]
    # no device track on the CPU, so nothing is left unattributed
    assert "unattributed" not in scopes


def test_measured_rows_pass_both_schemas(cpu_window):
    pytest.importorskip("jax")
    from lightgbm_tpu.obs.report import validate_events as jvalidate
    rows = [e for e in load_events(str(cpu_window))
            if e.get("event") in ("kernel_measured", "reconciliation")]
    assert rows
    assert validate_events(rows) == []
    assert jvalidate(rows) == []


def _bad_files(d):
    """An empty file, a truncated gzip stream, a corrupt gzip header,
    JSON that is not an object, and a trace without events."""
    d.mkdir()
    (d / "empty.trace.json").write_text("")
    good = gzip.compress(json.dumps({"traceEvents": [
        {"ph": "X", "name": "lgbm/tree growth", "ts": 0, "dur": 5}]}).encode())
    (d / "trunc.trace.json.gz").write_bytes(good[:len(good) // 2])
    (d / "corrupt.trace.json.gz").write_bytes(b"\x1f\x8bnot gzip at all")
    (d / "list.trace.json").write_text("[1, 2]")
    (d / "noevents.trace.json").write_text('{"other": 1}')
    return d


@pytest.mark.parametrize("kind", ["missing", "empty_dir", "bad_files"])
def test_parsers_agree_on_bad_traces(tmp_path, kind):
    pytest.importorskip("jax")
    from lightgbm_tpu.obs import xprof as jxprof
    d = tmp_path / "traces"
    if kind == "empty_dir":
        d.mkdir()
    elif kind == "bad_files":
        _bad_files(d)
    port = xprof.parse_trace_dir(str(d))
    ref = jxprof.parse_trace_dir(str(d))
    assert port == ref
    assert port["parsed"] == 0 and port["ops"] == []
    if kind == "bad_files":
        assert port["files"] == 5 and len(port["errors"]) == 5
        assert xprof.attribute(port)["kernels"] == {}


def _kineto_trace():
    """A trace shaped as Kineto writes one on the card: a host thread
    with two ``lgbm/*`` ranges and the launches in them, the device's
    ranges (``gpu_user_annotation``) and its kernels."""
    host, dev = 1000, 0
    ev = [
        {"ph": "M", "name": "process_name", "pid": host,
         "args": {"name": "python"}},
        {"ph": "M", "name": "thread_name", "pid": host, "tid": 7,
         "args": {"name": "thread 7 (python)"}},
        {"ph": "M", "name": "process_name", "pid": dev,
         "args": {"name": "python"}},
        {"ph": "X", "cat": "user_annotation", "name": "lgbm/tree growth",
         "pid": host, "tid": 7, "ts": 100, "dur": 900},
        {"ph": "X", "cat": "user_annotation",
         "name": "lgbm/boosting (grad/hess)", "pid": host, "tid": 7,
         "ts": 1100, "dur": 100},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "pid": host, "tid": 7, "ts": 150, "dur": 5,
         "args": {"correlation": 1}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "pid": host, "tid": 7, "ts": 1120, "dur": 5,
         "args": {"correlation": 3}},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "lgbm/tree growth",
         "pid": dev, "tid": 7, "ts": 200, "dur": 800},
        # K1 by its (anonymous-namespace) symbol
        {"ph": "X", "cat": "kernel", "pid": dev, "tid": 7, "ts": 210,
         "dur": 300, "name": "(anonymous namespace)::hist_wave_float_rows"
         "(unsigned char const*, int, int)",
         "args": {"device": 0, "correlation": 1}},
        # a torch kernel inside the device range
        {"ph": "X", "cat": "kernel", "pid": dev, "tid": 7, "ts": 600,
         "dur": 100, "name": "void at::native::reduce_kernel<512, 1>()",
         "args": {"device": 0, "correlation": 2}},
        # outside every device range; its launch lies in a host range
        {"ph": "X", "cat": "kernel", "pid": dev, "tid": 7, "ts": 1150,
         "dur": 20, "name": "void at::native::elementwise_kernel()",
         "args": {"device": 0, "correlation": 3}},
        # nothing claims it
        {"ph": "X", "cat": "gpu_memcpy", "pid": dev, "tid": 8, "ts": 1300,
         "dur": 40, "name": "Memcpy DtoH (Device -> Pinned)",
         "args": {"device": 0, "correlation": 9}},
        {"ph": "X", "cat": "Trace", "name": "PyTorch Profiler (0)",
         "pid": "Spans", "tid": 1, "ts": 0, "dur": 99999},
    ]
    return {"traceEvents": ev}


def test_kineto_trace_attribution(tmp_path):
    (tmp_path / "card.trace.json").write_text(json.dumps(_kineto_trace()))
    parsed = xprof.parse_trace_dir(str(tmp_path))
    att = xprof.attribute(parsed)
    k = att["kernels"]
    assert k["lgbm/hist_wave"]["ops"] == 1
    assert k["lgbm/hist_wave"]["measured_ms"] == pytest.approx(0.3)
    # device time wins over the host range's wall on the card
    assert k["lgbm/tree growth"]["measured_ms"] == pytest.approx(0.1)
    assert k["lgbm/tree growth"]["devices"] == ["GPU 0"]
    assert k["lgbm/boosting (grad/hess)"]["measured_ms"] == \
        pytest.approx(0.02)
    assert att["devices"]["GPU 0"] == {"ops": 4, "busy_ms": 0.46,
                                       "unattributed_ms": 0.04}
    assert att["window_ms"] == pytest.approx(1.24)
    # the JAX package's device rule sees no device track in Kineto's trace
    ctx = {"rows": 1_000_000, "features": 28, "bins": 256,
           "mode": "2xbf16", "packed": True, "fused": True,
           "k1_launches": 1, "k1_rows": 1_000_000}
    rows = {r["kernel"]: r for r in xprof.measured_rooflines(att, ctx)}
    k1 = rows["lgbm/hist_wave"]
    assert k1["model"] == "hist_wave" and k1["bound"] == "bytes"
    from lightgbm_tpu_torch.ops.hist_wave import hist_wave_cost
    from lightgbm_tpu_torch.obs.profile import device_peaks
    _, nbytes = hist_wave_cost(1_000_000, 28, 256, 1_000_000, packed=True,
                               fused=True)
    want_ms = nbytes / device_peaks()[1] * 1e3
    assert k1["model_ms"] == pytest.approx(want_ms, rel=1e-5)
    assert k1["roofline_frac"] == pytest.approx(want_ms / 0.3, rel=1e-4)
    assert rows["unattributed"]["device"] == "GPU 0"
    assert validate_events([{"event": "kernel_measured", **r}
                            for r in rows.values()]) == []


def test_jax_rule_misses_kineto_device_tracks(tmp_path):
    """Why the port has its own track rule: the JAX package's parser
    finds no device track in a Kineto trace."""
    pytest.importorskip("jax")
    from lightgbm_tpu.obs import xprof as jxprof
    (tmp_path / "card.trace.json").write_text(json.dumps(_kineto_trace()))
    assert jxprof.parse_trace_dir(str(tmp_path))["tracks"] == {}
    assert "GPU 0" in xprof.parse_trace_dir(str(tmp_path))["tracks"]


@pytest.mark.parametrize("env,cfg,want", [
    ("", {}, 0), ("", {"tpu_xprof": True}, 3),
    ("", {"tpu_xprof": True, "tpu_xprof_iters": 5}, 5),
    ("1", {}, 3), ("7", {}, 7), ("off", {"tpu_xprof": True}, 0),
    ("true", {"tpu_xprof_iters": 2}, 2)])
def test_resolve_window_as_the_jax_package(monkeypatch, env, cfg, want):
    pytest.importorskip("jax")
    from lightgbm_tpu.config import Config as JConfig
    from lightgbm_tpu.obs import xprof as jxprof
    monkeypatch.setenv("LGBM_TPU_XPROF", env)
    assert xprof.resolve_window(lt.Config.from_params(cfg)) == want
    assert jxprof.resolve_window(JConfig.from_params(cfg)) == want


def test_window_steps_and_closes(tmp_path):
    """Skip one, record two, then stop: ``close`` ends an open window."""
    win = xprof.WindowedCapture(str(tmp_path / "w"), iters=2, skip=1)
    win.step()
    assert not win.active
    win.step()
    assert win.active
    win.close()
    assert win.done and not win.active and win.trace_path
    assert xprof.trace_files(str(tmp_path / "w")) == [win.trace_path]


@pytest.mark.cuda
def test_window_on_card_finds_k1(tmp_path):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K1 has no CPU mode")
    X, y = _data(n=20_000, f=8)
    params = {"objective": "binary", "num_leaves": 31, "verbose": -1,
              "tpu_telemetry": str(tmp_path), "tpu_xprof": True,
              "tpu_xprof_iters": 2}
    try:
        lt.train(params, lt.Dataset(X, label=y), 4, device="cuda")
    finally:
        obs.disable()
        obs.reset()
    rows = {e["kernel"]: e for e in load_events(str(tmp_path))
            if e.get("event") == "kernel_measured"}
    k1 = rows["lgbm/hist_wave"]
    assert k1["ops"] > 0 and k1["model"] == "hist_wave"
    assert 0 < k1["roofline_frac"] <= 1.0


def test_window_arming_ends_with_reset():
    """After a ``tpu_xprof`` training and ``obs.reset()``, no window is
    armed: ``profile_wrap`` hands back the function itself."""
    X, y = _data()
    params = {"objective": "binary", "num_leaves": 7, "verbose": -1,
              "min_data_in_leaf": 10, "tpu_xprof": True,
              "tpu_xprof_iters": 2}
    try:
        lt.train(params, lt.Dataset(X, label=y), 3, device="cpu")
    finally:
        obs.reset()
    fn = lambda x: x  # noqa: E731
    assert obs.profile_wrap("k", fn) is fn
