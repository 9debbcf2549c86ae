"""The port's telemetry report (``lightgbm_tpu_torch/obs/report.py``)
against the JAX package's ``obs/report.py`` on a sink the port wrote:
a tiny training with telemetry, profile mode, spans, the profiler window
and the rank aggregation armed.  Both readers give equal digests on
every key they share (exactly: they are the same stdlib arithmetic over
the same records), both validators accept every event the port wrote,
and the port's reader takes the port's own kinds (kernel builds and
graph captures in place of XLA compiles).  The CLI's entry runs over the sink."""
import json

import numpy as np
import pytest

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import obs
from lightgbm_tpu_torch.obs.report import (compile_summary, load_events,
                                           main, render, summarize,
                                           validate_events)

@pytest.fixture(autouse=True)
def _one_cpu_thread():
    """One intra-op thread a test (the workers of a parallel run share the
    machine); restored after."""
    import torch
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def sink(tmp_path_factory):
    """A sink the port wrote: 4 rounds, telemetry, profile and trace mode
    on, a 2-iteration profiler window, the train board armed."""
    d = tmp_path_factory.mktemp("report") / "telem"
    rng = np.random.default_rng(0)
    X = rng.normal(size=(400, 5))
    y = (X[:, 0] - X[:, 1] > 0).astype(np.float64)
    params = {"objective": "binary", "num_leaves": 7, "verbose": -1,
              "min_data_in_leaf": 10, "tpu_telemetry": str(d),
              "tpu_profile": True, "tpu_trace": True, "tpu_xprof": True,
              "tpu_xprof_iters": 2, "tpu_train_metrics_port": 0}
    try:
        lt.train(params, lt.Dataset(X, label=y), 4, device="cpu")
        obs.event("summary", **obs.digest())   # what the exit hook writes
    finally:
        obs.enable_profile(False)
        obs.enable_trace(False)
        obs.disable()
        obs.reset()
    return d


def _shared_equal(a, b, path="digest"):
    """Every key the two digests share holds the same value (recursively
    through dicts); returns the number of leaves compared."""
    if isinstance(a, dict) and isinstance(b, dict):
        n = 0
        for k in set(a) & set(b):
            n += _shared_equal(a[k], b[k], f"{path}.{k}")
        return n
    assert a == b, f"{path}: port {a!r} != JAX {b!r}"
    return 1


def test_summaries_agree_on_shared_keys(sink):
    pytest.importorskip("jax")
    from lightgbm_tpu.obs.report import load_events as jload
    from lightgbm_tpu.obs.report import summarize as jsummarize
    port = summarize(load_events(str(sink)))
    ref = jsummarize(jload(str(sink)))
    assert port["iterations"] == 4
    for key in ("xprof", "kernels", "reconciliation", "trace",
                "wave_pipeline"):
        assert key in port and key in ref, key
    assert _shared_equal(port, ref) > 50
    assert set(ref) <= set(port)


def test_every_port_event_validates(sink):
    """Both validators accept the stream: every event kind the port wrote
    here, with the schemas of the JAX package (the port's copy holds the
    same ones)."""
    pytest.importorskip("jax")
    from lightgbm_tpu.obs.report import validate_events as jvalidate
    events = load_events(str(sink))
    kinds = {e.get("event") for e in events}
    assert {"iteration", "kernel_profile", "kernel_measured", "span",
            "reconciliation", "train_start", "summary"} <= kinds
    assert validate_events(events) == []
    assert jvalidate(events) == []


def test_render_and_cli(sink, capsys):
    """The table, and the CLI's entry (``python -m
    lightgbm_tpu_torch.obs.report``'s ``main``) in this process."""
    digest = summarize(load_events(str(sink)))
    text = render(digest)
    assert "measured roofline (xprof window" in text
    assert "reconciliation (meas/model)" in text
    assert main([str(sink), "--json"]) == 0
    out = capsys.readouterr().out
    assert json.loads(out.strip().splitlines()[-1])["iterations"] == 4
    assert main([str(sink)]) == 0
    assert "merged 1 file(s)" in capsys.readouterr().out
    assert main([str(sink / "none")]) == 1   # no telemetry files there


def test_compile_plane_reads_builds_and_captures():
    """The port's compile events: kernel builds (ops/build.py) and CUDA
    graph captures (serve/aot.py); the JAX package's keys stay and stay
    zero, as a port run has no XLA compile."""
    events = [
        {"event": "compile", "kind": "kernel_build", "jit": "cuda_kernels",
         "wall_s": 41.5, "_proc": 0},
        {"event": "compile", "kind": "graph_capture", "jit": "predict",
         "_proc": 0},
        {"event": "compile", "kind": "graph_capture", "jit": "predict",
         "_proc": 0},
        {"event": "compile", "kind": "graph_capture", "jit": "explain",
         "_proc": 0},
    ]
    c = compile_summary(events)
    assert c["kernel_builds"] == 1 and c["kernel_build_s"] == 41.5
    assert c["graph_captures"] == {"explain": 1, "predict": 2}
    assert c["compiles"] == 0 and c["by_jit"] == {}
    assert validate_events(events) == []
    text = render(summarize(events))
    assert "1 kernel build(s) (41.50 s), 3 CUDA graph capture(s)" in text


def test_build_and_capture_notes_feed_the_digest(tmp_path):
    """``obs/trace.py``'s notes reach the compile digest and the sink."""
    from lightgbm_tpu_torch.obs import trace, xprof
    obs.reset()
    obs.enable(str(tmp_path))
    try:
        trace.note_build(2.5)
        trace.note_capture("arena")
    finally:
        obs.disable()
    d = xprof.compile_digest()
    assert d["kernel_builds"] == 1 and d["graph_captures"] == {"arena": 1}
    c = compile_summary(load_events(str(tmp_path)))
    assert c["kernel_builds"] == 1 and c["graph_captures"] == {"arena": 1}
    obs.reset()
    assert xprof.compile_digest() == {}
