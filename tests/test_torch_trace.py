"""The port's trace plane (``obs/spans.py``, the build counter of
``obs/trace.py``, the serving spans and the flight recorder) against the
JAX package's readers (twins of the ``tests/test_trace.py`` cases whose
behavior the port has).  A request entering the HTTP edge with an
``X-Request-Id`` comes out as a span tree under that trace id
(``serve/request`` -> ``serve/queue_wait``, ``serve/coalesce``,
``serve/device_execute``: the port pads inside its device call, so it
writes no separate ``serve/pad``); training iterations are
``train/iteration`` spans over their phases; a degradation dumps
``FLIGHT_rN.json``; and the JAX package's ``tools/trace_export.py`` and
``obs/report.py`` read the port's files.  There is no host fallback in
the port: a failed device batch fails its requests (HTTP 503)."""
import importlib
import json
import os
import sys
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import obs
from lightgbm_tpu_torch.serve import PredictorSession, PredictServer

TOOLS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools")


@pytest.fixture(autouse=True)
def _obs_clean():
    yield
    obs.disable()
    obs.enable_trace(False)
    obs.enable_flight(0)
    obs.reset()


@pytest.fixture(scope="module")
def report():
    pytest.importorskip("jax")
    return importlib.import_module("lightgbm_tpu.obs.report")


@pytest.fixture(scope="module")
def trace_export():
    pytest.importorskip("jax")
    sys.path.insert(0, TOOLS)
    try:
        return importlib.import_module("trace_export")
    finally:
        sys.path.remove(TOOLS)


@pytest.fixture(scope="module")
def binary_model(tmp_path_factory):
    rng = np.random.default_rng(0)
    X = rng.normal(size=(600, 5))
    y = (X[:, 0] + 0.5 * X[:, 1] > 0).astype(np.float64)
    params = {"objective": "binary", "num_leaves": 15, "verbose": -1,
              "min_data_in_leaf": 5}
    bst = lt.train(params, lt.Dataset(X, label=y, params=params), 4,
                   device="cpu")
    path = str(tmp_path_factory.mktemp("trace") / "binary.txt")
    bst.save_model(path)
    return path


def _session(path, **kw):
    return PredictorSession(path, device="cpu", **kw)


def _post(url, payload, headers=None, timeout=60):
    h = {"Content-Type": "application/json"}
    h.update(headers or {})
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers=h)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, dict(resp.headers), json.loads(resp.read())
    except urllib.error.HTTPError as exc:
        return exc.code, dict(exc.headers), json.loads(exc.read())


def _get(url, timeout=30):
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.status, json.loads(resp.read())


# ---------------------------------------------------------------------------
# the span API
# ---------------------------------------------------------------------------

def test_span_api_nesting_and_sink(tmp_path, report):
    obs.enable(str(tmp_path / "telem"))
    obs.enable_trace()
    with obs.span("outer", trace_id="t-1", kind="test") as outer:
        assert obs.current_context() == ("t-1", outer.span_id)
        with obs.span("inner") as inner:
            assert inner.trace_id == "t-1"
            assert inner.parent_id == outer.span_id
    assert obs.current_context() == (None, None)
    obs.disable()
    events = report.load_events(str(tmp_path / "telem"))
    spans = [e for e in events if e.get("event") == "span"]
    assert [e["name"] for e in spans] == ["inner", "outer"]
    assert spans[0]["parent_id"] == spans[1]["span_id"]
    assert report.validate_events(events) == []
    t = report.trace_summary(events)
    assert t["spans"] == 2 and t["traces"] == 1


def test_trace_id_honors_and_sanitizes_seed():
    pytest.importorskip("jax")
    from lightgbm_tpu.obs import new_trace_id as jax_trace_id
    for seed in ("req-42", "a b;c\n", "x" * 500, "é/ü:1.2"):
        assert obs.new_trace_id(seed) == jax_trace_id(seed)
    assert obs.new_trace_id("") != obs.new_trace_id("")
    assert len(obs.new_trace_id("x" * 500)) == 64


def test_span_off_path_is_noop():
    assert not obs.span_record_enabled()
    assert obs.begin_span("nope") is None
    obs.end_span(None)
    assert obs.emit_span("nope", time.time(), 1.0, "t") is None


def test_build_counter():
    """The port counts its kernel builds (``ops/build.py``) where the JAX
    package counts XLA compiles."""
    from lightgbm_tpu_torch.obs import trace
    n0 = obs.compile_count()
    trace.note_build(1.5)
    assert obs.compile_count() == n0 + 1
    assert obs.compile_seconds() >= 1.5
    assert obs.install_recompile_hook()


# ---------------------------------------------------------------------------
# serving: header in, span tree out; the flight recorder
# ---------------------------------------------------------------------------

def test_http_trace_propagation_span_tree(binary_model, tmp_path, report):
    obs.enable(str(tmp_path / "telem"))
    obs.enable_trace()
    sess = _session(binary_model, max_batch=32)
    with PredictServer(sess) as server:
        code, headers, body = _post(
            server.url + "/predict", {"rows": np.zeros((6, 5)).tolist()},
            headers={"X-Request-Id": "req-e2e-1"})
        assert code == 200 and body["trace_id"] == "req-e2e-1"
        assert headers.get("X-Request-Id") == "req-e2e-1"
    sess.close()
    obs.disable()
    events = report.load_events(str(tmp_path / "telem"))
    assert report.validate_events(events) == []
    spans = [e for e in events if e.get("event") == "span"
             and e.get("trace_id") == "req-e2e-1"]
    root = next(e for e in spans if e["name"] == "serve/request")
    kids = {e["name"] for e in spans if e.get("parent_id") == root["span_id"]}
    assert {"serve/queue_wait", "serve/coalesce",
            "serve/device_execute"} <= kids
    assert root["attrs"]["status"] == 200
    acc = [e for e in events if e.get("event") == "serve_access"]
    assert any(e["trace_id"] == "req-e2e-1" and e["status"] == 200
               and e["path"] == "/predict" for e in acc)
    s = report.serve_summary(events)
    assert s["requests"] >= 1 and s["ok"] >= 1


def test_degradation_dumps_flight_and_fails_the_request(binary_model,
                                                        tmp_path,
                                                        monkeypatch):
    """A dead device flips the session degraded and dumps the ring (no
    host fallback: the request fails with 503)."""
    monkeypatch.setenv("LGBM_TPU_FLIGHT_DIR", str(tmp_path))
    obs.enable_trace()
    sess = _session(binary_model, max_batch=32, config={"verbose": -1,
                    "tpu_serve_reprobe_s": 0})

    def boom(forest, bins):
        raise RuntimeError("device backend died mid-flight")
    monkeypatch.setattr(sess, "_device_fn", boom)
    with PredictServer(sess) as server:
        code, _, body = _post(server.url + "/predict",
                              {"rows": np.zeros((3, 5)).tolist()},
                              headers={"X-Request-Id": "req-dead"})
        assert code == 503
    sess.close()
    dumps = sorted(tmp_path.glob("FLIGHT_r*.json"))
    assert dumps
    rec = json.loads(dumps[0].read_text())
    assert rec["reason"] == "serve_degraded"
    assert any(e.get("event") == "serve_degraded" for e in rec["events"])


def test_flight_ring_bounded_and_endpoint(binary_model):
    obs.enable_flight(8)
    for i in range(30):
        obs.emit_span(f"s{i}", time.time(), 0.1, "t-ring")
    snap = obs.flight_snapshot()
    assert len(snap) == 8 and snap[-1]["name"] == "s29"
    sess = _session(binary_model, max_batch=32)
    with PredictServer(sess) as server:
        _post(server.url + "/predict", {"rows": np.zeros((3, 5)).tolist()})
        code, fl = _get(server.url + "/debug/flight")
        assert code == 200 and fl["enabled"] is True
        assert fl["ring_len"] == 8
        assert any(e.get("event") == "span"
                   and e.get("name") == "serve/device_execute"
                   for e in fl["events"])
    sess.close()


def test_flight_env_zero_disables_training_ring(monkeypatch):
    monkeypatch.setenv("LGBM_TPU_FLIGHT", "0")
    rng = np.random.default_rng(2)
    X = rng.normal(size=(200, 3))
    y = (X[:, 0] > 0).astype(np.float64)
    lt.train({"objective": "binary", "num_leaves": 4, "verbose": -1,
              "tpu_health": "monitor"}, lt.Dataset(X, label=y), 1,
             device="cpu")
    assert not obs.flight_enabled()


# ---------------------------------------------------------------------------
# training spans, and the JAX package's exporter over the port's file
# ---------------------------------------------------------------------------

def test_training_iteration_spans_and_export(tmp_path, report,
                                             trace_export):
    rng = np.random.default_rng(1)
    X = rng.normal(size=(300, 4))
    y = (X[:, 0] > 0).astype(np.float64)
    params = {"objective": "binary", "num_leaves": 7, "verbose": -1,
              "tpu_telemetry": str(tmp_path / "telem"), "tpu_trace": True}
    lt.train(params, lt.Dataset(X, label=y, params=params), 3, device="cpu")
    obs.disable()
    obs.enable_trace(False)
    events = report.load_events(str(tmp_path / "telem"))
    assert report.validate_events(events) == []
    spans = [e for e in events if e.get("event") == "span"]
    iters = [e for e in spans if e["name"] == "train/iteration"]
    assert len(iters) == 3 and len({e["trace_id"] for e in iters}) == 1
    kids = [e for e in spans if e.get("parent_id") == iters[0]["span_id"]]
    assert any(e["name"] == "phase/tree growth" for e in kids)
    assert iters[0]["attrs"]["iteration"] == 0
    out = str(tmp_path / "out.trace.json")
    assert trace_export.main([str(tmp_path / "telem"), "--out", out]) == 0
    doc = json.load(open(out))
    xs = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert sum(1 for e in xs if e["name"] == "train/iteration") == 3
    assert min(e["ts"] for e in xs) == 0.0


def test_iteration_span_closed_on_health_abort(tmp_path, report):
    rng = np.random.default_rng(3)
    X = rng.normal(size=(200, 3))
    y = (X[:, 0] > 0).astype(np.float64)
    params = {"objective": "binary", "num_leaves": 7, "verbose": -1,
              "tpu_telemetry": str(tmp_path / "telem"), "tpu_trace": True}
    bst = lt.Booster(params=params, train_set=lt.Dataset(X, label=y),
                     device="cpu")
    obs.enable_health("strict")
    try:
        bst.update()

        def bad_fobj(preds, train_data):
            g = np.zeros(len(y))
            g[7] = np.nan
            return g, np.ones(len(y))
        with pytest.raises(obs.TrainingHealthError):
            bst.update(fobj=bad_fobj)
    finally:
        obs.enable_health("")
    assert obs.current_context() == (None, None)
    obs.disable()
    events = report.load_events(str(tmp_path / "telem"))
    iters = [e for e in events if e.get("event") == "span"
             and e["name"] == "train/iteration"]
    assert [e["attrs"]["iteration"] for e in iters] == [0, 1]


def test_serve_off_path_span_overhead(binary_model, monkeypatch):
    """Tracing off (the flight ring on, as a serving process has it), the
    span layer costs under 5% of the serving wall time."""
    from lightgbm_tpu_torch.obs import spans as sp
    spent = [0.0]
    orig_emit = sp.emit_span

    def timed_emit(*a, **kw):
        t0 = time.perf_counter()
        r = orig_emit(*a, **kw)
        spent[0] += time.perf_counter() - t0
        return r
    monkeypatch.setattr(sp, "emit_span", timed_emit)
    monkeypatch.setattr(obs, "emit_span", timed_emit)
    sess = _session(binary_model, max_batch=32, max_wait_ms=0.5)
    assert obs.flight_enabled()
    X = np.zeros((4, 5))
    sess.predict(X)
    t0 = time.perf_counter()
    for _ in range(60):
        sess.result(sess.submit(X), timeout=30)
    total = time.perf_counter() - t0
    sess.close()
    assert spent[0] < 0.05 * total, \
        f"span layer spent {spent[0]:.4f}s of {total:.4f}s serve wall"
