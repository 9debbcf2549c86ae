"""Serving sessions (``lightgbm_tpu_torch/serve/session.py``, the batcher,
the HTTP front end) against the JAX package's ``serve/`` on the same model
files, on the CPU (``device="cpu"``).

The models are trained by the JAX package from numpy-seeded data (the
fixtures of tests/test_serve.py), saved, and loaded by both packages:

- port session vs JAX session within 1e-6 (the JAX tests' own bound) on
  binary with NaN, multiclass with categorical features, a lambdarank
  model under concurrent mixed sizes (top-k preserved), a loaded model's
  prediction early stop from the session's config; SHAP contributions
  within 1e-5 of the JAX session's;
- batching: coalescing, overload, deadlines, the input width, an
  idempotent close, pow2 buckets;
- no host fallback: with ``serve_device`` injected the requests fail,
  the session is degraded and answers nothing, and a later probe
  recovers it;
- the HTTP round trip (``X-Request-Id`` echoed, typed errors, ``/drift``,
  ``/debug/flight`` 501, a failed device batch as 503 with
  ``Retry-After``).
"""
import json
import math
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.robust import faults
from lightgbm_tpu_torch.serve import (DeadlineExceeded, DeviceFailed,
                                      PredictorSession, PredictServer,
                                      ServeOverloadError)
from lightgbm_tpu_torch.utils.log import LightGBMError

TIMEOUT = 60


@pytest.fixture(autouse=True)
def _disarm():
    faults.disarm()
    yield
    faults.disarm()


@pytest.fixture(scope="module")
def jlgb():
    pytest.importorskip("jax")
    import lightgbm_tpu
    return lightgbm_tpu


def _nan_matrix(rng, n, f_num, f_cat=0, cat_lo=-1, cat_hi=15):
    X = rng.normal(size=(n, f_num))
    X[rng.random((n, f_num)) < 0.08] = np.nan
    if f_cat:
        X = np.hstack([X, rng.integers(cat_lo, cat_hi, size=(n, f_cat)
                                       ).astype(np.float64)])
    return X


@pytest.fixture(scope="module")
def binary_model(jlgb, tmp_path_factory):
    """Binary model over NaN-heavy numerical columns (JAX-trained)."""
    rng = np.random.default_rng(0)
    X = _nan_matrix(rng, 1200, 6)
    y = (np.nan_to_num(X[:, 0]) + np.nan_to_num(X[:, 1]) > 0
         ).astype(np.float64)
    params = {"objective": "binary", "num_leaves": 15, "verbose": -1,
              "min_data_in_leaf": 5}
    bst = jlgb.train(params, jlgb.Dataset(X, label=y, params=params),
                     num_boost_round=25)
    path = str(tmp_path_factory.mktemp("tserve") / "binary.txt")
    bst.save_model(path)
    return path


@pytest.fixture(scope="module")
def multiclass_model(jlgb, tmp_path_factory):
    """Multiclass model with categorical columns (JAX-trained)."""
    rng = np.random.default_rng(1)
    X = _nan_matrix(rng, 1200, 4, f_cat=2, cat_lo=0, cat_hi=12)
    y = ((np.nan_to_num(X[:, 0]) > 0).astype(int)
         + (X[:, 4] > 5).astype(int)).astype(np.float64)
    params = {"objective": "multiclass", "num_class": 3, "num_leaves": 15,
              "verbose": -1, "min_data_in_leaf": 5}
    ds = jlgb.Dataset(X, label=y, categorical_feature=[4, 5], params=params)
    bst = jlgb.train(params, ds, num_boost_round=12)
    path = str(tmp_path_factory.mktemp("tserve") / "multi.txt")
    bst.save_model(path)
    return path


@pytest.fixture(scope="module")
def rank_model(jlgb, tmp_path_factory):
    """Lambdarank model over ragged queries (JAX-trained)."""
    rng = np.random.default_rng(9)
    sizes = np.concatenate([rng.integers(1, 40, size=30), [1, 100]])
    N = int(sizes.sum())
    X = rng.normal(size=(N, 10))
    y = rng.integers(0, 5, size=N).astype(np.float64)
    params = {"objective": "lambdarank", "metric": "ndcg",
              "num_leaves": 15, "min_data_in_leaf": 5, "verbose": -1}
    bst = jlgb.train(params, jlgb.Dataset(X, label=y, group=sizes,
                                          params=params),
                     num_boost_round=15)
    path = str(tmp_path_factory.mktemp("tserve") / "rank.txt")
    bst.save_model(path)
    return path


def _session(path, **kw):
    return PredictorSession(path, device="cpu", **kw)


# ---------------------------------------------------------------------------
# parity with the JAX package's session
# ---------------------------------------------------------------------------

def test_session_matches_jax_session_binary_nan(jlgb, binary_model):
    from lightgbm_tpu.serve import PredictorSession as JSession
    Xt = _nan_matrix(np.random.default_rng(2), 500, 6)
    with _session(binary_model, max_batch=128) as sess, \
            JSession(binary_model, max_batch=128) as ref:
        got, raw = sess.predict(Xt), sess.predict(Xt, raw_score=True)
        want, want_raw = ref.predict(Xt), ref.predict(Xt, raw_score=True)
        # above max_batch the port walks the input whole (no bucket);
        # within it a sync call pads to its bucket, as the JAX session's
        assert sess.stats()["buckets"] == []
        small, ref_small = sess.predict(Xt[:100]), ref.predict(Xt[:100])
        st, ref_st = sess.stats(), ref.stats()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(raw, want_raw, rtol=0, atol=1e-6)
    np.testing.assert_allclose(small, ref_small, rtol=0, atol=1e-6)
    # the stats both packages fill agree
    for key in ("requests", "ok", "batches", "rows", "padded_rows",
                "occupancy", "buckets", "degraded", "trees", "num_class",
                "num_features", "max_batch", "explain_max_batch"):
        assert st[key] == ref_st[key], key
    assert all(b & (b - 1) == 0 for b in st["buckets"])
    assert "compile_count" not in st and "aot" not in st


def test_session_matches_jax_session_multiclass_categorical(
        jlgb, multiclass_model):
    from lightgbm_tpu.serve import PredictorSession as JSession
    # unseen and negative categories take the sentinel bin
    Xt = _nan_matrix(np.random.default_rng(3), 400, 4, f_cat=2, cat_lo=-2,
                     cat_hi=20)
    with _session(multiclass_model, max_batch=128) as sess, \
            JSession(multiclass_model, max_batch=128) as ref:
        got = sess.predict(Xt)
        want = ref.predict(Xt)
        t = sess.submit(Xt[:77])
        got_async = sess.result(t, timeout=TIMEOUT)
    assert got.shape == (400, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got_async, want[:77], rtol=0, atol=1e-6)


def test_session_early_stop_follows_its_config(jlgb, binary_model):
    """A loaded model's ``pred_early_stop`` comes from the config the
    session is given (the Booster's after ``reset_parameter``), as in the
    JAX session."""
    from lightgbm_tpu.serve import PredictorSession as JSession
    knobs = {"pred_early_stop": True, "pred_early_stop_freq": 2,
             "pred_early_stop_margin": 0.5}
    Xt = _nan_matrix(np.random.default_rng(12), 300, 6)
    bst = lt.Booster(model_file=binary_model, device="cpu")
    bst.reset_parameter(knobs)
    jbst = jlgb.Booster(model_file=binary_model)
    jbst.reset_parameter(knobs)
    with PredictorSession(bst, config=bst.config, device="cpu") as sess, \
            JSession(jbst, config=jbst.config) as ref:
        assert sess.early_stop is not None
        got = sess.predict(Xt, raw_score=True)
        want = ref.predict(Xt, raw_score=True)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    full = lt.Booster(model_file=binary_model, device="cpu").predict(
        Xt, raw_score=True)
    assert np.abs(got - full).max() > 1e-3     # the stop took effect


def test_session_rank_topk_concurrent_mixed_sizes(jlgb, rank_model):
    """Per-query scoring requests of mixed sizes (1-120 documents) from
    concurrent clients coalesce, match the JAX session and keep its
    top-k scores."""
    from lightgbm_tpu.serve import PredictorSession as JSession
    sess = _session(rank_model, max_batch=64, max_wait_ms=1.0)
    ref = JSession(rank_model, max_batch=64, max_wait_ms=1.0)
    errs = []

    def client(seed):
        rng = np.random.default_rng(seed)
        for _ in range(5):
            n = int(rng.integers(1, 121))
            Xq = rng.normal(size=(n, 10))
            try:
                got = sess.result(sess.submit(Xq), timeout=TIMEOUT)
            except Exception as exc:  # noqa: BLE001 — reported below
                errs.append(("error", seed, repr(exc)))
                continue
            want = ref.predict(Xq)
            if float(np.abs(got - want).max()) > 1e-6:
                errs.append(("parity", seed, n))
            k = min(10, n)
            if float(np.abs(np.sort(got)[::-1][:k]
                            - np.sort(want)[::-1][:k]).max()) > 1e-6:
                errs.append(("topk", seed, n))

    threads = [threading.Thread(target=client, args=(s,), daemon=True)
               for s in range(5)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(TIMEOUT)
        st = sess.stats()
    finally:
        sess.close()
        ref.close()
    assert not any(t.is_alive() for t in threads)
    assert not errs, errs
    assert st["requests"] == 25 and not st["degraded"]
    assert all(b & (b - 1) == 0 for b in st["buckets"])


def test_concurrent_mixed_sizes_bounded_buckets(multiclass_model):
    """More client threads than cores, with a short switch interval: every
    answer right, and the shared counters lose no update."""
    import os
    import sys
    max_batch = 64
    n_threads = (os.cpu_count() or 4) + 2
    sess = _session(multiclass_model, max_batch=max_batch, max_wait_ms=1.0)
    host = lt.Booster(model_file=multiclass_model, device="cpu")
    errs, sent = [], []

    def client(seed):
        rng = np.random.default_rng(seed)
        for _ in range(4):
            n = int(rng.integers(1, max_batch + 30))   # some chunk
            Xi = _nan_matrix(rng, n, 4, f_cat=2, cat_lo=-1, cat_hi=16)
            got = sess.result(sess.submit(Xi), timeout=TIMEOUT)
            sent.append(n)
            diff = float(np.abs(got - host.predict(Xi)).max())
            if diff > 1e-6:
                errs.append(diff)

    threads = [threading.Thread(target=client, args=(s,), daemon=True)
               for s in range(n_threads)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(TIMEOUT)
        st = sess.stats()
    finally:
        sys.setswitchinterval(interval)
        sess.close()
    assert not any(t.is_alive() for t in threads)
    assert not errs, errs
    assert len(st["buckets"]) <= math.ceil(math.log2(max_batch)) + 1
    assert st["requests"] == st["ok"] == 4 * n_threads
    assert st["rows"] == sum(sent) and st["occupancy"] is not None
    assert sess.metrics.snapshot()["ok"] == 4 * n_threads


# ---------------------------------------------------------------------------
# batching: coalescing, backpressure, deadlines, input, close
# ---------------------------------------------------------------------------

def test_batcher_coalesces_small_requests(binary_model):
    rng = np.random.default_rng(5)
    with _session(binary_model, max_batch=64, max_wait_ms=60.0) as sess:
        tickets = [sess.submit(_nan_matrix(rng, 3, 6)) for _ in range(8)]
        outs = [sess.result(t, timeout=TIMEOUT) for t in tickets]
        st = sess.stats()
    assert all(o.shape == (3,) for o in outs)
    assert st["batches"] < 8 and st["rows"] == 24


def _slow(sess, monkeypatch, seconds):
    orig = sess._run_device

    def slow(bins):
        time.sleep(seconds)
        return orig(bins)

    monkeypatch.setattr(sess, "_run_device", slow)


def _taken(sess):
    """Wait (bounded) until the batcher's worker holds every queued row."""
    deadline = time.monotonic() + TIMEOUT
    while sess._batcher.queue_rows and time.monotonic() < deadline:
        time.sleep(0.005)
    assert sess._batcher.queue_rows == 0


def test_overload_raises_and_counts(binary_model, monkeypatch):
    rng = np.random.default_rng(6)
    sess = _session(binary_model, max_batch=8, max_wait_ms=0.0,
                    queue_depth=8)
    try:
        _slow(sess, monkeypatch, 0.4)
        t1 = sess.submit(_nan_matrix(rng, 8, 6))   # in flight
        _taken(sess)
        t2 = sess.submit(_nan_matrix(rng, 8, 6))   # fills the queue
        with pytest.raises(ServeOverloadError):
            sess.submit(_nan_matrix(rng, 8, 6))    # bounced, not buffered
        sess.result(t1, timeout=TIMEOUT)
        sess.result(t2, timeout=TIMEOUT)
        st = sess.stats()
    finally:
        sess.close()
    assert st["overloads"] == 1 and st["deadline_missed"] == 0
    assert sess.metrics.snapshot()["shed_by_priority"] == {"normal": 1}


def test_deadline_exceeded_in_queue(binary_model, monkeypatch):
    rng = np.random.default_rng(7)
    sess = _session(binary_model, max_batch=8, max_wait_ms=0.0)
    try:
        _slow(sess, monkeypatch, 0.3)
        t1 = sess.submit(_nan_matrix(rng, 8, 6))
        _taken(sess)
        t2 = sess.submit(_nan_matrix(rng, 4, 6), deadline_ms=1.0)
        sess.result(t1, timeout=TIMEOUT)
        with pytest.raises(DeadlineExceeded):
            sess.result(t2, timeout=TIMEOUT)
        st = sess.stats()
    finally:
        sess.close()
    assert st["deadline_missed"] == 1


def test_device_failure_fails_requests_never_the_host(binary_model):
    """The opposite of the JAX package's ``test_degrades_to_host_predictor``:
    with ``serve_device`` injected the requests fail, the session is
    degraded, nothing is answered, and a later probe recovers it."""
    rng = np.random.default_rng(8)
    Xt = _nan_matrix(rng, 50, 6)
    host = lt.Booster(model_file=binary_model, device="cpu").predict(Xt)
    sess = _session(binary_model, max_batch=32, config={
        "tpu_serve_reprobe_s": 0.2, "verbose": -1})
    try:
        faults.configure("serve_device:raise@n=-1")
        with pytest.raises(DeviceFailed, match="injected fault"):
            sess.predict(Xt)                       # sync path fails
        assert sess.stats()["degraded"]
        with pytest.raises(DeviceFailed, match="degraded"):
            sess.submit(Xt)                        # refused at submit
        time.sleep(0.25)
        with pytest.raises(DeviceFailed):          # the probe fails too
            sess.submit(Xt)
        st = sess.stats()
        assert st["degraded"] and st["ok"] == 0 and st["failed"] >= 2
        assert st["degraded_transitions"] == 1 and st["recoveries"] == 0
        probes = [e["ok"] for e in sess.events
                  if e["event"] == "serve_probe"]
        assert probes and not any(probes)
        faults.disarm()
        time.sleep(0.25)
        got = sess.result(sess.submit(Xt), timeout=TIMEOUT)  # probe heals
        np.testing.assert_allclose(got, host, rtol=0, atol=1e-6)
        st = sess.stats()
        assert not st["degraded"] and st["recoveries"] == 1
        # a batch that fails after it was queued fails its request
        faults.configure("serve_device:raise@n=1")
        t = sess.submit(Xt)
        with pytest.raises(DeviceFailed, match="injected fault"):
            sess.result(t, timeout=TIMEOUT)
        assert sess.stats()["degraded"]
    finally:
        faults.disarm()
        sess.close()


def test_input_width_checked(binary_model):
    with _session(binary_model) as sess:
        with pytest.raises(ValueError, match="number of features"):
            sess.predict(np.zeros((3, 4)))


def test_close_is_graceful_and_idempotent(binary_model):
    rng = np.random.default_rng(9)
    sess = _session(binary_model, max_batch=32, max_wait_ms=50.0)
    ticket = sess.submit(_nan_matrix(rng, 5, 6))
    sess.close()   # drains the queue before the worker exits
    assert sess.result(ticket, timeout=10).shape == (5,)
    sess.close()
    assert not sess._batcher._thread.is_alive()
    with pytest.raises(RuntimeError, match="closed"):
        sess.submit(_nan_matrix(rng, 5, 6))


def test_session_on_cuda_refuses_without_a_card(binary_model, monkeypatch):
    """``device=None`` means the card: without one the session refuses to
    start rather than serve from the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for device in (None, "cuda"):
        with pytest.raises(LightGBMError, match="device_type=cpu"):
            PredictorSession(binary_model, device=device)


def test_quality_sidecar_is_not_armed(binary_model, monkeypatch):
    """The JAX package writes a ``.quality.json`` beside a saved model;
    the port does not arm drift monitoring from it and says so once."""
    import os

    from lightgbm_tpu_torch.serve import session as session_mod
    assert os.path.isfile(binary_model + ".quality.json")
    seen = []
    monkeypatch.setattr(session_mod, "_drift_warned", False)
    monkeypatch.setattr(session_mod.log, "warning",
                        lambda msg, *a: seen.append(msg % a))
    for _ in range(2):
        _session(binary_model).close()
    assert len(seen) == 1 and "ROADMAP.md" in seen[0]


# ---------------------------------------------------------------------------
# explanation serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["binary", "multiclass"])
def test_explain_matches_jax_session(jlgb, binary_model, multiclass_model,
                                     which):
    from lightgbm_tpu.serve import PredictorSession as JSession
    rng = np.random.default_rng(11)
    if which == "binary":
        path, Xt = binary_model, _nan_matrix(rng, 40, 6)
    else:
        path, Xt = multiclass_model, _nan_matrix(rng, 40, 4, f_cat=2,
                                                 cat_lo=0, cat_hi=12)
    with _session(path, max_batch=64) as sess, \
            JSession(path, max_batch=64) as ref:
        got = sess.explain(Xt)
        got_async = sess.result(sess.submit_explain(Xt[:9]),
                                timeout=TIMEOUT)
        want = ref.explain(Xt)
        raw = sess.predict(Xt, raw_score=True)
        st = sess.stats()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got_async, got[:9], rtol=0, atol=1e-6)
    K = raw.shape[1] if raw.ndim > 1 else 1
    sums = got.reshape(len(Xt), K, -1).sum(axis=2)
    np.testing.assert_allclose(sums, raw.reshape(len(Xt), K), atol=1e-5)
    assert st["explain_armed"] and st["explain_requests"] == 2
    assert all(b & (b - 1) == 0 for b in st["explain_buckets"])


# ---------------------------------------------------------------------------
# HTTP front end
# ---------------------------------------------------------------------------

def _post(url, payload, timeout=TIMEOUT, headers=None):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read()), dict(resp.headers)
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read()), dict(exc.headers)


def _get(url, timeout=TIMEOUT):
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read().decode()


def test_http_server_roundtrip(multiclass_model):
    rng = np.random.default_rng(10)
    Xt = _nan_matrix(rng, 40, 4, f_cat=2, cat_lo=-1, cat_hi=16)
    want = lt.Booster(model_file=multiclass_model, device="cpu").predict(Xt)
    sess = _session(multiclass_model, max_batch=64)
    server = PredictServer(sess).start()
    try:
        code, body, hdr = _post(server.url + "/predict",
                                {"rows": Xt.tolist()},
                                headers={"X-Request-Id": "req 7"})
        assert code == 200 and body["rows"] == 40
        assert hdr["X-Request-Id"] == "req_7" == body["trace_id"]
        np.testing.assert_allclose(np.asarray(body["predictions"]), want,
                                   rtol=0, atol=1e-6)
        code, text = _get(server.url + "/health")
        health = json.loads(text)
        assert code == 200 and health["status"] == "ok"
        assert health["requests"] >= 1 and health["num_class"] == 3
        code, body, _ = _post(server.url + "/explain",
                              {"rows": Xt[:3].tolist()})
        assert code == 200 and np.asarray(body["contributions"]).shape \
            == (3, 3 * 7)
        assert json.loads(_get(server.url + "/drift")[1]) == {
            "drift": None, "armed": False}
        code, text = _get(server.url + "/debug/flight")
        assert code == 501 and "ROADMAP.md" in text
        # typed protocol errors, not 500s
        code, body, _ = _post(server.url + "/predict", {"rows": "nope"})
        assert code == 400 and body["error"] == "bad_request"
        assert _post(server.url + "/predict", {})[0] == 400
        assert _post(server.url + "/nothing", {})[0] == 404
        # a failed device batch is a 503 with Retry-After, never a host
        # answer
        faults.configure("serve_device:raise@n=1")
        code, body, hdr = _post(server.url + "/predict",
                                {"rows": Xt[:2].tolist()})
        assert code == 503 and body["error"] == "device_failed"
        assert "Retry-After" in hdr and "predictions" not in body
        health = json.loads(_get(server.url + "/health")[1])
        assert health["status"] == "degraded"
    finally:
        faults.disarm()
        server.stop(close_session=True)
    assert not sess._batcher._thread.is_alive()


@pytest.mark.cuda
def test_session_on_card_equals_cpu(tmp_path):
    """A session on the card answers what the same session on the CPU
    answers, bit for bit (the same f32 ops in the same order), through
    both the sync and the batched path."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CPU twin is every other test "
                    "of this file")
    rng = np.random.default_rng(0)
    X = _nan_matrix(rng, 1200, 6)
    y = (np.nan_to_num(X[:, 0]) + np.nan_to_num(X[:, 1]) > 0).astype(float)
    params = {"objective": "binary", "num_leaves": 15, "verbose": -1,
              "min_data_in_leaf": 5}
    path = str(tmp_path / "m.txt")
    lt.train(params, lt.Dataset(X, label=y), 25, device="cpu").save_model(
        path)
    Xt = _nan_matrix(rng, 500, 6)
    out = {}
    for dev in ("cpu", "cuda"):
        with PredictorSession(path, max_batch=128, device=dev) as sess:
            out[dev] = (sess.predict(Xt),
                        sess.result(sess.submit(Xt[:77]), timeout=TIMEOUT),
                        sess.stats())
    assert np.array_equal(out["cuda"][0], out["cpu"][0])
    assert np.array_equal(out["cuda"][1], out["cpu"][1])
    assert out["cuda"][2]["device"].startswith("cuda")
    assert not out["cuda"][2]["degraded"]
