"""The port's drift and quality plane (``obs/drift.py``,
``serve/quality.py``) against the JAX package's (twins of
``tests/test_drift.py``).

The profile of a port-trained model is the JAX package's for the same
rows: bin occupancy integer-equal (the port counts it on the training
device with ``torch.bincount``), and, given the same raw scores, the
prediction histogram, mean, standard deviation and training AUC within
1e-12.  The monitor's PSI/KS and the tracker's window scores are within
1e-12 of the JAX package's on the same traffic.  The serving surfaces
(session stats, ``/metrics``, ``/drift``, the registry's post-swap
watch) and the event schemas are the JAX package's.  The online-loop
case waits for ROADMAP.md item 6."""
import json
import os
import urllib.request

import numpy as np
import pytest

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import obs
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.obs.drift import (DriftMonitor, DriftSketch,
                                          QualityProfile, bin_features,
                                          compute_occupancy,
                                          device_occupancy, profile_path)
from lightgbm_tpu_torch.serve import (ModelRegistry, PredictorSession,
                                      PredictServer, parse_prometheus)
from lightgbm_tpu_torch.serve.metrics import render_prometheus
from lightgbm_tpu_torch.serve.quality import QualityTracker

P = {"objective": "binary", "num_leaves": 7, "min_data_in_leaf": 5,
     "verbose": -1}
TOL = 1e-12


@pytest.fixture(autouse=True)
def _obs_clean():
    yield
    obs.disable()
    obs.enable_flight(0)
    obs.reset()


def _data():
    rng = np.random.default_rng(7)
    X = rng.normal(size=(600, 6))
    X[rng.random(X.shape) < 0.03] = np.nan
    y = (np.nan_to_num(X[:, 0]) + 0.5 * np.nan_to_num(X[:, 1]) > 0
         ).astype(np.float64)
    return X, y


@pytest.fixture(scope="module")
def jdrift():
    pytest.importorskip("jax")
    from lightgbm_tpu.obs import drift
    return drift


@pytest.fixture(scope="module")
def drift_model(tmp_path_factory):
    """A port-trained binary model saved with its sidecar, and its
    training rows."""
    X, y = _data()
    bst = lt.train(P, lt.Dataset(X, label=y, params=P), 5, device="cpu",
                   keep_training_booster=True)
    path = str(tmp_path_factory.mktemp("drift") / "model.txt")
    bst.save_model(path)
    return path, bst, X, y


@pytest.fixture(scope="module")
def jax_model(tmp_path_factory):
    """The JAX package's model on the same rows, with its sidecar."""
    pytest.importorskip("jax")
    import lightgbm_tpu as jlgb
    X, y = _data()
    mp = pytest.MonkeyPatch()
    mp.setenv("LGBM_TPU_FORCE_WAVE", "interpret")
    try:
        bst = jlgb.train(P, jlgb.Dataset(X, label=y, params=P), 5)
    finally:
        mp.undo()
    path = str(tmp_path_factory.mktemp("jdrift") / "model.txt")
    bst.save_model(path)
    return path, bst


def _cfg(**over):
    base = dict(P, tpu_serve_max_batch=64, tpu_serve_max_wait_ms=1.0,
                tpu_serve_canary_rows=16, tpu_serve_canary_probes=2,
                tpu_serve_rollback_watch_s=0.0, tpu_serve_reprobe_s=0.0,
                tpu_drift_sample_rate=1.0, tpu_drift_min_rows=64)
    base.update(over)
    return Config.from_params(base)


def _shifted(n=256, seed=11):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, 6)) * 2.5 + 1.5


# ---------------------------------------------------------------------
# the reference profile
# ---------------------------------------------------------------------

def test_profile_sidecar_written_and_roundtrips(drift_model, jax_model):
    path, _, X, _ = drift_model
    prof = QualityProfile.load(profile_path(path))
    assert len(prof.features) == X.shape[1]
    for rec in prof.features:
        assert sum(rec["counts"]) == X.shape[0]
        assert not rec["categorical"]
    assert sum(prof.pred["counts"]) == X.shape[0]
    assert len(prof.pred["counts"]) == len(prof.pred["edges"]) + 1
    assert prof.meta["rows"] == X.shape[0]
    assert 0.5 < prof.meta["train_auc"] <= 1.0
    assert QualityProfile.from_dict(prof.to_dict()).to_dict() \
        == prof.to_dict()
    # the JAX package's sidecar for the same rows: the same features,
    # edges and occupancy (the scores differ at f32 rounding, so their
    # histogram is compared on the same scores below)
    with open(profile_path(jax_model[0])) as fh:
        want = json.load(fh)
    assert prof.features == want["features"]
    assert prof.meta["rows"] == want["meta"]["rows"]


def test_profile_equals_jax_on_the_same_scores(drift_model, jax_model,
                                               jdrift):
    _, bst, _, y = drift_model
    _, jbst = jax_model
    raw = jbst._raw_train_score()
    ds, jds = bst._gbdt.train_ds, jbst._gbdt.train_ds
    got = QualityProfile.from_training(
        ds, raw_score=raw, label=y,
        occupancy=device_occupancy(ds, bst._gbdt._train_bins_dev()))
    want = jdrift.QualityProfile.from_training(jds, raw_score=raw, label=y)
    assert got.features == want.features
    np.testing.assert_allclose(got.pred["edges"], want.pred["edges"],
                               rtol=0, atol=TOL)
    assert got.pred["counts"] == want.pred["counts"]
    for k in ("mean", "std"):
        assert abs(got.pred[k] - want.pred[k]) <= TOL
    assert abs(got.meta["train_auc"] - want.meta["train_auc"]) <= TOL


def test_bin_features_matches_training_occupancy(drift_model):
    path, _, X, _ = drift_model
    prof = QualityProfile.load(profile_path(path))
    recs = prof.numeric_records()
    assert recs
    for rec, b in zip(recs, bin_features(X, recs)):
        got = np.bincount(b, minlength=rec["num_bin"])
        assert np.array_equal(got, np.asarray(rec["counts"])), rec["name"]


def test_device_occupancy_matches_chunked_scan(drift_model):
    """The device count equals the host scan in any chunking, also
    through EFB bundles (a sparse one-hot block bundles)."""
    _, bst, _, _ = drift_model
    gb = bst._gbdt
    dev = device_occupancy(gb.train_ds, gb._train_bins_dev())
    for chunk in (37, 1 << 20):
        for a, b in zip(compute_occupancy(gb.train_ds, chunk_rows=chunk),
                        dev):
            assert np.array_equal(a, b)
    rng = np.random.default_rng(3)
    Xb = np.zeros((500, 8))
    Xb[np.arange(500), rng.integers(0, 8, 500)] = rng.random(500) + 0.5
    yb = (Xb[:, 0] > 0).astype(float)
    bb = lt.train(P, lt.Dataset(Xb, label=yb, params=P), 2, device="cpu")
    gb = bb._gbdt
    assert gb.train_ds.bundle is not None
    for a, b in zip(compute_occupancy(gb.train_ds),
                    device_occupancy(gb.train_ds, gb._train_bins_dev())):
        assert np.array_equal(a, b)


# ---------------------------------------------------------------------
# distances, sketches and the monitor against the JAX package's
# ---------------------------------------------------------------------

def test_distances_equal_jax(jdrift):
    from lightgbm_tpu_torch.obs import drift
    rng = np.random.default_rng(0)
    ref = rng.integers(0, 50, size=255).astype(np.int64)
    live = rng.integers(0, 5, size=255).astype(np.int64)
    for fn in ("psi", "ks"):
        assert getattr(drift, fn)(ref, live) == getattr(jdrift, fn)(ref,
                                                                   live)
    for a, b in zip(drift.coarsen(ref, live), jdrift.coarsen(ref, live)):
        assert np.array_equal(a, b)
    p = np.array([10, 20, 30, 40], float)
    assert drift.psi(p, p) == 0.0 and drift.ks(p, p) == 0.0
    assert 0.0 < drift.psi(p, [11, 19, 31, 39]) < drift.psi(p,
                                                           [40, 30, 20, 10])
    vals = rng.choice([-1.2, -0.4, 0.1, 0.9, 2.0], size=500)
    assert drift._pred_histogram(vals) == jdrift._pred_histogram(vals)


def test_sketch_merge_matches_single_accumulator_oracle(drift_model):
    path, bst, X, _ = drift_model
    prof = QualityProfile.load(profile_path(path))
    scores = bst.predict(X, raw_score=True)
    a, b, oracle = (DriftSketch(prof) for _ in range(3))
    a.observe_features(X[:220])
    a.observe_preds(scores[:220])
    b.observe_features(X[220:])
    b.observe_preds(scores[220:])
    oracle.observe_features(X)
    oracle.observe_preds(scores)
    a.merge(b)
    sa, so = a.snapshot(), oracle.snapshot()
    assert (sa["feat_rows"], sa["pred_rows"]) == (so["feat_rows"],
                                                  so["pred_rows"])
    assert np.array_equal(sa["pred_counts"], so["pred_counts"])
    for ca, co in zip(sa["feat_counts"], so["feat_counts"]):
        assert np.array_equal(ca, co)


def test_monitor_iid_quiet_shift_breaches(drift_model, tmp_path,
                                          monkeypatch, jdrift):
    path, bst, X, _ = drift_model
    monkeypatch.setenv("LGBM_TPU_FLIGHT_DIR", str(tmp_path))
    obs.enable_flight(64)
    prof = QualityProfile.load(profile_path(path))
    jprof = jdrift.QualityProfile.load(profile_path(path))
    for rows in (X, _shifted(256)):
        raw = bst.predict(rows, raw_score=True)
        mon = DriftMonitor(prof, _cfg())
        mon.observe(rows, raw)
        got = mon.maybe_check(force=True)
        jmon = jdrift.DriftMonitor(jprof, _cfg())
        jmon.observe(rows, raw)
        want = jmon.maybe_check(force=True)
        for k in ("psi_max", "psi_mean", "ks_max", "pred_psi", "pred_ks"):
            assert abs(got[k] - want[k]) <= TOL, k
        assert (mon.breach is None) == (jmon.breach is None)
    assert got["psi_max"] > mon.psi_warn
    assert "feature_psi" in mon.breach["kinds"] and mon.breach_count == 1
    dumps = list(tmp_path.glob("FLIGHT_r*.json"))
    assert dumps, "a drift breach dumps the flight recorder"
    rec = json.loads(dumps[0].read_text())
    assert rec["reason"].startswith("drift_psi:")
    st = mon.status()
    assert st["armed"] and st["breaches"] == 1
    assert "per_feature" not in st["scores"]


def test_monitor_arming_and_kill_switch(drift_model, tmp_path,
                                        monkeypatch):
    path, bst, X, _ = drift_model
    assert DriftMonitor.maybe_load(path, _cfg()) is not None
    monkeypatch.setenv("LGBM_TPU_DRIFT_SAMPLE_RATE", "0.25")
    mon = DriftMonitor.maybe_load(path, _cfg())
    assert mon.sample_rate == 0.25
    for _ in range(16):                      # 16 batches of 32 rows
        mon.observe(X[:32], np.zeros(32))
    st = mon.status()
    assert st["pred_rows"] == 512 and st["feat_rows"] == 128
    monkeypatch.setenv("LGBM_TPU_DRIFT", "0")
    assert DriftMonitor.maybe_load(path, _cfg()) is None
    monkeypatch.delenv("LGBM_TPU_DRIFT")
    assert DriftMonitor.maybe_load(bst, _cfg()) is None
    lone = tmp_path / "bare.txt"
    lone.write_text("tree\n")
    (tmp_path / "bare.txt.quality.json").write_text("{not json")
    assert DriftMonitor.maybe_load(str(lone), _cfg()) is None


def test_no_sidecar_without_quality_profile(drift_model, tmp_path):
    _, bst, _, _ = drift_model
    bst.reset_parameter({"tpu_quality_profile": False})
    try:
        bst.save_model(str(tmp_path / "m.txt"))
    finally:
        bst.reset_parameter({"tpu_quality_profile": True})
    assert not os.path.exists(profile_path(str(tmp_path / "m.txt")))


# ---------------------------------------------------------------------
# the serving surfaces
# ---------------------------------------------------------------------

def test_session_drift_stats_and_prometheus(drift_model):
    path, _, X, _ = drift_model
    sess = PredictorSession(path, max_batch=64, max_wait_ms=0.5,
                            config=_cfg(), device="cpu")
    try:
        for s in range(0, 256, 64):
            sess.predict(X[s:s + 64])
        sess._drift.maybe_check(force=True)
        st = sess.stats()
        dr = st["drift"]
        assert dr["armed"] and dr["feat_rows"] >= 256
        parsed = parse_prometheus(render_prometheus(sess))
        assert parsed['tpu_serve_drift_score{model="default",version="0",'
                      'kind="psi_max"}'] == dr["scores"]["psi_max"]
        assert parsed['tpu_serve_drift_rows{model="default",version="0",'
                      'kind="pred"}'] == dr["pred_rows"]
        assert parsed['tpu_serve_drift_breach{model="default",'
                      'version="0"}'] == 0.0
    finally:
        sess.close()
    off = PredictorSession(path, config=_cfg(tpu_drift=False), device="cpu")
    try:
        off.predict(X[:8])
        assert off.stats()["drift"] is None
        assert "tpu_serve_drift_score" not in render_prometheus(off)
    finally:
        off.close()


def test_registry_drift_endpoint_and_postswap(drift_model, tmp_path):
    """``/drift`` over HTTP, and a latched breach that annotates the
    post-swap watch by default and rolls back on the opt-in."""
    path, bst, X, _ = drift_model
    p2 = dict(P, learning_rate=0.2)
    b2 = lt.train(p2, lt.Dataset(X, label=(np.nan_to_num(X[:, 0]) > 0
                                            ).astype(float), params=p2),
                  4, device="cpu")
    m2 = str(tmp_path / "m2.txt")
    b2.save_model(m2)
    for optin in (False, True):
        reg = ModelRegistry(config=_cfg(tpu_serve_rollback_on_drift=optin),
                            n_replicas=1, device="cpu")
        server = None
        try:
            reg.add_model("default", path)
            if not optin:
                t = reg.submit(X[:120])
                reg.result(t, timeout=30)
                server = PredictServer(reg).start()
                with urllib.request.urlopen(server.url + "/drift",
                                            timeout=30) as r:
                    body = json.loads(r.read())
                assert body["models"]["default"]["drift"]["armed"]
                assert body["models"]["default"]["quality_breach"] is None
            reg.swap("default", m2)
            mon = reg.resolve(None).router.drift
            assert mon.model_version == 2
            mon.observe(_shifted(256), np.zeros(256))
            assert mon.maybe_check(force=True)["psi_max"] > mon.psi_warn
            rep = reg.check_postswap("default")
            if optin:
                assert rep["reason"].startswith("auto: drift_psi")
                assert rep["to_version"] == 1
            else:
                assert rep["status"] in ("watching", "clear")
                assert "feature_psi" in rep["drift_breach"]["kinds"]
                assert reg.models()[0]["live_version"] == 2
        finally:
            if server is not None:
                server.stop()
            reg.close()


def test_quality_tracker_windows_and_breach(drift_model):
    pytest.importorskip("jax")
    from lightgbm_tpu.serve.quality import QualityTracker as JTracker
    path, bst, X, y = drift_model
    prof = QualityProfile.load(profile_path(path))

    class _Latch:
        note = None

        def note_quality_breach(self, name, info):
            self.note = (name, dict(info))

    latch = _Latch()

    def fn(rows):
        return bst.predict(rows, raw_score=True)
    tr = QualityTracker(fn, prof, config=_cfg(tpu_quality_window=200),
                        registry=latch, model_name="default")
    jt = JTracker(fn, prof, config=_cfg(tpu_quality_window=200))
    for t in (tr, jt):
        t.add(X[:150], y[:150])
        t.add(X[150:300], y[150:300])
        t.add(X[300:500], 1.0 - y[300:500])
    assert tr.windows == jt.windows == 2
    for k in ("auc", "auc_delta", "cal_err", "ndcg"):
        assert abs(tr.last[k] - jt.last[k]) <= TOL, k
    assert tr.last["breach"] and tr.breaches == 1
    assert latch.note[0] == "default"
    assert latch.note[1]["auc_delta"] == tr.last["auc_delta"]


def test_drift_events_validate_and_summarize(drift_model, tmp_path):
    pytest.importorskip("jax")
    from lightgbm_tpu.obs.report import (drift_summary, load_events,
                                         validate_events)
    path, bst, X, y = drift_model
    obs.enable(str(tmp_path / "telem"))
    try:
        prof = QualityProfile.load(profile_path(path))
        mon = DriftMonitor(prof, _cfg())
        mon.observe(X, bst.predict(X, raw_score=True))
        mon.maybe_check(force=True)
        Xs = _shifted(2048)
        mon.observe(Xs, bst.predict(Xs, raw_score=True))
        mon.maybe_check(force=True)
        tr = QualityTracker(lambda rows: bst.predict(rows, raw_score=True),
                            prof, config=_cfg(tpu_quality_window=200))
        tr.add(X[:200], y[:200])
    finally:
        obs.disable()
    events = load_events(str(tmp_path / "telem"))
    assert validate_events(events) == []
    d = drift_summary(events)
    assert d["snapshots"] == 2 and d["drift_breaches"] == 1
    assert d["quality_windows"] == 1 and d["quality_breaches"] == 0
    assert d["last_window"]["auc"] > 0.8
