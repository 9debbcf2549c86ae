"""The port's C API (``lightgbm_tpu_torch/capi.py``) against the JAX
package's ``capi.py``: one call sequence through both on one tiny fixture
(``device_type=cpu`` for the port; the JAX side grows with its wave
grower through the Pallas interpreter, as tests/test_torch_train.py has
it) gives equal trees, equal leaf indices, and predictions, leaf values
and contributions within 1e-4, the tolerance tests/test_torch_train.py
uses for this configuration (each package adds its f32 partial sums in
its own order).  Also: handles, statuses and the last error; push-rows
datasets; custom gradients; the refit; the network functions on
``parallel/mesh.py NETWORK``; the device of a call without parameters."""
import numpy as np
import pytest

from lightgbm_tpu_torch import capi
from lightgbm_tpu_torch.parallel import mesh

P = ("objective=binary num_leaves=7 min_data_in_leaf=10 max_bin=63 "
     "learning_rate=0.2 verbose=-1")
N, F, ROUNDS = 400, 5, 3


@pytest.fixture(autouse=True)
def _one_cpu_thread():
    """One intra-op thread a test; restored after."""
    import torch
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _data():
    rng = np.random.default_rng(7)
    X = rng.normal(size=(N, F))
    X[:, 3] = np.round(X[:, 3])
    logit = X[:, 0] - 0.8 * X[:, 1] + X[:, 2] * X[:, 4]
    y = (logit + rng.logistic(size=N) > 0).astype(np.float32)
    return X, y


def _sequence(api, params):
    """The call sequence: every status must be 0.  Returns what it read."""
    X, y = _data()
    R = api.Ref

    def ok(rc):
        assert rc == 0, api.LGBM_GetLastError()
    out = {}
    ds, bst = R(), R()
    ok(api.LGBM_DatasetCreateFromMat(X, 1, N, F, 1, params, None, ds))
    ok(api.LGBM_DatasetSetField(ds, "label", y, N, 0))
    nd, nf = R(), R()
    ok(api.LGBM_DatasetGetNumData(ds, nd))
    ok(api.LGBM_DatasetGetNumFeature(ds, nf))
    out["dims"] = (nd.value, nf.value)
    ok(api.LGBM_BoosterCreate(ds, params, bst))
    for _ in range(ROUNDS):
        fin = R()
        ok(api.LGBM_BoosterUpdateOneIter(bst, fin))
    it, nm = R(), R()
    ok(api.LGBM_BoosterGetCurrentIteration(bst, it))
    ok(api.LGBM_BoosterNumberOfTotalModel(bst, nm))
    out["iters"] = (it.value, nm.value)
    for kind in (0, 1, 2, 3):
        n_out = R()
        ok(api.LGBM_BoosterCalcNumPredict(bst, N, kind, 0, -1, n_out))
        buf = np.zeros(n_out.value)
        got = R()
        ok(api.LGBM_BoosterPredictForMat(bst, X, 1, N, F, 1, kind, 0, -1,
                                         "", got, buf))
        assert got.value == n_out.value
        out[f"predict_{kind}"] = buf
    imp = np.zeros(F)
    ok(api.LGBM_BoosterFeatureImportance(bst, -1, 0, imp))
    out["split_importance"] = imp
    text_len, text = R(), R()
    ok(api.LGBM_BoosterSaveModelToString(bst, 0, -1, 0, text_len, text))
    out["trees"] = text.value.split("end of trees")[0]
    lv = R()
    ok(api.LGBM_BoosterGetLeafValue(bst, 1, 0, lv))
    out["leaf_1_0"] = lv.value
    # the loaded model predicts what the trainer does
    loaded, li = R(), R()
    ok(api.LGBM_BoosterLoadModelFromString(text.value, li, loaded))
    buf, got = np.zeros(N), R()
    ok(api.LGBM_BoosterPredictForMat(loaded, X, 1, N, F, 1, 1, 0, -1, "",
                                     got, buf))
    out["loaded_raw"] = buf
    # custom gradients: one more tree from the logloss gradients of the
    # current raw scores
    score = out["predict_1"]
    p = 1.0 / (1.0 + np.exp(-score))
    fin = R()
    ok(api.LGBM_BoosterUpdateOneIterCustom(
        bst, (p - y).astype(np.float32), (p * (1 - p)).astype(np.float32),
        fin))
    buf, got = np.zeros(N), R()
    ok(api.LGBM_BoosterPredictForMat(bst, X, 1, N, F, 1, 1, 0, -1, "", got,
                                     buf))
    out["custom_raw"] = buf
    ok(api.LGBM_BoosterRollbackOneIter(bst))
    ok(api.LGBM_BoosterRefit(bst, None, 0, 0))
    buf, got = np.zeros(N), R()
    ok(api.LGBM_BoosterPredictForMat(bst, X, 1, N, F, 1, 1, 0, -1, "", got,
                                     buf))
    out["refit_raw"] = buf
    # a push-rows dataset built in two blocks equals the matrix one
    pd, pn = R(), R()
    ok(api.LGBM_DatasetCreateByReference(ds, N, pd))
    ok(api.LGBM_DatasetPushRows(pd, X[:150].copy(), 1, 150, F, 0))
    ok(api.LGBM_DatasetPushRows(pd, X[150:].copy(), 1, N - 150, F, 150))
    ok(api.LGBM_DatasetGetNumData(pd, pn))
    out["pushed_rows"] = pn.value
    for h in (loaded, bst):
        ok(api.LGBM_BoosterFree(h))
    for h in (pd, ds):
        ok(api.LGBM_DatasetFree(h))
    assert api.LGBM_BoosterUpdateOneIter(bst, R()) == -1
    out["error"] = api.LGBM_GetLastError()
    return out


@pytest.fixture(scope="module")
def both():
    pytest.importorskip("jax")
    from lightgbm_tpu import capi as jcapi
    mp = pytest.MonkeyPatch()
    mp.setenv("LGBM_TPU_FORCE_WAVE", "interpret")
    try:
        ref = _sequence(jcapi, P)
    finally:
        mp.undo()
    return ref, _sequence(capi, P + " device_type=cpu")


def _tree_lines(text):
    """The structure lines of each tree (leaf values compared apart)."""
    keep = ("split_feature", "threshold", "decision_type", "left_child",
            "right_child", "leaf_count", "num_leaves")
    return [ln for ln in text.splitlines() if ln.startswith(keep)]


def _leaf_values(text):
    return np.concatenate([np.array(ln.split("=")[1].split(), float)
                           for ln in text.splitlines()
                           if ln.startswith("leaf_value=")])


def test_trees_equal(both):
    ref, port = both
    assert port["dims"] == ref["dims"] == (N, F)
    assert port["iters"] == ref["iters"] == (ROUNDS, ROUNDS)
    assert _tree_lines(port["trees"]) == _tree_lines(ref["trees"])
    np.testing.assert_allclose(_leaf_values(port["trees"]),
                               _leaf_values(ref["trees"]), rtol=0,
                               atol=1e-4)
    np.testing.assert_array_equal(port["predict_2"], ref["predict_2"])
    np.testing.assert_array_equal(port["split_importance"],
                                  ref["split_importance"])
    assert port["leaf_1_0"] == pytest.approx(ref["leaf_1_0"], abs=1e-4)


@pytest.mark.parametrize("key", ["predict_0", "predict_1", "predict_3",
                                 "loaded_raw", "custom_raw", "refit_raw"])
def test_predictions_within_tolerance(both, key):
    ref, port = both
    assert port[key].shape == ref[key].shape
    np.testing.assert_allclose(port[key], ref[key], rtol=0, atol=1e-4)


def test_push_rows_and_errors(both):
    ref, port = both
    assert port["pushed_rows"] == ref["pushed_rows"] == N
    assert "invalid _CBooster handle" in port["error"]
    assert "invalid _CBooster handle" in ref["error"]


def test_network_functions_record_the_topology():
    assert capi.LGBM_NetworkInit("10.0.0.1:13000,10.0.0.2", 13000, 30,
                                 2) == 0
    assert mesh.NETWORK["machines"] == "10.0.0.1:13000,10.0.0.2:13000"
    assert mesh.NETWORK["num_machines"] == 2
    assert capi.LGBM_NetworkFree() == 0
    assert mesh.NETWORK["machines"] == "" and mesh.NETWORK["num_machines"] == 1
    assert capi.LGBM_NetworkInitWithFunctions(2, 1, None, None) == 0
    assert mesh.NETWORK["rank"] == 1
    capi.LGBM_NetworkFree()


def test_device_of_a_call_without_parameters(tmp_path, monkeypatch):
    """A model file loads on the device the last parameter string named;
    before any, on the card (which this CPU-only machine lacks)."""
    import torch
    monkeypatch.setattr(capi, "_device", ["cuda"])
    X, y = _data()
    ds, bst, it = capi.Ref(), capi.Ref(), capi.Ref()
    assert capi.LGBM_DatasetCreateFromMat(X, 1, N, F, 1, P, None, ds) == 0
    capi.LGBM_DatasetSetField(ds, "label", y, N, 0)
    if not torch.cuda.is_available():
        assert capi.LGBM_BoosterCreate(ds, P, bst) == -1
        assert "torch.cuda.is_available() is False" in \
            capi.LGBM_GetLastError()
    assert capi.LGBM_BoosterCreate(ds, P + " device_type=cpu", bst) == 0
    capi.LGBM_BoosterUpdateOneIter(bst, capi.Ref())
    path = str(tmp_path / "m.txt")
    assert capi.LGBM_BoosterSaveModel(bst, 0, -1, path) == 0
    loaded = capi.Ref()
    assert capi.LGBM_BoosterCreateFromModelfile(path, it, loaded) == 0
    assert capi._get(loaded, capi._CBooster).b.device.type == "cpu"
    assert it.value == 1
