"""Booster prediction of the port: the device path (forced through
``_DEVICE_PREDICT_MIN_WORK``, as the JAX package's tests force theirs)
against the host walk and against the JAX package's device path on the
same model file, with and without training state; valid sets attached
after training started; early stopping against the JAX package."""
import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.boosting.gbdt import PredictorBase
from lightgbm_tpu_torch.core import forest as forest_mod

PARAMS = {"objective": "binary", "num_leaves": 15, "verbose": -1,
          "min_data_in_leaf": 5, "metric": ["binary_logloss", "auc"]}


def _data(n=1500, f=8, seed=0, nan=0.05):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f))
    X[rng.random(X.shape) < nan] = np.nan
    y = (np.nansum(X[:, :3], axis=1) + 0.3 * rng.logistic(size=n) > 0)
    return X, y.astype(np.float64)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    X, y = _data()
    bst = lt.train(PARAMS, lt.Dataset(X, label=y), 12, device="cpu")
    path = str(tmp_path_factory.mktemp("predict") / "model.txt")
    bst.save_model(path)
    return bst, path


@pytest.fixture
def device_path(monkeypatch):
    """Every predict above zero work takes the device path; returns the
    device forest call counts seen so far."""
    monkeypatch.setattr(PredictorBase, "_DEVICE_PREDICT_MIN_WORK", 1)
    monkeypatch.setattr(forest_mod, "calls", {"predict": 0, "leaf": 0})
    return forest_mod.calls


def _es(freq=1, margin=1.5):
    return {"pred_early_stop": True, "pred_early_stop_freq": freq,
            "pred_early_stop_margin": margin}


def test_routing_by_work(trained, monkeypatch):
    """Below 2,000,000 rows x trees the host walk runs, at or above it the
    device walk, as in the JAX package."""
    bst, _ = trained
    monkeypatch.setattr(forest_mod, "calls", {"predict": 0, "leaf": 0})
    X, _ = _data(n=300, seed=1)
    assert PredictorBase._DEVICE_PREDICT_MIN_WORK == 2_000_000
    bst.predict(X)
    bst.predict(X, pred_leaf=True)
    assert forest_mod.calls == {"predict": 0, "leaf": 0}
    monkeypatch.setattr(PredictorBase, "_DEVICE_PREDICT_MIN_WORK",
                        300 * 12)
    bst.predict(X)
    bst.predict(X, pred_leaf=True)
    bst.predict(X[:299])
    assert forest_mod.calls == {"predict": 1, "leaf": 1}


def test_trained_device_matches_host(trained, device_path):
    bst, _ = trained
    X, _ = _data(n=400, seed=2)
    host = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(PredictorBase, "_DEVICE_PREDICT_MIN_WORK", 10 ** 18)
        host["raw"] = bst.predict(X, raw_score=True)
        host["leaf"] = bst.predict(X, pred_leaf=True)
        host["es"] = bst.predict(X, raw_score=True, **_es())
    np.testing.assert_allclose(bst.predict(X, raw_score=True), host["raw"],
                               rtol=0, atol=1e-4)
    np.testing.assert_array_equal(bst.predict(X, pred_leaf=True),
                                  host["leaf"])
    np.testing.assert_allclose(bst.predict(X, raw_score=True, **_es()),
                               host["es"], rtol=0, atol=1e-6)
    assert device_path == {"predict": 2, "leaf": 1}
    # a window of iterations
    np.testing.assert_array_equal(
        bst.predict(X, pred_leaf=True, num_iteration=4, start_iteration=3),
        host["leaf"][:, 3:7])


def test_loaded_device_matches_host(trained, device_path):
    _, path = trained
    bst = lt.Booster(model_file=path, device="cpu")
    X, _ = _data(n=400, seed=3)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(PredictorBase, "_DEVICE_PREDICT_MIN_WORK", 10 ** 18)
        host = (bst.predict(X), bst.predict(X, pred_leaf=True),
                bst.predict(X, **_es()))
    np.testing.assert_allclose(bst.predict(X), host[0], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(bst.predict(X, pred_leaf=True), host[1])
    np.testing.assert_allclose(bst.predict(X, **_es()), host[2], rtol=0,
                               atol=1e-6)
    assert device_path == {"predict": 2, "leaf": 1}


def test_device_path_matches_reference_device_path(trained, device_path,
                                                   monkeypatch):
    """The port's device walk, trained and loaded, against the JAX
    package's device walk of the same model file."""
    pytest.importorskip("jax")
    import lightgbm_tpu as lgb
    from lightgbm_tpu.boosting.gbdt import PredictorBase as RefBase
    monkeypatch.setattr(RefBase, "_DEVICE_PREDICT_MIN_WORK", 1)
    bst, path = trained
    ref = lgb.Booster(model_file=path)
    loaded = lt.Booster(model_file=path, device="cpu")
    X, _ = _data(n=500, seed=4)
    ref.reset_parameter(_es(freq=2))
    want = {"raw": ref.predict(X, raw_score=True),
            "leaf": ref.predict(X, pred_leaf=True)}
    ref.reset_parameter({"pred_early_stop": False})
    want["plain"] = ref.predict(X, raw_score=True)
    for b in (bst, loaded):
        np.testing.assert_allclose(b.predict(X, raw_score=True), want["plain"],
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(b.predict(X, raw_score=True, **_es(2)),
                                   want["raw"], rtol=0, atol=1e-6)
        np.testing.assert_array_equal(b.predict(X, pred_leaf=True),
                                      want["leaf"])


def test_late_valid_set_gives_the_same_metrics():
    """A valid set attached after 3 iterations has the scores, and so the
    metrics, of one attached before the first."""
    X, y = _data(seed=5)
    Xv, yv = _data(n=500, seed=6)
    early = lt.Booster(PARAMS, lt.Dataset(X, label=y), device="cpu")
    train = lt.Dataset(X, label=y)
    late = lt.Booster(PARAMS, train, device="cpu")
    early.add_valid(lt.Dataset(Xv, label=yv, reference=early.train_set), "v")
    for _ in range(3):
        early.update()
        late.update()
    late.add_valid(lt.Dataset(Xv, label=yv, reference=train), "v")
    for _ in range(2):
        early.update()
        late.update()
    assert torch.equal(late._gbdt._valid_scores[0],
                       early._gbdt._valid_scores[0])
    assert late.eval_valid() == early.eval_valid()


def test_callbacks_and_best_iteration():
    X, y = _data(seed=7)
    Xv, yv = _data(n=400, seed=8)
    ds = lt.Dataset(X, label=y)
    # the valid labels are flipped: its loss only grows after round 1
    vs = lt.Dataset(Xv, label=1.0 - yv, reference=ds)
    seen, hist = [], {}
    bst = lt.train({**PARAMS, "metric": "binary_logloss"}, ds, 20,
                   valid_sets=[ds, vs], valid_names=["train", "flip"],
                   early_stopping_rounds=3, verbose_eval=False, device="cpu",
                   callbacks=[lambda env: seen.append(env.iteration),
                              lt.record_evaluation(hist)])
    assert bst.best_iteration == 1 and bst.num_trees() == 4
    assert seen == [0, 1, 2, 3]
    assert len(hist["flip"]["binary_logloss"]) == 4
    assert bst.best_score["flip"]["binary_logloss"] == \
        hist["flip"]["binary_logloss"][0]
    # predict and save default to the best iteration
    np.testing.assert_array_equal(bst.predict(Xv),
                                  bst.predict(Xv, num_iteration=1))
    assert bst.model_to_string().count("Tree=") == 1


@pytest.mark.parametrize("flip", [True, False])
def test_early_stopping_matches_reference(flip):
    """test_torch_train.py's fixture, where both packages grow identical
    trees, with a valid set: the same best_iteration and trees kept."""
    pytest.importorskip("jax")
    import lightgbm_tpu as lgb
    from test_torch_train import PARAMS as TRAIN_PARAMS
    from test_torch_train import _data as train_data
    X, y = train_data()
    Xv, yv = train_data(n=1000, seed=11)
    if flip:
        yv = 1.0 - yv
    params = {**TRAIN_PARAMS, "metric": "binary_logloss"}
    out = {}
    for pkg, kw in ((lgb, {}), (lt, {"device": "cpu"})):
        ds = pkg.Dataset(X, label=y)
        vs = pkg.Dataset(Xv, label=yv, reference=ds)
        mp = pytest.MonkeyPatch()
        mp.setenv("LGBM_TPU_FORCE_WAVE", "interpret")
        try:
            bst = pkg.train(params, ds, 5, valid_sets=[vs],
                            early_stopping_rounds=2, verbose_eval=False, **kw)
        finally:
            mp.undo()
        out[pkg.__name__] = (bst.best_iteration, bst.num_trees())
    assert out["lightgbm_tpu"] == out["lightgbm_tpu_torch"]
    assert out["lightgbm_tpu_torch"] == ((1, 3) if flip else (5, 5))
