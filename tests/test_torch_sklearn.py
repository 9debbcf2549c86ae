"""The port's scikit-learn estimators against the JAX package's, on the
same seeded inputs (twins of ``tests/test_sklearn.py``).  The port's
estimators run on the CPU through LightGBM's ``device_type`` parameter;
the JAX side trains on its wave grower through the Pallas interpreter
(``LGBM_TPU_FORCE_WAVE``).  Tolerances: labels, classes and best
iterations equal; ``predict`` and ``predict_proba`` within 1e-4 (the raw
score tolerance of ``test_torch_train.py``); evaluation curves within
1e-5."""
import numpy as np
import pytest

import lightgbm_tpu_torch as lt

PARAMS = dict(n_estimators=10, num_leaves=15, min_child_samples=5)
CPU = dict(device_type="cpu")
ATOL = 1e-4


def _xy_clf(n=600, seed=0, classes=2):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 5))
    if classes == 2:
        y = np.where(X[:, 0] + X[:, 1] > 0, "pos", "neg")
    else:
        y = (X[:, 0] > 0).astype(int) + (X[:, 1] > 0.5).astype(int)
    return X, y


@pytest.fixture(scope="module")
def jlgb():
    pytest.importorskip("jax")
    import lightgbm_tpu
    mp = pytest.MonkeyPatch()
    mp.setenv("LGBM_TPU_FORCE_WAVE", "interpret")
    yield lightgbm_tpu
    mp.undo()


def _both(jlgb, cls, fit_args, fit_kw=None, **params):
    """(JAX estimator, port estimator), each fitted on the same inputs."""
    ref = getattr(jlgb, cls)(**params).fit(*fit_args, **(fit_kw or {}))
    port = getattr(lt, cls)(**params, **CPU).fit(*fit_args,
                                                 **(fit_kw or {}))
    return ref, port


@pytest.fixture(scope="module")
def binary_pair(jlgb):
    X, y = _xy_clf(n=400)
    return (X, y) + _both(jlgb, "LGBMClassifier", (X, y), n_estimators=5,
                          num_leaves=7, min_child_samples=5)


def test_classifier_binary_string_labels(binary_pair):
    X, y, ref, clf = binary_pair
    assert list(clf.classes_) == list(ref.classes_) == ["neg", "pos"]
    pred = clf.predict(X)
    assert pred.dtype == np.asarray(y).dtype
    np.testing.assert_array_equal(pred, ref.predict(X))
    proba = clf.predict_proba(X)
    np.testing.assert_allclose(proba, ref.predict_proba(X), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(proba.sum(axis=1), 1.0, atol=1e-9)
    assert clf.score(X, y) > 0.9
    assert clf.n_features_ == 5
    np.testing.assert_array_equal(clf.feature_importances_,
                                  ref.feature_importances_)
    assert clf.booster_.device.type == "cpu"


def test_classifier_multiclass(jlgb):
    X, y = _xy_clf(n=400, classes=3, seed=1)
    ref, clf = _both(jlgb, "LGBMClassifier", (X, y), n_estimators=4,
                     num_leaves=7, min_child_samples=5)
    assert clf.n_classes_ == ref.n_classes_ == 3
    np.testing.assert_allclose(clf.predict_proba(X), ref.predict_proba(X),
                               rtol=0, atol=ATOL)
    assert clf.score(X, y) > 0.85


def test_classifier_class_weight(jlgb):
    X, y = _xy_clf(n=400, seed=9)
    ref, clf = _both(jlgb, "LGBMClassifier", (X, y),
                     class_weight={"neg": 1.0, "pos": 3.0}, n_estimators=4,
                     num_leaves=7, min_child_samples=5)
    np.testing.assert_allclose(clf.predict_proba(X), ref.predict_proba(X),
                               rtol=0, atol=ATOL)


def test_regressor_r2(jlgb):
    rng = np.random.default_rng(2)
    X = rng.normal(size=(600, 4))
    y = X[:, 0] * 2 + X[:, 1] + 0.1 * rng.normal(size=600)
    ref, reg = _both(jlgb, "LGBMRegressor", (X, y), n_estimators=5,
                     num_leaves=15, min_child_samples=5, learning_rate=0.4)
    np.testing.assert_allclose(reg.predict(X), ref.predict(X), rtol=0,
                               atol=ATOL)
    assert reg.score(X, y) > 0.8
    assert reg.objective is None  # constructor param untouched (clone)
    assert reg.objective_ == "regression"


def test_sklearn_clone_and_grid_search():
    from sklearn.base import clone
    from sklearn.model_selection import GridSearchCV
    X, y = _xy_clf(n=200, seed=3)
    base = lt.LGBMClassifier(**PARAMS, **CPU)
    c = clone(base)
    assert c.get_params() == base.get_params()
    assert c.get_params()["device_type"] == "cpu"
    gs = GridSearchCV(lt.LGBMClassifier(n_estimators=2, min_child_samples=5,
                                        **CPU),
                      {"num_leaves": [7, 15]}, cv=2, scoring="accuracy")
    gs.fit(X, y)
    assert gs.best_params_["num_leaves"] in (7, 15)
    assert gs.best_score_ > 0.8


def test_early_stopping_eval_set(jlgb):
    X, y = _xy_clf(n=400, seed=4)
    kw = dict(eval_set=[(X[300:], y[300:])], eval_metric="binary_logloss",
              early_stopping_rounds=3)
    ref, clf = _both(jlgb, "LGBMClassifier", (X[:300], y[:300]), kw,
                     n_estimators=20, num_leaves=7, min_child_samples=5,
                     learning_rate=1.0)
    assert clf.best_iteration_ == ref.best_iteration_ >= 1
    got = clf.evals_result_["valid_0"]["binary_logloss"]
    want = ref.evals_result_["valid_0"]["binary_logloss"]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_ranker_ndcg_improves(jlgb):
    rng = np.random.default_rng(5)
    n_q, per_q = 40, 12
    n = n_q * per_q
    X = rng.normal(size=(n, 6))
    rel = np.clip((X[:, 0] * 1.5 + 0.3 * rng.normal(size=n)).astype(int)
                  % 4, 0, 3)
    group = np.full(n_q, per_q)
    kw = dict(group=group, eval_set=[(X, rel)], eval_group=[group],
              eval_at=(3,))
    ref, rk = _both(jlgb, "LGBMRanker", (X, rel), kw, n_estimators=5,
                    num_leaves=7, min_child_samples=3)
    res = rk.evals_result_["valid_0"]
    key = next(k for k in res if "ndcg" in k)
    assert res[key][-1] > res[key][0], res[key]
    np.testing.assert_allclose(res[key], ref.evals_result_["valid_0"][key],
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(rk.predict(X), ref.predict(X), rtol=0,
                               atol=ATOL)


def test_ranker_requires_group():
    X, y = _xy_clf(n=100, seed=6)
    with pytest.raises(ValueError, match="group"):
        lt.LGBMRanker(**CPU).fit(X, (np.asarray(y) == "pos").astype(int))


def test_unfitted_raises():
    with pytest.raises(lt.LightGBMError):
        lt.LGBMClassifier(**CPU).predict(np.zeros((2, 3)))


def test_kwargs_passthrough():
    X, y = _xy_clf(n=300, seed=7)
    clf = lt.LGBMClassifier(max_bin=63, n_estimators=3, num_leaves=7,
                            min_child_samples=5, **CPU)
    assert clf.get_params()["max_bin"] == 63
    clf.fit(X, y)
    assert clf.score(X, y) > 0.8


def test_default_device_is_the_card(monkeypatch):
    """Without ``device_type`` an estimator trains on ``cuda``, and
    without a card that raises (no silent CPU run)."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X, y = _xy_clf(n=100, seed=6)
    with pytest.raises(lt.LightGBMError, match="cuda"):
        lt.LGBMClassifier(n_estimators=2).fit(X, y)


def test_callable_eval_metric(jlgb):
    rng = np.random.default_rng(17)
    X = rng.normal(size=(400, 5))
    y = X[:, 0] * 2 + rng.normal(size=400) * 0.1

    def rmsle_like(y_true, y_pred):
        return ("custom_rmse",
                float(np.sqrt(np.mean((y_true - y_pred) ** 2))), False)

    calls = []

    def spy(y_true, y_pred):
        calls.append(len(y_pred))
        return [rmsle_like(y_true, y_pred)]

    params = dict(n_estimators=4, num_leaves=7, min_child_samples=5,
                  verbose=-1)
    reg = lt.LGBMRegressor(**params, **CPU)
    reg.fit(X, y, eval_set=[(X[:100], y[:100])], eval_metric=spy)
    assert calls and all(c == 100 for c in calls)
    ref = jlgb.LGBMRegressor(**params)
    ref.fit(X, y, eval_set=[(X[:100], y[:100])], eval_metric=rmsle_like)
    np.testing.assert_allclose(reg.evals_result_["valid_0"]["custom_rmse"],
                               ref.evals_result_["valid_0"]["custom_rmse"],
                               rtol=0, atol=1e-5)
    reg2 = lt.LGBMRegressor(n_estimators=2, num_leaves=7,
                            min_child_samples=5, verbose=-1, **CPU)
    reg2.fit(X, y, eval_set=[(X[:100], y[:100])],
             eval_metric=["l1", rmsle_like])
    assert "l1" in reg2.evals_result_["valid_0"]
    assert "custom_rmse" in reg2.evals_result_["valid_0"]


def test_classifier_callable_eval_metric_gets_probabilities():
    rng = np.random.default_rng(18)
    X = rng.normal(size=(400, 4))
    y = (X[:, 0] > 0).astype(int)
    seen = {}

    def check_probs(y_true, y_pred):
        seen["range"] = (float(y_pred.min()), float(y_pred.max()))
        return "dummy", 0.0, False

    clf = lt.LGBMClassifier(n_estimators=3, num_leaves=7,
                            min_child_samples=5, verbose=-1, **CPU)
    clf.fit(X, y, eval_set=[(X, y)], eval_metric=check_probs)
    lo, hi = seen["range"]
    assert 0.0 <= lo and hi <= 1.0  # transformed, not raw margins
