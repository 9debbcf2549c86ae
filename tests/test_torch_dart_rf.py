"""DART and RF: the port against the JAX package (its wave grower through
the Pallas interpreter, LGBM_TPU_FORCE_WAVE) on seeded problems.

DART: the default rescale, ``xgboost_dart_mode``, ``uniform_drop`` and
``max_drop``, with trees dropped every iteration (``skip_drop=0``).  RF:
binary, and regression_l1 with its leaf refit against the init score.

Tolerances: trees identical (features, thresholds, children); leaf
values within 2e-5 relative, 1e-6 absolute (f32 histogram sums in another
order move a leaf by up to 7.6e-6 of itself here: RF leaves are unshrunk)
and predictions within 1e-6 (DART) and 2e-6 (RF, whose unshrunk leaves
pass that difference on undamped: 1.02e-6 seen on the binary case)."""
import numpy as np
import pytest

import lightgbm_tpu_torch as lt

BASE = {"num_leaves": 15, "max_bin": 63, "min_data_in_leaf": 20,
        "verbose": -1, "seed": 1}
ROUNDS = 5


def _binary(n=1200, f=6, seed=1):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f))
    logit = X[:, 0] - 0.8 * X[:, 1] + X[:, 2] * X[:, 3]
    return X, (logit + rng.logistic(size=n) > 0).astype(np.float64)


def _regression(n=1200, f=6, seed=2):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f))
    return X, 2.0 * X[:, 0] - X[:, 1] ** 2 + 0.3 * rng.standard_t(3, size=n)


@pytest.fixture(scope="module")
def lgb():
    pytest.importorskip("jax")
    mp = pytest.MonkeyPatch()
    mp.setenv("LGBM_TPU_FORCE_WAVE", "interpret")
    import lightgbm_tpu
    yield lightgbm_tpu
    mp.undo()


def _same_trees(ref_models, port_models):
    assert len(ref_models) == len(port_models)
    for rt, pt in zip(ref_models, port_models):
        assert rt.num_leaves == pt.num_leaves
        nn = rt.num_leaves - 1
        np.testing.assert_array_equal(rt.split_feature[:nn],
                                      pt.split_feature[:nn])
        np.testing.assert_array_equal(rt.threshold[:nn], pt.threshold[:nn])
        np.testing.assert_array_equal(rt.left_child[:nn], pt.left_child[:nn])
        np.testing.assert_allclose(pt.leaf_value[:rt.num_leaves],
                                   rt.leaf_value[:rt.num_leaves],
                                   rtol=2e-5, atol=1e-6)


def _both(lgb, params, X, y):
    ref = lgb.train(params, lgb.Dataset(X, label=y), ROUNDS)
    port = lt.train(params, lt.Dataset(X, label=y), ROUNDS, device="cpu")
    return ref, port


@pytest.mark.parametrize("knobs", [
    {},
    {"xgboost_dart_mode": True},
    {"uniform_drop": True},
    {"max_drop": 1},
], ids=["default", "xgboost_dart_mode", "uniform_drop", "max_drop"])
def test_dart_matches_reference(lgb, knobs):
    X, y = _binary()
    params = {**BASE, "objective": "binary", "boosting": "dart",
              "drop_rate": 0.5, "skip_drop": 0.0, "learning_rate": 0.3,
              **knobs}
    ref, port = _both(lgb, params, X, y)
    assert port._gbdt.drops[0] == 0 and sum(port._gbdt.drops) > 0
    np.testing.assert_allclose(port._gbdt.tree_weight,
                               ref._gbdt.tree_weight, rtol=0, atol=1e-12)
    _same_trees(ref._gbdt.models, port._gbdt.models)
    np.testing.assert_allclose(port.predict(X), ref.predict(X), rtol=0,
                               atol=1e-6)
    # the training score follows the rescales: it is the forest's raw score
    np.testing.assert_allclose(port._gbdt._train_score.numpy(),
                               port.predict(X, raw_score=True), rtol=0,
                               atol=1e-5)


def test_dart_late_valid_set_follows_rescales():
    X, y = _binary(seed=3)
    params = {**BASE, "objective": "binary", "boosting": "dart",
              "drop_rate": 0.5, "skip_drop": 0.0, "learning_rate": 0.3}
    ds = lt.Dataset(X, label=y)
    early = lt.Dataset(X[:400], label=y[:400], reference=ds)
    bst = lt.train(params, ds, ROUNDS, valid_sets=[early],
                   verbose_eval=False, device="cpu")
    bst.add_valid(lt.Dataset(X[:400], label=y[:400], reference=ds), "late")
    raw = bst.predict(X[:400], raw_score=True)
    for score in bst._gbdt._valid_scores:
        np.testing.assert_allclose(score.numpy(), raw, rtol=0, atol=1e-5)


@pytest.mark.parametrize("objective", ["binary", "regression_l1"])
def test_rf_matches_reference(lgb, objective):
    X, y = _binary() if objective == "binary" else _regression()
    params = {**BASE, "objective": objective, "boosting": "rf",
              "bagging_fraction": 0.632, "bagging_freq": 1,
              "feature_fraction": 0.8}
    ref, port = _both(lgb, params, X, y)
    _same_trees(ref._gbdt.models, port._gbdt.models)
    raw = port.predict(X, raw_score=True)
    np.testing.assert_allclose(port.predict(X), ref.predict(X), rtol=0,
                               atol=2e-6)
    # the prediction is the average of the trees
    mean = np.mean([t.predict(X) for t in port._gbdt.models], axis=0)
    np.testing.assert_allclose(raw, mean, rtol=0, atol=1e-12)
    np.testing.assert_allclose(port._gbdt._train_score.numpy(), raw,
                               rtol=0, atol=1e-5)
    assert "average_output" in port.model_to_string()


@pytest.mark.parametrize("boosting", ["rf", "random_forest"])
def test_rf_needs_bagging(boosting):
    X, y = _binary(n=300)
    with pytest.raises(lt.LightGBMError, match="bagging"):
        lt.train({**BASE, "objective": "binary", "boosting": boosting},
                 lt.Dataset(X, label=y), 1, device="cpu")
