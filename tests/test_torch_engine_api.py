"""The rest of the training API against the JAX package (its wave grower
through the Pallas interpreter) on a seeded binary problem: custom
objectives and metrics (``fobj``/``feval``), ``learning_rates``, the
``reset_parameter`` callback and ``cv`` with its folds, ``CVBooster`` and
aggregation.

Tolerances: trees identical; raw scores within 1e-5; metric values and
``cv`` results within 1e-6 (the same f32 scores, up to summation order,
through the same metric code); the folds equal."""
import numpy as np
import pytest

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import engine

PARAMS = {"objective": "binary", "num_leaves": 15, "max_bin": 63,
          "learning_rate": 0.1, "min_data_in_leaf": 20, "verbose": -1}


def _data(n=2000, f=8, seed=1):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f))
    logit = X[:, 0] - 0.8 * X[:, 1] + X[:, 2] * X[:, 4]
    y = (logit + rng.logistic(size=n) > 0).astype(np.float64)
    return X, y


@pytest.fixture()
def lgb(monkeypatch):
    pytest.importorskip("jax")
    import lightgbm_tpu
    monkeypatch.setenv("LGBM_TPU_FORCE_WAVE", "interpret")
    return lightgbm_tpu


def _logloss_obj(preds, data):
    label = data.get_label()
    prob = 1.0 / (1.0 + np.exp(-preds))
    return prob - label, prob * (1.0 - prob)


def _l2_metric(preds, data):
    return "my_l2", float(np.mean((preds - data.get_label()) ** 2)), False


def _same_trees(ref, port):
    for rt, pt in zip(ref._gbdt.models, port._gbdt.models, strict=True):
        nn = rt.num_leaves - 1
        assert rt.num_leaves == pt.num_leaves
        np.testing.assert_array_equal(rt.split_feature[:nn],
                                      pt.split_feature[:nn])
        np.testing.assert_array_equal(rt.threshold[:nn], pt.threshold[:nn])


def test_fobj_feval_match_reference(lgb):
    X, y = _data()
    Xv, yv = _data(n=500, seed=2)
    params = {**PARAMS, "metric": "binary_logloss"}
    er, ep = {}, {}
    ref = lgb.train(params, lgb.Dataset(X, label=y), 3, fobj=_logloss_obj,
                    feval=_l2_metric,
                    valid_sets=[lgb.Dataset(Xv, label=yv)], evals_result=er,
                    verbose_eval=False)
    port = lt.train(params, lt.Dataset(X, label=y), 3, fobj=_logloss_obj,
                    feval=_l2_metric, valid_sets=[lt.Dataset(Xv, label=yv)],
                    evals_result=ep, verbose_eval=False, device="cpu")
    assert port._gbdt.objective is None
    assert "objective=custom" in port.model_to_string()
    _same_trees(ref, port)
    np.testing.assert_allclose(port._raw_train_score(),
                               ref._raw_train_score(), rtol=0, atol=1e-5)
    assert set(ep["valid_0"]) == set(er["valid_0"]) == {"binary_logloss",
                                                          "my_l2"}
    for m in ep["valid_0"]:
        np.testing.assert_allclose(ep["valid_0"][m], er["valid_0"][m],
                                   rtol=0, atol=1e-6)


def test_booster_update_with_fobj_and_eval_feval(lgb):
    X, y = _data(seed=3)
    ref = lgb.Booster(PARAMS, lgb.Dataset(X, label=y))
    port = lt.Booster(PARAMS, lt.Dataset(X, label=y), device="cpu")
    for _ in range(2):
        ref.update(fobj=_logloss_obj)
        port.update(fobj=_logloss_obj)
    np.testing.assert_allclose(port._raw_train_score(),
                               ref._raw_train_score(), rtol=0, atol=1e-5)
    got, want = port.eval_train(_l2_metric), ref.eval_train(_l2_metric)
    assert [e[:2] for e in got] == [e[:2] for e in want]
    np.testing.assert_allclose([e[2] for e in got], [e[2] for e in want],
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("schedule", ["list", "callback"])
def test_learning_rate_schedules_match_reference(lgb, schedule):
    X, y = _data(seed=4)
    rates = [0.2, 0.1, 0.05, 0.02]
    if schedule == "list":
        kw_ref = kw_port = {"learning_rates": rates}
    else:
        kw_ref = {"callbacks": [lgb.callback.reset_parameter(
            learning_rate=lambda i: 0.3 * 0.5 ** i)]}
        kw_port = {"callbacks": [lt.reset_parameter(
            learning_rate=lambda i: 0.3 * 0.5 ** i)]}
    ref = lgb.train(PARAMS, lgb.Dataset(X, label=y), 4, **kw_ref)
    port = lt.train(PARAMS, lt.Dataset(X, label=y), 4, device="cpu",
                    **kw_port)
    _same_trees(ref, port)
    shrink = [float(t.shrinkage) for t in port._gbdt.models]
    want = rates if schedule == "list" else [0.3 * 0.5 ** i
                                             for i in range(4)]
    np.testing.assert_allclose(shrink, want)
    np.testing.assert_allclose(port._raw_train_score(),
                               ref._raw_train_score(), rtol=0, atol=1e-5)


def test_reset_parameter_rejects_a_wrong_length():
    X, y = _data(n=300)
    with pytest.raises(ValueError, match="num_boost_round"):
        lt.train(PARAMS, lt.Dataset(X, label=y), 3, learning_rates=[0.1],
                 device="cpu")


def test_cv_matches_reference(lgb):
    """Stratified folds; the unstratified draw is held below without
    training (each fold's booster costs a reference training)."""
    X, y = _data(seed=5)
    params = {**PARAMS, "metric": ["binary_logloss", "auc"]}
    ref = lgb.cv(params, lgb.Dataset(X, label=y, free_raw_data=False), 3,
                 nfold=3, seed=11, return_cvbooster=True)
    port = lt.cv(params, lt.Dataset(X, label=y, free_raw_data=False), 3,
                 nfold=3, seed=11, return_cvbooster=True, device="cpu")
    assert isinstance(port.pop("cvbooster"), engine.CVBooster)
    ref.pop("cvbooster")
    assert sorted(port) == sorted(ref)
    for key in ref:
        np.testing.assert_allclose(port[key], ref[key], rtol=0, atol=1e-6)


def test_cv_folds_and_aggregation_match_reference(lgb):
    from lightgbm_tpu import engine as ref_engine
    X, y = _data(n=301, seed=6)
    for stratified in (True, False):
        want = ref_engine._make_n_folds(
            lgb.Dataset(X, label=y, free_raw_data=False), None, 4,
            stratified, True, 3)
        got = engine._make_n_folds(
            lt.Dataset(X, label=y, free_raw_data=False), None, 4,
            stratified, True, 3)
        for (a, b), (c, d) in zip(got, want, strict=True):
            np.testing.assert_array_equal(a, c)
            np.testing.assert_array_equal(b, d)
    raw = [[("valid", "auc", 0.5, True), ("valid", "l2", 2.0, False)],
           [("valid", "auc", 0.7, True), ("valid", "l2", 1.0, False)]]
    assert engine._agg_cv_result(raw) == ref_engine._agg_cv_result(raw)


def test_cvbooster_calls_every_fold():
    X, y = _data(n=600, seed=7)
    res = lt.cv(PARAMS, lt.Dataset(X, label=y, free_raw_data=False), 2,
                nfold=3, return_cvbooster=True, device="cpu")
    cvb = res["cvbooster"]
    preds = cvb.predict(X)
    assert len(preds) == 3 and all(p.shape == (600,) for p in preds)
    assert cvb.num_trees() == [2, 2, 2]
