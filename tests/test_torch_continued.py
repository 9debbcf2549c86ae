"""Continued training and init scores: the port against the JAX package
(its wave grower through the Pallas interpreter, LGBM_TPU_FORCE_WAVE) on
seeded problems.  ``init_model`` from a Booster and from a model file,
multiclass continuation, init scores on the training and valid sets.

Tolerances: trees identical; raw scores and probabilities within 1e-5
(f32 histogram sums in another order move a leaf by ~1e-7 here; the
binary problem of test_torch_train.py argues 1e-4 for 31 leaves); the
port's continued run against its uninterrupted one at the JAX package's
own tolerance (tests/test_continued.py: rtol 1e-4, atol 1e-6)."""
import numpy as np
import pytest

import lightgbm_tpu_torch as lt

PARAMS = {"objective": "binary", "num_leaves": 15, "max_bin": 63,
          "learning_rate": 0.1, "min_data_in_leaf": 20, "verbose": -1}


def _data(n=2000, f=8, seed=1):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f))
    logit = X[:, 0] - 0.8 * X[:, 1] + X[:, 2] * X[:, 4]
    y = (logit + rng.logistic(size=n) > 0).astype(np.float64)
    return X, y


def _multiclass(n=900, seed=2):
    """Every feature carries signal (noise features invite near-tied
    splits, which f32 summation order breaks either way)."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 5))
    logits = X @ rng.normal(size=(5, 3)) + rng.gumbel(size=(n, 3))
    return X, np.argmax(logits, 1).astype(np.float64)


@pytest.fixture()
def lgb(monkeypatch):
    pytest.importorskip("jax")
    import lightgbm_tpu
    monkeypatch.setenv("LGBM_TPU_FORCE_WAVE", "interpret")
    return lightgbm_tpu


def _same_trees(ref_models, port_models):
    assert len(ref_models) == len(port_models)
    for rt, pt in zip(ref_models, port_models):
        assert rt.num_leaves == pt.num_leaves
        nn = rt.num_leaves - 1
        np.testing.assert_array_equal(rt.split_feature[:nn],
                                      pt.split_feature[:nn])
        np.testing.assert_array_equal(rt.threshold[:nn], pt.threshold[:nn])
        np.testing.assert_array_equal(rt.left_child[:nn], pt.left_child[:nn])


def test_init_model_booster_matches_reference(lgb):
    X, y = _data()
    r1 = lgb.train(PARAMS, lgb.Dataset(X, label=y), 3)
    r2 = lgb.train(PARAMS, lgb.Dataset(X, label=y), 2, init_model=r1)
    p1 = lt.train(PARAMS, lt.Dataset(X, label=y), 3, device="cpu")
    p2 = lt.train(PARAMS, lt.Dataset(X, label=y), 2, init_model=p1,
                  device="cpu")
    assert p2.num_trees() == 5 and p2.current_iteration() == 5
    _same_trees(r2._gbdt.models, p2._gbdt.models)
    np.testing.assert_allclose(p2._raw_train_score(), r2._raw_train_score(),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(p2.predict(X), r2.predict(X), rtol=0,
                               atol=1e-5)


def test_init_model_file_matches_booster_and_reference(lgb, tmp_path):
    X, y = _data(seed=3)
    path = str(tmp_path / "m3.txt")
    p1 = lt.train(PARAMS, lt.Dataset(X, label=y), 3, device="cpu")
    p1.save_model(path)
    from_file = lt.train(PARAMS, lt.Dataset(X, label=y), 2, init_model=path,
                         device="cpu")
    from_bst = lt.train(PARAMS, lt.Dataset(X, label=y), 2, init_model=p1,
                        device="cpu")
    np.testing.assert_array_equal(from_file.predict(X), from_bst.predict(X))
    ref = lgb.train(PARAMS, lgb.Dataset(X, label=y), 2, init_model=path)
    _same_trees(ref._gbdt.models, from_file._gbdt.models)
    np.testing.assert_allclose(from_file.predict(X), ref.predict(X), rtol=0,
                               atol=1e-5)


def test_continued_equals_uninterrupted():
    X, y = _data(seed=4)
    full = lt.train(PARAMS, lt.Dataset(X, label=y), 6, device="cpu")
    half = lt.train(PARAMS, lt.Dataset(X, label=y), 3, device="cpu")
    cont = lt.train(PARAMS, lt.Dataset(X, label=y), 3, init_model=half,
                    device="cpu")
    np.testing.assert_allclose(cont.predict(X), full.predict(X), rtol=1e-4,
                               atol=1e-6)


def test_multiclass_continuation_matches_reference(lgb):
    X, y = _multiclass()
    params = {"objective": "multiclass", "num_class": 3, "num_leaves": 7,
              "max_bin": 63, "verbose": -1}
    r5 = lgb.train(params, lgb.Dataset(X, label=y), 3)
    rc = lgb.train(params, lgb.Dataset(X, label=y), 2, init_model=r5)
    p5 = lt.train(params, lt.Dataset(X, label=y), 3, device="cpu")
    pc = lt.train(params, lt.Dataset(X, label=y), 2, init_model=p5,
                  device="cpu")
    assert pc.num_trees() == 15
    _same_trees(rc._gbdt.models, pc._gbdt.models)
    np.testing.assert_allclose(pc.predict(X), rc.predict(X), rtol=0,
                               atol=1e-5)


def test_init_scores_on_train_and_valid_match_reference(lgb):
    X, y = _data(seed=5)
    rng = np.random.default_rng(6)
    init = rng.normal(size=len(y)) * 0.3
    Xv, yv = _data(n=500, seed=7)
    vinit = rng.normal(size=len(yv)) * 0.3
    params = {**PARAMS, "metric": ["binary_logloss", "auc"]}
    er, ep = {}, {}
    tr = lgb.Dataset(X, label=y, init_score=init)
    ref = lgb.train(params, tr, 3, valid_sets=[lgb.Dataset(
        Xv, label=yv, init_score=vinit, reference=tr)], evals_result=er,
        verbose_eval=False)
    pt = lt.Dataset(X, label=y, init_score=init)
    port = lt.train(params, pt, 3, valid_sets=[lt.Dataset(
        Xv, label=yv, init_score=vinit, reference=pt)], evals_result=ep,
        verbose_eval=False, device="cpu")
    assert pt.get_init_score() is init
    _same_trees(ref._gbdt.models, port._gbdt.models)
    # no boost from average under init scores
    assert abs(port._gbdt.models[0].leaf_value).max() < 1.0
    np.testing.assert_allclose(port._raw_train_score(),
                               ref._raw_train_score(), rtol=0, atol=1e-5)
    for m in ("binary_logloss", "auc"):
        np.testing.assert_allclose(ep["valid_0"][m], er["valid_0"][m],
                                   rtol=0, atol=1e-6)


def test_multiclass_init_scores_are_class_major(lgb):
    X, y = _multiclass(seed=8)
    params = {"objective": "multiclass", "num_class": 3, "num_leaves": 7,
              "max_bin": 63, "verbose": -1}
    init = np.random.default_rng(9).normal(size=3 * len(y)) * 0.2
    ref = lgb.train(params, lgb.Dataset(X, label=y, init_score=init), 2)
    port = lt.train(params, lt.Dataset(X, label=y, init_score=init), 2,
                    device="cpu")
    start = init.reshape(3, -1).T
    assert port._gbdt._train_score.shape == start.shape
    _same_trees(ref._gbdt.models, port._gbdt.models)
    np.testing.assert_allclose(port._raw_train_score(),
                               ref._raw_train_score(), rtol=0, atol=1e-5)


def test_init_model_with_more_leaves_than_this_run(lgb):
    """The init forest's trees may have more leaves than this run's
    ``num_leaves`` (the JAX package pads them; the stacked forest takes
    them as they are)."""
    X, y = _data(seed=10)
    big = {**PARAMS, "num_leaves": 31}
    r1 = lgb.train(big, lgb.Dataset(X, label=y), 2)
    p1 = lt.train(big, lt.Dataset(X, label=y), 2, device="cpu")
    assert max(t.num_leaves for t in p1._gbdt.models) > 15
    ref = lgb.train(PARAMS, lgb.Dataset(X, label=y), 2, init_model=r1)
    port = lt.train(PARAMS, lt.Dataset(X, label=y), 2, init_model=p1,
                    device="cpu")
    _same_trees(ref._gbdt.models, port._gbdt.models)
    np.testing.assert_allclose(port._raw_train_score(),
                               ref._raw_train_score(), rtol=0, atol=1e-5)
