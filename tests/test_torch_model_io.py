"""Model loading of the port against the reference's and the JAX package's
fixtures: LightGBM-trained model files (numerical and categorical) predict
their recorded predictions, prediction early stop matches the reference
CLI, model text round-trips between the two packages, and ``dump_model``
equals the JAX package's."""
import os

import numpy as np
import pytest

import lightgbm_tpu_torch as lt

FIX = os.path.join(os.path.dirname(__file__), "fixtures")


def _fix(name):
    return os.path.join(FIX, name)


def _load(name):
    return lt.Booster(model_file=_fix(name), device="cpu")


def test_load_reference_model_predict_parity():
    """ref_binary_model.txt was trained by the reference CLI; its own
    predictions on the first 500 test rows (tests/test_model_io.py)."""
    rows = np.load(_fix("binary_test_rows.npy"))
    expected = np.load(_fix("ref_binary_pred.npy"))
    bst = _load("ref_binary_model.txt")
    assert (bst.num_trees(), bst.num_model_per_iteration(),
            bst.current_iteration(), bst.num_feature()) == (20, 1, 20, 28)
    np.testing.assert_allclose(bst.predict(rows[:, 1:]), expected, atol=1e-12)


def test_load_reference_categorical_model_predict_parity():
    """ref_cat_model.txt has category-set nodes; the rows hold NaN, unseen
    (25, 40) and negative categories, which the reference routes right
    (tests/test_categorical.py)."""
    rows = np.load(_fix("cat_rows.npy"))
    expected = np.load(_fix("ref_cat_pred.npy"))
    bst = _load("ref_cat_model.txt")
    assert any(t.num_cat > 0 for t in bst._gbdt.models)
    np.testing.assert_allclose(bst.predict(rows), expected, atol=1e-12)


def test_pred_early_stop_matches_reference_cli():
    """ref_pred_early_stop.txt: the reference CLI's predictions of
    ref_plain20_model.txt on the 500 rows of binary_test_rows.npy with
    pred_early_stop=true, freq 5, margin 1.5."""
    rows = np.load(_fix("binary_test_rows.npy"))[:, 1:]
    want = np.loadtxt(_fix("ref_pred_early_stop.txt"))
    bst = _load("ref_plain20_model.txt")
    got = bst.predict(rows, pred_early_stop=True, pred_early_stop_freq=5,
                      pred_early_stop_margin=1.5)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)
    assert not np.allclose(bst.predict(rows), want, rtol=1e-6, atol=1e-9)
    # the same knobs through reset_parameter
    bst.reset_parameter({"pred_early_stop": True, "pred_early_stop_freq": 5,
                         "pred_early_stop_margin": 1.5})
    np.testing.assert_allclose(bst.predict(rows), want, rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("name,rows", [
    ("ref_binary_model.txt", "binary_test_rows.npy"),
    ("ref_cat_model.txt", "cat_rows.npy")])
def test_model_text_round_trips_between_packages(name, rows):
    """A file through one package's save into the other's load, both ways:
    equal predictions, raw and leaf indices."""
    pytest.importorskip("jax")
    import lightgbm_tpu as lgb
    X = np.load(_fix(rows))
    if X.shape[1] == 29:
        X = X[:, 1:]
    port = _load(name)
    ref = lgb.Booster(model_file=_fix(name))
    ref_from_port = lgb.Booster(model_str=port.model_to_string())
    port_from_ref = lt.Booster(model_str=ref.model_to_string(), device="cpu")
    want = ref.predict(X, raw_score=True)
    for other in (ref_from_port, port_from_ref, port):
        np.testing.assert_allclose(other.predict(X, raw_score=True), want,
                                   rtol=0, atol=1e-12)
    np.testing.assert_array_equal(port.predict(X, pred_leaf=True),
                                  ref.predict(X, pred_leaf=True))
    assert port.model_to_string().split("end of trees")[0] == \
        ref.model_to_string().split("end of trees")[0]


def test_trained_model_round_trips_through_reference():
    """A port-trained booster's text loads in the JAX package and back in
    the port with equal predictions and equal trees."""
    pytest.importorskip("jax")
    import lightgbm_tpu as lgb
    rng = np.random.default_rng(0)
    X = rng.normal(size=(600, 5))
    X[rng.random(X.shape) < 0.05] = np.nan
    y = (np.nan_to_num(X[:, 0]) + X[:, 1] > 0).astype(float)
    bst = lt.train({"objective": "binary", "num_leaves": 7, "verbose": -1,
                    "min_data_in_leaf": 5}, lt.Dataset(X, label=y), 6,
                   device="cpu")
    ref = lgb.Booster(model_str=bst.model_to_string())
    back = lt.Booster(model_str=ref.model_to_string(), device="cpu")
    for other in (ref, back):
        np.testing.assert_allclose(other.predict(X), bst.predict(X),
                                   rtol=0, atol=1e-12)
    np.testing.assert_array_equal(back.feature_importance(),
                                  bst.feature_importance())
    assert back.model_to_string(num_iteration=3).count("Tree=") == 3


@pytest.mark.parametrize("name", ["ref_binary_model.txt",
                                  "ref_cat_model.txt"])
def test_dump_model_equals_reference(name):
    pytest.importorskip("jax")
    import lightgbm_tpu as lgb
    port = _load(name).dump_model()
    ref = lgb.Booster(model_file=_fix(name)).dump_model()
    assert port == ref
    assert _load(name).dump_model(num_iteration=4, start_iteration=2) == \
        lgb.Booster(model_file=_fix(name)).dump_model(num_iteration=4,
                                                      start_iteration=2)


def test_loaded_booster_surface():
    bst = _load("ref_binary_model.txt")
    assert bst.feature_name()[:2] == ["Column_0", "Column_1"]
    imp = bst.feature_importance()
    assert imp.shape == (28,) and imp.sum() == sum(
        t.num_leaves - 1 for t in bst._gbdt.models)
    gain = bst.feature_importance("gain")
    assert gain.shape == (28,) and (gain >= 0).all()
    rows = np.load(_fix("binary_test_rows.npy"))[:50, 1:]
    assert bst.predict(rows, pred_leaf=True).shape == (50, 20)
    with pytest.raises(lt.LightGBMError, match="number of features"):
        bst.predict(rows[:, :5])
    contrib = bst.predict(rows, pred_contrib=True)
    assert contrib.shape == (50, 29)
    np.testing.assert_allclose(contrib.sum(1),
                               bst.predict(rows, raw_score=True), atol=1e-10)
    with pytest.raises(TypeError):
        lt.Booster(device="cpu")


def _objective_data(objective, n=600, f=5, seed=0):
    """Seeded normal features and labels the objective accepts."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f))
    lin = 0.6 * X[:, 0] - 0.4 * X[:, 1] + 0.3 * X[:, 2] * X[:, 3]
    if objective == "regression":
        y = lin + 0.1 * rng.normal(size=n)
    elif objective == "poisson":
        y = rng.poisson(np.exp(0.5 * lin)).astype(np.float64)
    elif objective in ("gamma", "tweedie"):
        y = rng.gamma(2.0, np.exp(0.3 * lin))
    elif objective in ("multiclass", "multiclassova"):
        y = np.argmax(X[:, :3] + 0.5 * rng.normal(size=(n, 3)), 1)
        y = y.astype(np.float64)
    else:                                       # cross entropy: [0, 1]
        y = 1.0 / (1.0 + np.exp(-lin - 0.3 * rng.normal(size=n)))
    return X, y


_JAX_MODELS = {}


def _jax_model(objective, rounds=3, **extra):
    """A JAX-package booster of ``rounds`` trees of 7 leaves, cached."""
    key = (objective, rounds, tuple(sorted(extra.items())))
    if key not in _JAX_MODELS:
        pytest.importorskip("jax")
        import lightgbm_tpu as lgb
        X, y = _objective_data(objective)
        params = {"objective": objective, "num_leaves": 7,
                  "min_data_in_leaf": 20, "verbose": -1, **extra}
        _JAX_MODELS[key] = (X, lgb.train(params, lgb.Dataset(X, label=y),
                                         rounds))
    return _JAX_MODELS[key]


@pytest.mark.parametrize("objective,extra", [
    ("regression", {}), ("poisson", {}), ("gamma", {}), ("tweedie", {}),
    ("multiclass", {"num_class": 3}), ("multiclassova", {"num_class": 3}),
    ("cross_entropy", {}), ("cross_entropy_lambda", {})])
def test_loaded_objective_converts_like_the_jax_package(objective, extra):
    """A JAX-trained model of each objective, loaded from its text,
    predicts what the JAX package predicts, raw and converted (the
    objective's convert_output), at 1e-6."""
    X, ref = _jax_model(objective, **extra)
    port = lt.Booster(model_str=ref.model_to_string(), device="cpu")
    rows = X[:50]
    for raw in (True, False):
        np.testing.assert_allclose(port.predict(rows, raw_score=raw),
                                   ref.predict(rows, raw_score=raw),
                                   rtol=0, atol=1e-6)
    if objective not in ("regression",):
        # the conversion is not the identity: raw and converted differ
        assert not np.allclose(port.predict(rows),
                               port.predict(rows, raw_score=True))


def test_loaded_cross_entropy_early_stop_is_binary():
    """cross_entropy takes the binary margin early stop, as in the JAX
    package (boosting/gbdt.py _early_stop_spec)."""
    X, ref = _jax_model("cross_entropy", rounds=12)
    port = lt.Booster(model_str=ref.model_to_string(), device="cpu")
    got = port.predict(X, pred_early_stop=True, pred_early_stop_freq=1,
                       pred_early_stop_margin=0.5)
    cfg = ref._gbdt.config
    saved = (cfg.pred_early_stop, cfg.pred_early_stop_freq,
             cfg.pred_early_stop_margin)
    cfg.pred_early_stop, cfg.pred_early_stop_freq = True, 1
    cfg.pred_early_stop_margin = 0.5
    try:
        want = ref.predict(X)
    finally:
        (cfg.pred_early_stop, cfg.pred_early_stop_freq,
         cfg.pred_early_stop_margin) = saved
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert not np.allclose(got, port.predict(X), rtol=0, atol=1e-6)


def test_unknown_objective_predicts_raw_only():
    """A header objective the port cannot build: raw scores still predict,
    converted ones raise instead of returning raw scores silently."""
    X, ref = _jax_model("poisson")
    text = ref.model_to_string().replace("objective=poisson",
                                         "objective=not_an_objective")
    port = lt.Booster(model_str=text, device="cpu")
    np.testing.assert_allclose(port.predict(X[:20], raw_score=True),
                               ref.predict(X[:20], raw_score=True),
                               rtol=0, atol=1e-6)
    with pytest.raises(lt.LightGBMError, match="not_an_objective"):
        port.predict(X[:20])
