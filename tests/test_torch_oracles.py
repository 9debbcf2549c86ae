"""The JAX package's three differential oracles, accepted by the port:
``tpu_batched_split_apply=false`` (one walk of all rows per committed
split), ``tpu_fused_grad=false`` (materialised gradients: the port's only
path) and ``tpu_wave_overlap`` (each wave's split scan deferred one loop
body; its oracle ``"serial"`` is a grower argument).  Each grows the JAX
package's trees with the same knob (its wave grower through the Pallas
interpreter); ``"serial"`` and ``"on"`` grow the same trees.

Tolerances: trees identical; leaf values within 1e-5 (f32 histogram sums
in another order); predictions within 1e-6."""
import numpy as np
import pytest

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.core.wave_grower import build_wave_grow_fn

PARAMS = {"objective": "binary", "num_leaves": 15, "max_bin": 63,
          "learning_rate": 0.2, "min_data_in_leaf": 20, "verbose": -1,
          "tpu_wave_capacity": 4}
ROUNDS = 3


def _data(n=1500, f=6, seed=1):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f))
    logit = X[:, 0] - 0.8 * X[:, 1] + X[:, 2] * X[:, 3]
    return X, (logit + rng.logistic(size=n) > 0).astype(np.float64)


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
                                   rt.leaf_value[:rt.num_leaves], rtol=0,
                                   atol=1e-5)


@pytest.mark.parametrize("knob", [
    {"tpu_batched_split_apply": False},
    {"tpu_fused_grad": False},
    {"tpu_wave_overlap": True},
], ids=lambda k: "-".join(k))
def test_oracle_knob_matches_reference(lgb, knob):
    X, y = _data()
    params = {**PARAMS, **knob}
    ref = lgb.train(params, lgb.Dataset(X, label=y), ROUNDS)
    port = lt.train(params, lt.Dataset(X, label=y), ROUNDS, device="cpu")
    _same_trees(ref._gbdt.models, port._gbdt.models)
    np.testing.assert_allclose(port.predict(X), ref.predict(X), rtol=0,
                               atol=1e-6)


def _port_with_grower(params, X, y, **grower_kw):
    bst = lt.Booster(params=dict(params),
                     train_set=lt.Dataset(X, label=y), device="cpu")
    g = bst._gbdt
    g._grow = build_wave_grow_fn(**{**g.wave_kw, **grower_kw})
    for _ in range(ROUNDS):
        bst.update()
    return bst


def test_overlap_serial_equals_on():
    X, y = _data(seed=2)
    on = _port_with_grower(PARAMS, X, y, overlap="on")
    serial = _port_with_grower(PARAMS, X, y, overlap="serial")
    off = _port_with_grower(PARAMS, X, y, overlap="off")
    assert on.model_to_string() == serial.model_to_string()
    # the deferred scan commits on gains one wave old: other trees
    assert on.model_to_string() != off.model_to_string()


@pytest.mark.parametrize("extra", [{}, {"categorical_feature": [5]}],
                         ids=["numerical", "categorical"])
def test_sequential_apply_equals_batched(extra):
    """The sequential walk against the batched pass, on the grower: one
    model text (also across EFB bundles of one-hot columns)."""
    X, y = _data(seed=3)
    X[:, 5] = np.floor(np.abs(X[:, 5]) * 3)
    onehot = np.eye(8)[np.random.default_rng(0).integers(0, 8, len(X))]
    X = np.hstack([X, onehot])
    params = {**PARAMS, **{k: v for k, v in extra.items()
                           if k != "categorical_feature"}}
    cat = extra.get("categorical_feature", "auto")

    def run(batched):
        bst = lt.Booster(params=dict(params), train_set=lt.Dataset(
            X, label=y, categorical_feature=cat), device="cpu")
        g = bst._gbdt
        assert g._bundled
        g._grow = build_wave_grow_fn(**{**g.wave_kw,
                                        "batched_apply": batched})
        for _ in range(ROUNDS):
            bst.update()
        return bst
    assert run(True).model_to_string() == run(False).model_to_string()
