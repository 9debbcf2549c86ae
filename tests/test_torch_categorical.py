"""Categorical features in the port against the JAX package on the CPU:
the category-set search equals the reference's on fixed histograms
(one-hot and sorted-ratio), training on seeded categorical data grows the
same trees, bitsets and model text (the JAX side through the Pallas
interpreter, LGBM_TPU_FORCE_WAVE=interpret), a trained categorical
booster predicts what the JAX package predicts (host walk and device
forest, NaN, negative and unseen categories included), the reference's
categorical model file still predicts its recorded predictions, and
convert.py carries categorical mappers and bitsets across."""
import os

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import convert
from lightgbm_tpu_torch.boosting.gbdt import PredictorBase
from lightgbm_tpu_torch.core import splitter
from lightgbm_tpu_torch.core.meta import SplitConfig

FIX = os.path.join(os.path.dirname(__file__), "fixtures")
PARAMS = {"objective": "binary", "num_leaves": 15, "max_bin": 63,
          "learning_rate": 0.1, "min_data_in_leaf": 20, "verbose": -1,
          "min_data_per_group": 20, "cat_smooth": 5}
CATS = [0, 2, 4]
ROUNDS = 5


def _cat_data(n=3000, seed=7):
    """Three categorical columns (12 uniform categories with NaNs, 3
    categories: one-hot, and a Zipf-skewed one of up to 41) beside two
    numeric ones (test_categorical.py's problem, widened)."""
    rng = np.random.default_rng(seed)
    cat = rng.integers(0, 12, size=n).astype(np.float64)
    cat2 = rng.integers(0, 3, size=n).astype(np.float64)
    cat3 = np.minimum(rng.zipf(1.6, size=n) - 1, 40).astype(np.float64)
    x1 = rng.normal(size=n)
    logit = (2.5 * ((cat % 3 == 0) - 0.5) + 0.4 * x1 + 0.8 * (cat2 == 1)
             + 0.3 * np.sin(cat3))
    y = (logit + rng.normal(scale=0.5, size=n) > 0).astype(np.float64)
    X = np.column_stack([cat, x1, cat2, rng.normal(size=n), cat3])
    X[rng.random(n) < 0.02, 0] = np.nan
    return X, y


@pytest.fixture(scope="module")
def trained():
    pytest.importorskip("jax")
    import lightgbm_tpu as lgb
    X, y = _cat_data()
    mp = pytest.MonkeyPatch()
    mp.setenv("LGBM_TPU_FORCE_WAVE", "interpret")
    try:
        ref = lgb.train(PARAMS, lgb.Dataset(X, label=y,
                                            categorical_feature=CATS), ROUNDS)
    finally:
        mp.undo()
    port = lt.train(PARAMS, lt.Dataset(X, label=y, categorical_feature=CATS),
                    ROUNDS, device="cpu")
    return X, y, ref, port


def _cat_meta(num_bins, missing):
    F = len(num_bins)
    return dict(num_bins=np.asarray(num_bins, np.int32),
                default_bins=np.ones(F, np.int32),
                missing_types=np.asarray(missing, np.int32),
                monotone=np.zeros(F, np.int32),
                penalties=np.ones(F, np.float32),
                is_categorical=np.ones(F, bool),
                feat2phys=np.arange(F, dtype=np.int32),
                feat_offset=np.zeros(F, np.int32),
                needs_fix=np.zeros(F, bool))


@pytest.mark.parametrize("onehot", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_categorical_search_equals_reference(seed, onehot):
    """A batch of leaves over categorical features of 6-24 bins (missing
    types None and NaN): the same winning feature, gain and left bin set
    as the reference's best_split (its ``_categorical_best``), leaf by
    leaf.  Values are multiples of 1/64 so the sums are exact."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from lightgbm_tpu.core.meta import DeviceMeta as RefMeta
    from lightgbm_tpu.core.meta import SplitConfig as RefSplit
    from lightgbm_tpu.core.splitter import best_split as ref_best
    rng = np.random.default_rng(seed)
    F, B, leaves = 4, 32, 12
    nb = rng.integers(6, 25, size=F)
    meta_np = _cat_meta(nb, rng.integers(0, 2, size=F) * 2)
    c = rng.integers(0, 30, size=(leaves, F, B)).astype(np.float32)
    c *= np.arange(B)[None, None, :] < nb[None, :, None]
    g = np.round(rng.normal(size=c.shape) * c * 6.4) / 64
    h = np.round(c * 64 * (0.2 + 0.1 * rng.random(c.shape))) / 64
    hist = np.stack([g, h, c], -1).astype(np.float32)
    tot = hist[:, 0].sum(axis=1)
    kw = dict(num_leaves=31, min_data_in_leaf=3, min_sum_hessian_in_leaf=1e-3,
              min_data_per_group=5, cat_smooth=2.0, cat_l2=1.0,
              max_cat_to_onehot=64 if onehot else 4, max_cat_threshold=8)
    ref_meta = RefMeta(**{k: jnp.asarray(v) for k, v in meta_np.items()})
    inf = np.float32(np.inf)
    ref = jax.vmap(lambda hh, t: ref_best(
        hh, t[0], t[1], t[2], ref_meta, RefSplit(**kw), -inf, inf,
        has_cat=True))(jnp.asarray(hist), jnp.asarray(tot))
    t = torch.from_numpy(tot)
    got = splitter.best_split(
        torch.from_numpy(hist), t[:, 0], t[:, 1], t[:, 2],
        convert.meta_from_numpy(meta_np, "cpu"), SplitConfig(**kw),
        torch.full((leaves,), -inf), torch.full((leaves,), inf))
    found = np.asarray(ref.feature) >= 0
    assert found.sum() >= leaves // 2
    np.testing.assert_array_equal(got.feature.numpy(), np.asarray(ref.feature))
    np.testing.assert_array_equal(
        got.cat_bitset.numpy().view(np.uint32)[found],
        np.asarray(ref.cat_bitset)[found])
    np.testing.assert_allclose(got.gain.numpy()[found],
                               np.asarray(ref.gain)[found], rtol=1e-6)
    for name in ("left_g", "left_h", "left_c", "left_out", "right_out"):
        np.testing.assert_allclose(getattr(got, name).numpy()[found],
                                   np.asarray(getattr(ref, name))[found],
                                   rtol=1e-6, atol=1e-6)


def test_trees_bitsets_and_model_text_equal_reference(trained):
    _, _, ref, port = trained
    assert len(ref._gbdt.models) == len(port._gbdt.models) == ROUNDS
    assert any(t.num_cat > 0 for t in port._gbdt.models)
    for rt, pt in zip(ref._gbdt.models, port._gbdt.models):
        assert rt.num_leaves == pt.num_leaves
        nn = rt.num_leaves - 1
        for name in ("split_feature", "threshold", "decision_type",
                     "left_child", "right_child"):
            np.testing.assert_array_equal(getattr(pt, name),
                                          getattr(rt, name)[:nn])
        np.testing.assert_array_equal(pt.cat_boundaries, rt.cat_boundaries)
        np.testing.assert_array_equal(pt.cat_threshold, rt.cat_threshold)
        np.testing.assert_allclose(pt.leaf_value, rt.leaf_value, rtol=0,
                                   atol=1e-4)

    def structure(text):
        # float-valued lines differ in the last digits (f32 sums in another
        # order), and the parameters block lists each package's own
        # config fields; everything else is compared
        body = text.split("\nparameters:")[0]
        return [line for line in body.splitlines() if not line.startswith(
            ("leaf_value=", "split_gain=", "internal_value=",
             "internal_weight=", "leaf_weight=", "tree_sizes="))]
    assert structure(port.model_to_string()) == \
        structure(ref.model_to_string())

    def strip(d):
        if isinstance(d, dict):
            return {k: strip(v) for k, v in d.items() if k not in (
                "leaf_value", "split_gain", "internal_value",
                "internal_weight", "leaf_weight", "parameters")}
        return [strip(x) for x in d] if isinstance(d, list) else d
    assert strip(port.dump_model()) == strip(ref.dump_model())


def test_predictions_equal_reference(trained, monkeypatch):
    """On rows with NaN, negative and unseen categories: the port's host
    walk and device forest (its threshold lowered so these rows take it)
    within 1e-6 of the JAX package predicting the same model; within 1e-4
    of the JAX-trained booster, whose leaf values differ from the port's
    by f32 summation order (test_torch_train.py); device leaves equal host
    leaves."""
    import lightgbm_tpu as lgb
    X, _, ref, port = trained
    rows = X[:400].copy()
    rows[::7, 0] = np.nan
    rows[1::7, 0] = -3.0
    rows[2::7, 0] = 57.0                     # a category never seen
    rows[3::7, 4] = 1e4
    want = lgb.Booster(model_str=port.model_to_string()).predict(rows)
    np.testing.assert_allclose(port.predict(rows), want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(port.predict(rows), ref.predict(rows),
                               rtol=0, atol=1e-4)
    host_leaf = port.predict(rows, pred_leaf=True)
    monkeypatch.setattr(PredictorBase, "_DEVICE_PREDICT_MIN_WORK", 1)
    from lightgbm_tpu_torch.core import forest
    before = forest.calls["predict"]
    np.testing.assert_allclose(port.predict(rows), want, rtol=0, atol=1e-6)
    assert forest.calls["predict"] == before + 1
    np.testing.assert_array_equal(port.predict(rows, pred_leaf=True),
                                  host_leaf)
    loaded = lt.Booster(model_str=port.model_to_string(), device="cpu")
    np.testing.assert_allclose(loaded.predict(rows), want, rtol=0, atol=1e-6)


def test_reference_categorical_model_on_the_device_walk(monkeypatch):
    """ref_cat_model.txt (reference CLI, category-set nodes) still predicts
    ref_cat_pred.npy at 1e-12 on the host walk, and within 1e-6 through
    the model-derived bin space and the device forest walk, whose leaf
    values add in f32 (Kahan-compensated, core/forest.py)."""
    from lightgbm_tpu_torch.core import forest
    rows = np.load(os.path.join(FIX, "cat_rows.npy"))
    want = np.load(os.path.join(FIX, "ref_cat_pred.npy"))
    bst = lt.Booster(model_file=os.path.join(FIX, "ref_cat_model.txt"),
                     device="cpu")
    np.testing.assert_allclose(bst.predict(rows), want, atol=1e-12)
    monkeypatch.setattr(PredictorBase, "_DEVICE_PREDICT_MIN_WORK", 1)
    before = forest.calls["predict"]
    np.testing.assert_allclose(bst.predict(rows), want, rtol=0, atol=1e-6)
    assert forest.calls["predict"] == before + 1


def test_valid_set_replay_equals_training_scores(trained):
    """A valid set attached after training (the training rows again)
    replays the categorical trees in bin space to the training scores."""
    X, y, _, port = trained
    ds = lt.Dataset(X, label=y, reference=port.train_set)
    port.add_valid(ds, "again")
    gb = port._gbdt
    np.testing.assert_array_equal(gb._valid_scores[-1].numpy(),
                                  gb._train_score.numpy())


def test_convert_carries_categorical_state(trained):
    """convert.py: the JAX package's categorical mappers, binned matrix,
    device metadata and tree bitsets become the port's unchanged."""
    import jax
    _, _, ref, _ = trained
    rds = ref._gbdt.train_ds
    pds = convert.dataset_from_numpy(
        rds.X_bin, [m.to_dict() for m in rds.bin_mappers],
        bundle=rds.bundle)
    for pm, rm in zip(pds.bin_mappers, rds.bin_mappers):
        assert pm.to_dict() == rm.to_dict()
    from lightgbm_tpu_torch.core.meta import build_device_meta
    pmeta, pB = build_device_meta(pds, None, "cpu")
    assert pB == ref._gbdt.B
    for k in pmeta._fields:
        np.testing.assert_array_equal(getattr(pmeta, k).numpy(),
                                      np.asarray(getattr(ref._gbdt.meta, k)))
    arrs = jax.device_get(ref._gbdt._tree_to_device(ref._gbdt.models[0]))
    d = {k: np.asarray(v) for k, v in arrs._asdict().items()}
    assert d["cat_bitset"].any()
    back = convert.tree_arrays_to_numpy(convert.tree_arrays_from_numpy(d,
                                                                       "cpu"))
    for k, v in back.items():
        np.testing.assert_array_equal(v, d[k].astype(v.dtype))
