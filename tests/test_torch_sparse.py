"""Sparse input against the dense build and the JAX package: ``from_csr``
binning (stored entries per CSC column, EFB over the sparse columns, the
non-default bins scattered into ``X_bin``), the valid-set path with
``reference``, training on a CSR (on the wave grower, and on the serial
grower when every EFB column is wider than 256 bins) and prediction from
a CSR.

Tolerances: ``X_bin``, bin mappers and bundles equal; a model trained on
a CSR byte-equal in text to one trained on its dense twin; predictions
from a CSR equal to the dense input's; trees identical to the JAX
package's (leaf values within 1e-4)."""
import numpy as np
import pytest
import scipy.sparse as sp

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.io.dataset import BinnedDataset


def _sparse_problem(n=400, f=30, density=0.15, seed=3):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f))
    X[rng.random((n, f)) > density] = 0.0
    y = (X[:, 0] - X[:, 1] + 0.2 * rng.normal(size=n) > 0).astype(float)
    return sp.csr_matrix(X), X, y


def _wide_problem(n=30000, f=2200, per_row=8, seed=0):
    """tests/test_sparse.py's wide shape cut to 30,000 x 2,200 (past 2,048
    features: EFB columns of up to 4,096 bins)."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), per_row)
    cols = rng.integers(0, f, size=n * per_row)
    informative = cols < 50
    vals = np.where(informative, 1.0 + rng.random(n * per_row),
                    rng.normal(size=n * per_row))
    X = sp.csr_matrix((vals, (rows, cols)), shape=(n, f))
    signal = np.zeros(n)
    np.add.at(signal, rows[informative], vals[informative])
    y = (signal + 0.5 * rng.normal(size=n) > 1.0).astype(float)
    return X, y


WIDE_PARAMS = {"objective": "binary", "num_leaves": 7, "max_bin": 15,
               "min_data_in_leaf": 20, "max_conflict_rate": 0.1,
               "verbose": -1}


def _ref():
    pytest.importorskip("jax")
    from lightgbm_tpu.config import Config as RefConfig
    from lightgbm_tpu.io.dataset import BinnedDataset as RefDataset
    return RefConfig, RefDataset


def _same_datasets(a, b):
    np.testing.assert_array_equal(a.X_bin, b.X_bin)
    np.testing.assert_array_equal(a.bin_offsets, b.bin_offsets)
    np.testing.assert_array_equal(a.real_feature_idx, b.real_feature_idx)
    assert [m.to_dict() for m in a.bin_mappers] == \
        [m.to_dict() for m in b.bin_mappers]
    assert (a.bundle is None) == (b.bundle is None)
    if a.bundle is not None:
        assert [list(g) for g in a.bundle.groups] == \
            [list(g) for g in b.bundle.groups]
        np.testing.assert_array_equal(a.bundle.feat_offset,
                                      b.bundle.feat_offset)


def test_from_csr_matches_dense_and_reference():
    RefConfig, RefDataset = _ref()
    Xs, Xd, _ = _sparse_problem()
    params = {"verbose": -1, "max_bin": 31}
    got = BinnedDataset.from_csr(Xs, Config.from_params(params))
    _same_datasets(got, BinnedDataset.from_matrix(
        Xd, Config.from_params(params)))
    _same_datasets(got, RefDataset.from_csr(Xs, RefConfig.from_params(
        params)))
    valid = BinnedDataset.from_csr(Xs[:100], Config(), reference=got)
    np.testing.assert_array_equal(valid.X_bin, got.X_bin[:100])


def test_wide_sparse_bundles_match_reference():
    RefConfig, RefDataset = _ref()
    X, _ = _wide_problem()
    got = BinnedDataset.from_csr(X, Config.from_params(WIDE_PARAMS))
    want = RefDataset.from_csr(X, RefConfig.from_params(WIDE_PARAMS))
    _same_datasets(got, want)
    assert got.bundle is not None and got.num_phys_features < 2200 // 4
    assert (got.phys_max_bins() > 256).all()


def test_sparse_training_and_prediction_equal_dense():
    Xs, Xd, y = _sparse_problem(n=2000, seed=4)
    params = {"objective": "binary", "num_leaves": 15, "max_bin": 31,
              "verbose": -1}
    on_sparse = lt.train(params, lt.Dataset(Xs, label=y), 3, device="cpu")
    on_dense = lt.train(params, lt.Dataset(Xd, label=y), 3, device="cpu")
    assert on_sparse.model_to_string() == on_dense.model_to_string()
    np.testing.assert_array_equal(on_sparse.predict(Xs),
                                  on_dense.predict(Xd))
    np.testing.assert_array_equal(on_sparse.predict(Xs, pred_leaf=True),
                                  on_dense.predict(Xd, pred_leaf=True))
    np.testing.assert_array_equal(
        on_sparse.predict(Xs[:, :20], raw_score=True),
        on_dense.predict(np.hstack([Xd[:, :20], np.zeros((2000, 10))]),
                         raw_score=True))
    with pytest.raises(lt.LightGBMError, match="number of features"):
        on_sparse.predict(sp.hstack([Xs, Xs]).tocsr())


def test_sparse_training_matches_reference(monkeypatch):
    pytest.importorskip("jax")
    import lightgbm_tpu as lgb
    monkeypatch.setenv("LGBM_TPU_FORCE_WAVE", "interpret")
    Xs, _, y = _sparse_problem(n=2000, seed=5)
    params = {"objective": "binary", "num_leaves": 15, "max_bin": 31,
              "verbose": -1}
    ref = lgb.train(params, lgb.Dataset(Xs, label=y), 3)
    port = lt.train(params, lt.Dataset(Xs, label=y), 3, device="cpu")
    for rt, pt in zip(ref._gbdt.models, port._gbdt.models, strict=True):
        nn = rt.num_leaves - 1
        assert rt.num_leaves == pt.num_leaves
        np.testing.assert_array_equal(rt.split_feature[:nn],
                                      pt.split_feature[:nn])
        np.testing.assert_array_equal(rt.threshold[:nn], pt.threshold[:nn])
        np.testing.assert_allclose(pt.leaf_value, rt.leaf_value[:nn + 1],
                                   rtol=0, atol=1e-4)
    np.testing.assert_allclose(port.predict(Xs), ref.predict(Xs), rtol=0,
                               atol=1e-4)


def test_wide_sparse_trains_on_the_serial_grower_like_reference():
    """Every EFB column wider than 256 bins: both packages take their
    serial grower (the JAX package's XLA one on the CPU)."""
    pytest.importorskip("jax")
    import lightgbm_tpu as lgb
    X, y = _wide_problem()
    ref = lgb.train(WIDE_PARAMS, lgb.Dataset(X, label=y), 3)
    port = lt.train(WIDE_PARAMS, lt.Dataset(X, label=y), 3, device="cpu")
    assert not port._gbdt.uses_wave
    for rt, pt in zip(ref._gbdt.models, port._gbdt.models, strict=True):
        nn = rt.num_leaves - 1
        assert rt.num_leaves == pt.num_leaves
        np.testing.assert_array_equal(rt.split_feature[:nn],
                                      pt.split_feature[:nn])
        np.testing.assert_array_equal(rt.threshold[:nn], pt.threshold[:nn])
        np.testing.assert_allclose(pt.leaf_value, rt.leaf_value[:nn + 1],
                                   rtol=0, atol=1e-4)
    np.testing.assert_allclose(port.predict(X), ref.predict(X), rtol=0,
                               atol=1e-4)


@pytest.mark.parametrize("source", ["trained", "loaded"])
def test_sparse_prediction_walks_the_stacked_forest(monkeypatch, source):
    """With the device route forced (as ``test_torch_predict.py`` forces
    it), a CSR walks the stacked forest on the booster's device, block by
    block of gathered columns: leaves equal to the dense input's host
    walk, raw margins within 1e-6 (f32 leaf sums), a narrower CSR as
    zero-padded dense rows."""
    from lightgbm_tpu_torch.boosting.gbdt import PredictorBase
    from lightgbm_tpu_torch.core import forest
    Xs, Xd, y = _sparse_problem(n=2000, seed=6)
    params = {"objective": "binary", "num_leaves": 15, "max_bin": 31,
              "verbose": -1}
    bst = lt.train(params, lt.Dataset(Xs, label=y), 4, device="cpu")
    if source == "loaded":
        bst = lt.Booster(model_str=bst.model_to_string(), device="cpu")
    host = {"raw": bst.predict(Xd, raw_score=True),
            "leaf": bst.predict(Xd, pred_leaf=True),
            "narrow": bst.predict(np.hstack([Xd[:, :20],
                                             np.zeros((2000, 10))]),
                                  raw_score=True)}
    monkeypatch.setattr(PredictorBase, "_DEVICE_PREDICT_MIN_WORK", 1)
    monkeypatch.setattr(PredictorBase, "_SPARSE_BLOCK_CELLS", 5000)
    before = dict(forest.calls)
    raw = bst.predict(Xs, raw_score=True)
    leaf = bst.predict(Xs, pred_leaf=True)
    narrow = bst.predict(Xs[:, :20], raw_score=True)
    ran = {k: forest.calls[k] - before[k] for k in before}
    n_used = len(bst._gbdt._sparse_window(0, 4)[0])
    blocks = -(-2000 // max(256, 5000 // n_used))
    assert ran == {"predict": 2 * blocks, "leaf": blocks}
    np.testing.assert_array_equal(leaf, host["leaf"])
    np.testing.assert_allclose(raw, host["raw"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(narrow, host["narrow"], rtol=0, atol=1e-6)
