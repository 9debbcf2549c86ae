"""TreeSHAP (``pred_contrib``): the port against the JAX package on the
same model text.

- the host recursion (``core/shap.py``) equals the JAX package's within
  1e-10 (both f64, the same recursion);
- the batched torch pass (``explain/``, here on the CPU) matches the JAX
  package's ``forest_shap_fn`` (XLA on the CPU) within 1e-5 and the f64
  oracle within 1e-5, on binary with NaN, multiclass with categorical
  features, deep trees on two features (a feature met again on a path),
  a model loaded from a file and iteration windows; on paths ~30 slots
  deep it holds the oracle, where the JAX package's pass drifts;
- local accuracy: the contributions sum to the raw score (1e-5 on the f32
  pass, 1e-10 on the f64 recursion);
- a model without cover counts raises; ``shap_cost`` is the JAX
  package's.

The models are trained by the port on the CPU and shared through model
text, so no JAX training runs here."""
import numpy as np
import pytest

import lightgbm_tpu_torch as lt

BASE = {"verbose": -1, "seed": 1, "min_data_in_leaf": 10, "max_bin": 63}


@pytest.fixture(scope="module")
def jlgb():
    pytest.importorskip("jax")
    import lightgbm_tpu
    return lightgbm_tpu


def _binary_nan(n=600, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 6))
    X[rng.random(size=X.shape) < 0.1] = np.nan
    y = (np.nan_to_num(X[:, 0]) - np.nan_to_num(X[:, 1])
         + rng.logistic(size=n) > 0).astype(np.float64)
    return X, y


def _multiclass_cat(n=900, seed=2):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 5))
    X[:, 4] = rng.integers(0, 6, size=n)
    logits = (X[:, :3] @ rng.normal(size=(3, 3))
              + np.eye(3)[X[:, 4].astype(int) % 3] * 1.5
              + rng.gumbel(size=(n, 3)))
    return X, np.argmax(logits, 1).astype(np.float64)


def _deep(n=800, seed=4):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 2))
    y = np.sin(3 * X[:, 0]) * np.cos(2 * X[:, 1]) + 0.1 * rng.normal(size=n)
    return X, y


CASES = {
    "binary_nan": (_binary_nan, {"objective": "binary", "num_leaves": 15}, 4),
    "multiclass_cat": (_multiclass_cat,
                       {"objective": "multiclass", "num_class": 3,
                        "num_leaves": 7, "categorical_feature": [4]}, 3),
    "deep_duplicates": (_deep, {"objective": "regression",
                                "num_leaves": 31}, 3),
}


@pytest.fixture(scope="module", params=list(CASES))
def case(request, tmp_path_factory):
    make, params, rounds = CASES[request.param]
    X, y = make()
    params = {**BASE, **params}
    cat = params.pop("categorical_feature", "auto")
    bst = lt.train(params, lt.Dataset(X, label=y, categorical_feature=cat),
                   rounds, device="cpu")
    path = str(tmp_path_factory.mktemp("shap") / "model.txt")
    bst.save_model(path)
    return bst, path, X[:150]


def _loaded(path):
    return lt.Booster(model_file=path, device="cpu")


def test_host_recursion_matches_reference(jlgb, case):
    from lightgbm_tpu.core.shap import predict_contrib as ref_contrib

    from lightgbm_tpu_torch.core.shap import predict_contrib
    bst, path, X = case
    ref = ref_contrib(jlgb.Booster(model_file=path)._gbdt, X[:40])
    np.testing.assert_allclose(predict_contrib(bst._gbdt, X[:40]), ref,
                               rtol=0, atol=1e-10)
    np.testing.assert_allclose(
        ref.reshape(40, bst.num_model_per_iteration(), -1).sum(-1),
        bst.predict(X[:40], raw_score=True).reshape(40, -1), rtol=0,
        atol=1e-10)


@pytest.mark.parametrize("source", ["trained", "loaded"])
@pytest.mark.parametrize("window", [(0, None), (1, 2)],
                         ids=["all", "window"])
def test_device_pass_matches_reference_and_oracle(jlgb, case, source,
                                                  window):
    from lightgbm_tpu_torch.core.shap import predict_contrib as oracle
    bst, path, X = case
    start, num = window
    gbdt = bst._gbdt if source == "trained" else _loaded(path)._gbdt
    stop = start + num if num else gbdt.current_iteration()
    got = gbdt._predict_contrib_device(X, start, stop)
    ref_gbdt = jlgb.Booster(model_file=path)._gbdt
    ref = ref_gbdt._predict_contrib_device(X, start, stop)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, oracle(gbdt, X, num, start), rtol=0,
                               atol=1e-5)
    # local accuracy
    K = gbdt.num_tpi
    raw = gbdt.predict_raw(X, num, start)
    np.testing.assert_allclose(got.reshape(len(X), K, -1).sum(-1),
                               raw.reshape(len(X), K), rtol=0, atol=1e-5)


def test_booster_routes_by_work(case, monkeypatch):
    """Booster.predict(pred_contrib=True): the host recursion below the
    work threshold, the batched pass at or above it (LGBM_TPU_CONTRIB_
    MIN_WORK), one layout either way."""
    from lightgbm_tpu_torch.explain import kernel
    bst, _, X = case
    before = kernel.calls["shap"]
    host = bst.predict(X[:20], pred_contrib=True)
    assert kernel.calls["shap"] == before
    monkeypatch.setenv("LGBM_TPU_CONTRIB_MIN_WORK", "1")
    dev = bst.predict(X[:20], pred_contrib=True)
    assert kernel.calls["shap"] == before + 1
    K = bst.num_model_per_iteration()
    assert host.shape == dev.shape == (20, K * (X.shape[1] + 1))
    np.testing.assert_allclose(dev, host, rtol=0, atol=1e-5)


def test_model_without_counts_raises(case, tmp_path, monkeypatch):
    _, path, X = case
    with open(path) as fh:
        text = [ln for ln in fh.read().split("\n")
                if not ln.startswith(("internal_count=", "leaf_count="))]
    stripped = tmp_path / "nocounts.txt"
    stripped.write_text("\n".join(text))
    bst = _loaded(str(stripped))
    monkeypatch.setenv("LGBM_TPU_CONTRIB_MIN_WORK", "0")
    with pytest.raises(ValueError, match="cover counts"):
        bst.predict(X[:5], pred_contrib=True)


def test_deep_paths_match_oracle():
    """A one-hot chain: 40 columns, each split peeling one category, paths
    about 30 slots deep.  The pass skips the pad slots and unwinds in f64,
    so it holds the f64 recursion within 1e-5 and local accuracy here,
    where the JAX package's f32 pass with identity pads is ~1e-2 off
    (explain/kernel.py)."""
    from lightgbm_tpu_torch.core.shap import predict_contrib as oracle
    rng = np.random.default_rng(5)
    n, C = 3000, 40
    p = 0.8 ** np.arange(C)
    cat = rng.choice(C, size=n, p=p / p.sum())
    X = np.hstack([rng.normal(size=(n, 2)), np.eye(C)[cat]])
    y = rng.normal(size=C)[cat] * 3 + 0.1 * X[:, 0]
    bst = lt.train({"objective": "regression", "num_leaves": 63,
                    "min_data_in_leaf": 2, "min_sum_hessian_in_leaf": 0,
                    "enable_bundle": False, "verbose": -1},
                   lt.Dataset(X, label=y), 2, device="cpu")
    g = bst._gbdt
    got = g._predict_contrib_device(X[:100], 0, 2)
    assert g._contrib_cache[2].path_node.shape[2] >= 25
    np.testing.assert_allclose(got, oracle(g, X[:100]), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.sum(1), bst.predict(X[:100]), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("shape", [(1000, 5, 255, 14, 28, 1),
                                   (7, 35, 31, 9, 54, 7)])
def test_shap_cost_matches_reference(jlgb, shape):
    from lightgbm_tpu.ops.treeshap import shap_cost as ref_cost

    from lightgbm_tpu_torch.ops.treeshap import shap_cost
    assert shap_cost(*shape) == ref_cost(*shape)


@pytest.mark.cuda
def test_card_contrib_matches_cpu(tmp_path):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the device pass runs there")
    X, y = _binary_nan()
    params = {**BASE, "objective": "binary", "num_leaves": 15}
    cpu = lt.train(params, lt.Dataset(X, label=y), 4, device="cpu")
    path = str(tmp_path / "m.txt")
    cpu.save_model(path)
    card = lt.Booster(model_file=path, device="cuda")
    got = card._gbdt._predict_contrib_device(X, 0, 4)
    np.testing.assert_allclose(
        got, cpu._gbdt._predict_contrib_device(X, 0, 4), rtol=0, atol=1e-5)
