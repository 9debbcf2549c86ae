"""Training every objective family end to end in the port against the JAX
package on the CPU (the JAX side's wave grower through the Pallas
interpreter, LGBM_TPU_FORCE_WAVE=interpret): 2,000 rows x 8 features, 15
leaves, 3 rounds, 57 queries for lambdarank.

Held: the trees identical in structure; each leaf value within 5e-5 of its
tree's largest |leaf value| (the two packages sum f32 histograms in
different orders: measured up to 3.1e-5, cross_entropy's first tree);
predictions within rtol 1e-5 / atol 1e-5; the port's model text loaded
by the JAX package predicting the port's values within 1e-6.  The int16
cases hold the same structure and leaf values within 3e-4 of the tree's
largest (measured 1.1e-4): an ulp of difference in a row's gradient
(exp, log2 and the pair sums differ in the last bits between XLA and
torch) re-draws that row's stochastic rounding, one quantum of its leaf's
sums.  The fixtures have no near-tied split (ROADMAP fault 3.3)."""
import numpy as np
import pytest

import lightgbm_tpu_torch as lt

N, F = 2000, 8
BASE = {"num_leaves": 15, "max_bin": 63, "min_data_in_leaf": 20,
        "learning_rate": 0.1, "verbose": -1}
ROUNDS = 3


@pytest.fixture(scope="module", autouse=True)
def _one_cpu_thread():
    """One intra-op thread for the module, its module-scoped trainings
    included: a parallel test run shares the machine among its workers,
    and torch's CPU thread pool then spends most of a small op waiting
    for oversubscribed threads.  Restored after the module."""
    import torch
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _data():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(N, F))
    w = rng.uniform(0.5, 1.5, N)
    y3 = np.argmax(X[:, :3] + 0.3 * rng.normal(size=(N, 3)),
                   axis=1).astype(np.float64)
    yr = X[:, 0] + X[:, 1] ** 2 + 0.1 * rng.normal(size=N)
    sizes = rng.integers(5, 60, size=60)
    sizes = sizes[np.cumsum(sizes) <= N]
    grade = rng.integers(0, 5, size=int(sizes.sum())).astype(np.float64)
    return X, w, y3, yr, sizes, grade


# case -> (parameters, label, weighted, grouped)
CASES = {
    "regression_weighted": ({"objective": "regression"}, "yr", True, False),
    "regression_l1": ({"objective": "regression_l1"}, "yr", False, False),
    "quantile": ({"objective": "quantile", "alpha": 0.8}, "yr", False,
                 False),
    "huber": ({"objective": "huber"}, "yr", False, False),
    "poisson": ({"objective": "poisson"}, "exp", False, False),
    "multiclass": ({"objective": "multiclass", "num_class": 3}, "y3", False,
                   False),
    "multiclassova": ({"objective": "multiclassova", "num_class": 3}, "y3",
                      False, False),
    "cross_entropy": ({"objective": "cross_entropy"}, "prob", False, False),
    "lambdarank": ({"objective": "lambdarank"}, "grade", False, True),
    "regression_int16": ({"objective": "regression",
                          "tpu_hist_dtype": "int16"}, "yr", False, False),
    "lambdarank_int16": ({"objective": "lambdarank",
                          "tpu_hist_dtype": "int16"}, "grade", False, True),
}


@pytest.fixture(scope="module")
def trained():
    """Each case trained once by both packages, on first use."""
    pytest.importorskip("jax")
    import lightgbm_tpu as lgb
    X, w, y3, yr, sizes, grade = _data()
    labels = {"yr": yr, "y3": y3, "exp": np.exp(X[:, 0]),
              "prob": 1.0 / (1.0 + np.exp(-X[:, 0])), "grade": grade}
    cache = {}

    def get(case):
        if case not in cache:
            params, lab, weighted, grouped = CASES[case]
            params = {**BASE, **params}
            y = labels[lab]
            Xc = X[:len(y)]
            kw = dict(label=y, weight=w[:len(y)] if weighted else None,
                      group=sizes if grouped else None)
            mp = pytest.MonkeyPatch()
            mp.setenv("LGBM_TPU_FORCE_WAVE", "interpret")
            try:
                ref = lgb.train(params, lgb.Dataset(Xc, **kw), ROUNDS)
            finally:
                mp.undo()
            port = lt.train(params, lt.Dataset(Xc, **kw), ROUNDS,
                            device="cpu")
            cache[case] = (Xc, ref, port)
        return cache[case]
    return get


@pytest.mark.parametrize("case", list(CASES))
def test_trees_identical(trained, case):
    _, ref, port = trained(case)
    rts, pts = ref._gbdt.models, port._gbdt.models
    K = port._gbdt.num_tpi
    assert K == ref._gbdt.num_tpi
    assert len(rts) == len(pts) == ROUNDS * K
    tol = 3e-4 if "int16" in case else 5e-5
    for rt, pt in zip(rts, pts):
        assert rt.num_leaves == pt.num_leaves
        nn = rt.num_leaves - 1
        for name in ("split_feature", "threshold", "decision_type",
                     "left_child", "right_child"):
            np.testing.assert_array_equal(getattr(pt, name),
                                          getattr(rt, name)[:nn])
        np.testing.assert_array_equal(pt.leaf_count, rt.leaf_count)
        want = rt.leaf_value[:rt.num_leaves]
        np.testing.assert_allclose(pt.leaf_value, want, rtol=0,
                                   atol=tol * np.abs(want).max())


@pytest.mark.parametrize("case", list(CASES))
def test_predictions_match(trained, case):
    X, ref, port = trained(case)
    tol = 1e-4 if "int16" in case else 1e-5
    for raw in (False, True):
        np.testing.assert_allclose(port.predict(X, raw_score=raw),
                                   ref.predict(X, raw_score=raw),
                                   rtol=tol, atol=tol)


@pytest.mark.parametrize("case", list(CASES))
def test_model_text_loads_in_reference(trained, case):
    import lightgbm_tpu as lgb
    X, _, port = trained(case)
    text = port.model_to_string()
    loaded = lgb.Booster(model_str=text)
    for raw in (False, True):
        np.testing.assert_allclose(loaded.predict(X, raw_score=raw),
                                   port.predict(X, raw_score=raw), rtol=0,
                                   atol=1e-6)
    back = lt.Booster(model_str=text, device="cpu")
    np.testing.assert_allclose(back.predict(X), port.predict(X), rtol=0,
                               atol=1e-6)


def test_multiclass_gradients_once_per_iteration(trained):
    """Class 1's tree of iteration 0 is the JAX package's: it is grown on
    the gradients of the iteration's starting score, not on a score that
    already holds class 0's tree."""
    _, ref, port = trained("multiclass")
    rt, pt = ref._gbdt.models[1], port._gbdt.models[1]
    nn = rt.num_leaves - 1
    assert rt.num_leaves == pt.num_leaves > 2
    np.testing.assert_array_equal(pt.split_feature, rt.split_feature[:nn])
    np.testing.assert_array_equal(pt.threshold, rt.threshold[:nn])
    np.testing.assert_allclose(pt.leaf_value, rt.leaf_value[:rt.num_leaves],
                               rtol=0, atol=5e-5 * np.abs(rt.leaf_value).max())
    # the score after iteration 0 is the starting score plus the K trees,
    # each on its own column
    gb = port._gbdt
    assert tuple(gb._train_score.shape) == (N, 3)


def test_metrics_fall_and_late_valid_replays(trained):
    """Multiclass logloss falls every round; a valid set attached after
    training replays the per-class constants and trees to the training
    score, bit for bit."""
    X, _, _ = trained("multiclass")
    _, _, y3, _, _, _ = _data()
    params = {**BASE, **CASES["multiclass"][0],
              "metric": ["multi_logloss", "multi_error"]}
    ds = lt.Dataset(X, label=y3)
    hist = {}
    bst = lt.train(params, ds, ROUNDS, valid_sets=[ds], valid_names=["t"],
                   evals_result=hist, device="cpu")
    loss = hist["t"]["multi_logloss"]
    assert all(b < a for a, b in zip(loss, loss[1:]))
    late = lt.Dataset(X, label=y3, reference=ds)
    bst.add_valid(late, "late")
    gb = bst._gbdt
    assert np.array_equal(gb._valid_scores[-1].numpy(),
                          gb._train_score.numpy())
