"""The port's objectives against the JAX package's on the same seeded
labels, weights and scores, on the CPU: gradients and hessians,
``boost_from_score``, ``convert_output`` and the percentile leaf refits,
weighted and unweighted, one case per objective.

Tolerance: f32 values at rtol 1e-6, with an absolute floor of 1e-6 of the
array's largest magnitude (a gradient such as exp(s) - y cancels, and the
two packages' exp may differ by an ulp); the host-side values (the
starting score, the output conversion, the refits) are the same numpy
arithmetic in both packages and are held at 1e-12."""
import numpy as np
import pytest
import torch

from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.io.dataset import Metadata
from lightgbm_tpu_torch.objective import create_objective

N = 600
K = 3

# objective -> (extra parameters, label kind)
CASES = {
    "regression": ({}, "real"),
    "regression_sqrt": ({"objective": "regression", "reg_sqrt": True},
                        "real"),
    "regression_l1": ({}, "real"),
    "huber": ({"alpha": 0.7}, "real"),
    "fair": ({"fair_c": 0.5}, "real"),
    "poisson": ({"poisson_max_delta_step": 0.5}, "count"),
    "quantile": ({"alpha": 0.3}, "real"),
    "mape": ({}, "real"),
    "gamma": ({}, "positive"),
    "tweedie": ({"tweedie_variance_power": 1.3}, "count"),
    "binary": ({"scale_pos_weight": 1.5}, "binary"),
    "multiclass": ({"num_class": K}, "class"),
    "multiclassova": ({"num_class": K, "sigmoid": 0.8}, "class"),
    "cross_entropy": ({}, "prob"),
    "cross_entropy_lambda": ({}, "prob"),
    "lambdarank": ({"max_position": 5}, "grade"),
}


def _labels(kind, rng):
    if kind == "real":
        return rng.normal(size=N) * 3
    if kind == "count":
        return rng.poisson(2.0, size=N).astype(np.float64)
    if kind == "positive":
        return rng.gamma(2.0, 1.5, size=N)
    if kind == "binary":
        return (rng.random(N) < 0.3).astype(np.float64)
    if kind == "class":
        return rng.integers(0, K, size=N).astype(np.float64)
    if kind == "prob":
        return rng.random(N)
    return rng.integers(0, 5, size=N).astype(np.float64)


def _pair(name, weighted, seed=0):
    """The JAX package's and the port's objective, bound to the same rows;
    and the raw scores to evaluate."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from lightgbm_tpu.config import Config as RefConfig
    from lightgbm_tpu.io.dataset import Metadata as RefMetadata
    from lightgbm_tpu.objective import create_objective as ref_create
    extra, kind = CASES[name]
    params = {"objective": name, "verbose": -1, **extra}
    rng = np.random.default_rng(seed)
    label = _labels(kind, rng)
    weight = rng.uniform(0.2, 2.0, size=N) if weighted else None
    group = np.diff(np.concatenate([[0], np.sort(rng.choice(
        np.arange(1, N), 24, replace=False)), [N]]))
    objs = []
    for cfg, md in ((RefConfig.from_params(params), RefMetadata(N)),
                    (Config.from_params(params), Metadata(N))):
        md.set_label(label)
        md.set_weights(weight)
        md.set_query(group)
        objs.append((cfg, md))
    ref = ref_create(objs[0][0])
    ref.init(objs[0][1], N)
    port = create_objective(objs[1][0])
    port.init(objs[1][1], N, "cpu")
    k = port.num_tree_per_iteration
    score = rng.normal(size=(N, k) if k > 1 else N).astype(np.float32)
    if kind in ("count", "positive"):
        score = score * 0.5
    return ref, port, score, jnp


def _close(got, want):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=1e-6,
                               atol=1e-6 * float(np.abs(want).max()))


@pytest.mark.parametrize("weighted", [False, True],
                         ids=["unweighted", "weighted"])
@pytest.mark.parametrize("name", list(CASES))
def test_objective_matches_reference(name, weighted):
    ref, port, score, jnp = _pair(name, weighted)
    assert port.num_tree_per_iteration == ref.num_tree_per_iteration
    g_r, h_r = ref.get_gradients(jnp.asarray(score))
    g_p, h_p = port.get_gradients(torch.as_tensor(score))
    assert g_p.dtype == torch.float32 and g_p.shape == tuple(g_r.shape)
    _close(g_p.numpy(), g_r)
    _close(h_p.numpy(), h_r)
    K_ = port.num_tree_per_iteration
    for k in range(K_):
        assert port.boost_from_score(k) == pytest.approx(
            ref.boost_from_score(k), rel=1e-12, abs=1e-12)
        assert port.class_need_train(k) == ref.class_need_train(k)
    raw = score.astype(np.float64)
    np.testing.assert_allclose(port.convert_output(raw),
                               ref.convert_output(raw), rtol=1e-12)
    assert port.is_renew_tree_output == ref.is_renew_tree_output
    if port.is_renew_tree_output:
        rng = np.random.default_rng(1)
        residual = rng.normal(size=N)
        leaf_id = rng.integers(0, 7, size=N)
        bag = rng.random(N) < 0.8
        bag[leaf_id == 6] = False            # an empty leaf keeps its value
        want = ref.renew_leaf_values(residual, leaf_id, 7, bag)
        got = port.renew_leaf_values(residual, leaf_id, 7, bag)
        assert np.isnan(got[6]) and np.isnan(want[6])
        np.testing.assert_allclose(got, want, rtol=1e-12)


@pytest.mark.parametrize("weighted", [False, True],
                         ids=["unweighted", "weighted"])
def test_percentile_matches_reference(weighted):
    """The weighted and unweighted percentile (the L1, quantile and MAPE
    refits and starting scores) on ragged inputs, ties included."""
    pytest.importorskip("jax")
    from lightgbm_tpu.objective.base import percentile as ref_pct
    from lightgbm_tpu_torch.objective.base import percentile
    rng = np.random.default_rng(2)
    for n in (0, 1, 2, 5, 40, 301):
        v = np.round(rng.normal(size=n), 1)
        w = (rng.uniform(0.1, 3.0, size=n).astype(np.float32) if weighted
             else None)
        for alpha in (0.05, 0.3, 0.5, 0.9, 0.99):
            assert percentile(v, w, alpha) == ref_pct(v, w, alpha)


def test_multiclass_hessian_is_the_reference_factor():
    """The JAX package's multiclass hessian is 2·p·(1 - p), not the
    reference's K/(K-1) factor; the port keeps it."""
    _, port, score, _ = _pair("multiclass", False)
    p = torch.softmax(torch.as_tensor(score), dim=1)
    _, h = port.get_gradients(torch.as_tensor(score))
    assert torch.equal(h, 2.0 * p * (1.0 - p))
