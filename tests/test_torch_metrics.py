"""Every metric of the port against the JAX package's on the same seeded
labels, weights and raw scores (converted through the same objective), on
the CPU, weighted and unweighted: rtol 1e-6.  Also the default metric of
each objective."""
import numpy as np
import pytest
import torch

from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.io.dataset import Metadata
from lightgbm_tpu_torch.metric import create_metrics
from lightgbm_tpu_torch.objective import create_objective

N = 500
K = 4

# metric -> (objective parameters whose conversion it reads, label kind)
CASES = {
    "l2": ({"objective": "regression"}, "real"),
    "rmse": ({"objective": "regression", "reg_sqrt": True}, "real"),
    "l1": ({"objective": "regression_l1"}, "real"),
    "quantile": ({"objective": "quantile", "alpha": 0.3}, "real"),
    "huber": ({"objective": "huber", "alpha": 0.6}, "real"),
    "fair": ({"objective": "fair", "fair_c": 0.7}, "real"),
    "poisson": ({"objective": "poisson"}, "count"),
    "gamma": ({"objective": "gamma"}, "positive"),
    "gamma_deviance": ({"objective": "gamma"}, "positive"),
    "tweedie": ({"objective": "tweedie", "tweedie_variance_power": 1.2},
                "count"),
    "mape": ({"objective": "mape"}, "real"),
    "binary_logloss": ({"objective": "binary", "sigmoid": 0.9}, "binary"),
    "binary_error": ({"objective": "binary"}, "binary"),
    "auc": ({"objective": "binary"}, "binary"),
    "multi_logloss": ({"objective": "multiclass", "num_class": K}, "class"),
    "multi_error": ({"objective": "multiclass", "num_class": K}, "class"),
    "multi_error@2": ({"objective": "multiclassova", "num_class": K,
                       "multi_error_top_k": 2}, "class"),
    "auc_mu": ({"objective": "multiclass", "num_class": K}, "class"),
    "auc_mu_weighted": ({"objective": "multiclass", "num_class": K,
                         "auc_mu_weights": list(
                             (1.0 - np.eye(K)).ravel() * np.arange(
                                 1, K * K + 1) / 7.0)}, "class"),
    "cross_entropy": ({"objective": "cross_entropy"}, "prob"),
    "cross_entropy_lambda": ({"objective": "cross_entropy_lambda"}, "prob"),
    "kullback_leibler": ({"objective": "cross_entropy"}, "prob"),
    "ndcg": ({"objective": "lambdarank", "eval_at": [1, 3, 10]}, "grade"),
    "map": ({"objective": "lambdarank", "eval_at": [2, 5]}, "grade"),
}


def _labels(kind, rng):
    if kind == "real":
        return rng.normal(size=N) * 2
    if kind == "count":
        return rng.poisson(2.0, size=N).astype(np.float64)
    if kind == "positive":
        return rng.gamma(2.0, 1.5, size=N)
    if kind == "binary":
        return (rng.random(N) < 0.4).astype(np.float64)
    if kind == "class":
        return rng.integers(0, K, size=N).astype(np.float64)
    if kind == "prob":
        return rng.random(N)
    return rng.integers(0, 5, size=N).astype(np.float64)


@pytest.mark.parametrize("weighted", [False, True],
                         ids=["unweighted", "weighted"])
@pytest.mark.parametrize("case", list(CASES))
def test_metric_matches_reference(case, weighted):
    pytest.importorskip("jax")
    from lightgbm_tpu.config import Config as RefConfig
    from lightgbm_tpu.io.dataset import Metadata as RefMetadata
    from lightgbm_tpu.metric import create_metric as ref_metric
    from lightgbm_tpu.objective import create_objective as ref_objective
    params, kind = CASES[case]
    name = case.split("@")[0].replace("_weighted", "")
    params = {**params, "metric": [name], "verbose": -1}
    rng = np.random.default_rng(3)
    label = _labels(kind, rng)
    weight = rng.uniform(0.3, 2.0, size=N) if weighted else None
    group = np.diff(np.concatenate([[0], np.sort(rng.choice(
        np.arange(1, N), 30, replace=False)), [N]]))
    cfg, rcfg = Config.from_params(params), RefConfig.from_params(params)
    md, rmd = Metadata(N), RefMetadata(N)
    for m in (md, rmd):
        m.set_label(label)
        m.set_weights(weight)
        m.set_query(group)
    obj, robj = create_objective(cfg), ref_objective(rcfg)
    obj.init(md, N, "cpu")
    robj.init(rmd, N)
    k = obj.num_tree_per_iteration
    score = rng.normal(size=(N, k) if k > 1 else N)
    score = np.round(score, 2)                # tied scores for the AUCs
    [port] = create_metrics(cfg)
    ref = ref_metric(name, rcfg)
    port.init(md, N, "cpu")
    ref.init(rmd, N)
    got = port.eval(score, obj)
    want = ref.eval(score, robj)
    assert [g[0] for g in got] == [w[0] for w in want]
    assert [g[2] for g in got] == [w[2] for w in want]
    np.testing.assert_allclose([g[1] for g in got], [w[1] for w in want],
                               rtol=1e-6)
    if port.accepts_device_score:
        dev = port.eval(torch.as_tensor(score, dtype=torch.float32), obj)
        np.testing.assert_allclose([d[1] for d in dev], [w[1] for w in want],
                                   rtol=0, atol=1e-6)


@pytest.mark.parametrize("objective", [
    "regression", "regression_l1", "huber", "fair", "poisson", "quantile",
    "mape", "gamma", "tweedie", "binary", "multiclass", "multiclassova",
    "cross_entropy", "cross_entropy_lambda", "lambdarank"])
def test_default_metric_follows_reference(objective):
    pytest.importorskip("jax")
    from lightgbm_tpu.config import Config as RefConfig
    from lightgbm_tpu.metric import create_metrics as ref_metrics
    params = {"objective": objective, "verbose": -1}
    if objective.startswith("multiclass"):
        params["num_class"] = 3
    got = [m.name for m in create_metrics(Config.from_params(params))]
    want = [m.name for m in ref_metrics(RefConfig.from_params(params))]
    assert got == want and len(got) == 1
