"""The port's training slice against the JAX package on a seeded binary
problem: identical trees, scores within f32 rounding, and model text the
JAX package loads and predicts with identically.  The JAX side runs its
wave grower through the Pallas interpreter (LGBM_TPU_FORCE_WAVE)."""
import numpy as np
import pytest

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import convert

PARAMS = {"objective": "binary", "num_leaves": 31, "max_bin": 63,
          "learning_rate": 0.1, "min_data_in_leaf": 20, "verbose": -1,
          "metric": ["binary_logloss", "auc"]}
ROUNDS = 5


def _data(n=3000, f=10, seed=0):
    """Well separated for both packages.  No NaNs: a NaN feature's two scan
    directions give the same partition in any leaf without NaN rows (every
    descendant of a split on it), and f32 summation order then breaks that
    exact tie either way.  The split search's NaN routing is held against
    the reference in test_torch_splitter.py on identical histograms."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f))
    X[:, 3] = np.round(X[:, 3])           # many exact zeros in one column
    logit = X[:, 0] - 0.8 * X[:, 1] + X[:, 2] * X[:, 4] + 0.5 * X[:, 3]
    y = (logit + rng.logistic(size=n) > 0).astype(np.float64)
    return X, y


@pytest.fixture(scope="module")
def trained():
    jax = pytest.importorskip("jax")
    del jax
    import lightgbm_tpu as lgb
    X, y = _data()
    mp = pytest.MonkeyPatch()
    mp.setenv("LGBM_TPU_FORCE_WAVE", "interpret")
    try:
        ref = lgb.train(PARAMS, lgb.Dataset(X, label=y), ROUNDS)
    finally:
        mp.undo()
    port = lt.train(PARAMS, lt.Dataset(X, label=y), ROUNDS, device="cpu")
    return X, y, ref, port


def test_trees_identical(trained):
    _, _, ref, port = trained
    ref_trees, port_trees = ref._gbdt.models, port._gbdt.models
    assert len(ref_trees) == len(port_trees) == ROUNDS
    for rt, pt in zip(ref_trees, port_trees):
        assert rt.num_leaves == pt.num_leaves
        nn = rt.num_leaves - 1
        np.testing.assert_array_equal(rt.split_feature[:nn], pt.split_feature)
        np.testing.assert_array_equal(rt.threshold[:nn], pt.threshold)
        np.testing.assert_array_equal(rt.decision_type[:nn], pt.decision_type)
        np.testing.assert_array_equal(rt.left_child[:nn], pt.left_child)
        np.testing.assert_array_equal(rt.right_child[:nn], pt.right_child)
        np.testing.assert_array_equal(rt.leaf_count, pt.leaf_count)
        # a leaf's sums come from f32 prefix sums over up to 63 bins whose
        # partial sums reach ~1e3; the two packages add in different
        # orders, so a 20-row leaf (hessian ~5) sees ~1e-3 in its gradient
        # sum: ~2e-5 in its value after the 0.1 learning rate
        np.testing.assert_allclose(pt.leaf_value, rt.leaf_value, rtol=0,
                                   atol=1e-4)


def test_raw_scores_match(trained):
    _, _, ref, port = trained
    np.testing.assert_allclose(port._gbdt._train_score.numpy(),
                               ref._raw_train_score(), rtol=0, atol=1e-4)


def test_model_text_loads_in_reference(trained):
    import lightgbm_tpu as lgb
    X, _, _, port = trained
    X = X.copy()
    X[::7, 2] = np.nan          # missing inputs route as the zero value
    loaded = lgb.Booster(model_str=port.model_to_string())
    np.testing.assert_allclose(loaded.predict(X), port.predict(X),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(loaded.predict(X, raw_score=True),
                               port.predict(X, raw_score=True),
                               rtol=0, atol=1e-6)


def test_metrics_track_training(trained):
    """Train logloss falls every iteration and the reported metrics agree
    with the reference package's metric code on the same scores."""
    from lightgbm_tpu.metric.basic import AUCMetric
    X, y, _, _ = trained
    hist = {}
    ds = lt.Dataset(X, label=y)
    port = lt.train(PARAMS, ds, ROUNDS, valid_sets=[ds],
                    valid_names=["train"], evals_result=hist, device="cpu")
    loss = hist["train"]["binary_logloss"]
    assert all(b < a for a, b in zip(loss, loss[1:]))
    ref_auc = AUCMetric(None)
    ref_auc.label = y.astype(np.float32)
    ref_auc.weights = None
    want = ref_auc.eval(port._gbdt._train_score.double().numpy(), None)[0][1]
    assert hist["train"]["auc"][-1] == pytest.approx(want, abs=1e-12)


def test_convert_round_trips(trained):
    """convert.py carries the reference's device metadata, trees and binned
    dataset into the port unchanged."""
    import jax
    import lightgbm_tpu as lgb
    from lightgbm_tpu.core.meta import build_device_meta as ref_meta
    X, y, ref, _ = trained
    ds = lgb.Dataset(X, label=y, params=PARAMS).construct()._handle
    meta, B = ref_meta(ds)
    fields = {k: np.asarray(v) for k, v in meta._asdict().items()}
    port_meta = convert.meta_from_numpy(fields, "cpu")
    for k in port_meta._fields:
        np.testing.assert_array_equal(getattr(port_meta, k).numpy(), fields[k])

    arrs = jax.device_get(ref._gbdt._tree_to_device(ref._gbdt.models[0]))
    d = {k: np.asarray(v) for k, v in arrs._asdict().items()}
    back = convert.tree_arrays_to_numpy(convert.tree_arrays_from_numpy(d, "cpu"))
    for k, v in back.items():
        np.testing.assert_array_equal(v, d[k].astype(v.dtype))

    pds = convert.dataset_from_numpy(ds.X_bin, [m.to_dict() for m in ds.bin_mappers])
    np.testing.assert_array_equal(pds.X_bin, ds.X_bin)
    np.testing.assert_array_equal(pds.real_feature_idx, ds.real_feature_idx)
    from lightgbm_tpu_torch.core.meta import build_device_meta
    pm, pB = build_device_meta(pds, None, "cpu")
    assert pB == B
    for k in pm._fields:
        np.testing.assert_array_equal(getattr(pm, k).numpy(), fields[k])


@pytest.mark.parametrize("params", [
    # the profiler window and the train board (item 8B) were the last
    # knobs outside the slice; they train since obs/xprof.py and
    # obs/board.py were ported (as the online knobs do:
    # test_torch_online_loop.py test_online_knobs_train; the parallel
    # learners and the serving store: test_parallel_knobs_train_at_world_one;
    # the ingest and fleet families: test_ingest_and_fleet_knobs_train)
    {"tpu_xprof": True}, {"tpu_xprof_iters": 9},
    {"tpu_train_metrics_port": 0}])
def test_outside_the_slice_is_refused(params):
    """Nothing is outside the slice any more: each knob that was refused
    trains, and the board it arms is stopped when training ends."""
    from lightgbm_tpu_torch import obs
    from lightgbm_tpu_torch.obs import board
    X, y = _data(n=300)
    try:
        bst = lt.train({**PARAMS, **params}, lt.Dataset(X, label=y), 3,
                       device="cpu")
    finally:
        obs.reset()
    assert bst.num_trees() == 3 and not board.active()


@pytest.mark.parametrize("params", [
    {"tpu_fleet": 2}, {"tpu_fleet_dir": "fleet"},
    {"tpu_fleet_heartbeat_s": 5.0}, {"tpu_fleet_transport": "host"},
    {"tpu_ingest": True}, {"tpu_ingest_chunk_rows": 1000},
    {"tpu_ingest_memmap": "mm"}, {"tpu_ingest_shards": 2},
    {"tpu_fleet_min_ranks": 2}])
def test_ingest_and_fleet_knobs_train(params):
    """The ingest and fleet knobs are accepted by ``train`` on an
    in-memory Dataset, where they change nothing: the fleet runs from
    the CLI (``tpu_fleet``) and ingestion from a stream
    (``ingest.dataset_from_stream``, ``tpu_ingest=true`` files)."""
    X, y = _data(n=300)
    bst = lt.train({**PARAMS, **params}, lt.Dataset(X, label=y), 1,
                   device="cpu")
    ref = lt.train(PARAMS, lt.Dataset(X, label=y), 1, device="cpu")
    assert bst.model_to_string().split("parameters:")[0] == \
        ref.model_to_string().split("parameters:")[0]


@pytest.mark.parametrize("params", [
    {"tpu_mesh_shape": "data:2"}, {"tree_learner": "feature"},
    {"tree_learner": "data"}, {"tree_learner": "voting"},
    {"tree_learner": "data_parallel"}, {"tree_learner": "voting_parallel"},
    {"tree_learner": "feature_parallel", "top_k": 3},
    {"tpu_serve_aot_dir": "aot"}])
def test_parallel_knobs_train_at_world_one(params):
    """The parallel learners run in one process as a world of one rank
    (the collectives as identities); the serving store's directory is a
    serving knob, which training accepts.  One intra-op thread: the serial
    grower's small ops crawl under a parallel run's oversubscribed
    threads."""
    import torch
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        X, y = _data(n=300)
        bst = lt.train({**PARAMS, **params}, lt.Dataset(X, label=y), 2,
                       device="cpu")
    finally:
        torch.set_num_threads(prev)
    assert bst.num_trees() == 2
    learner = bst._gbdt.config.tree_learner
    assert learner in ("serial", "data", "feature", "voting")
    if learner != "serial":
        assert bst._gbdt._mesh.size == 1


def test_num_machines_without_a_rank_is_fatal(monkeypatch):
    """Two machines and nothing naming this process's rank: the trainer
    cannot join a group (the JAX package would wait on cluster
    auto-detection)."""
    for var in ("RANK", "LGBM_TPU_RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    X, y = _data(n=300)
    with pytest.raises(lt.LightGBMError, match="rank"):
        lt.train({**PARAMS, "num_machines": 2, "tree_learner": "data"},
                 lt.Dataset(X, label=y), 1, device="cpu")


def test_no_cpu_fallback_for_cuda():
    if torch_cuda_available():
        pytest.skip("a CUDA card is present")
    X, y = _data(n=300)
    with pytest.raises(lt.LightGBMError, match="cuda"):
        lt.train(PARAMS, lt.Dataset(X, label=y), 1)


def torch_cuda_available():
    import torch
    return torch.cuda.is_available()


@pytest.mark.cuda
def test_card_training_matches_cpu():
    """The card's K1 against the CPU's plain K1 inside a whole run."""
    if not torch_cuda_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    X, y = _data()
    cpu = lt.train(PARAMS, lt.Dataset(X, label=y), ROUNDS, device="cpu")
    card = lt.train(PARAMS, lt.Dataset(X, label=y), ROUNDS, device="cuda")
    for a, b in zip(cpu._gbdt.models, card._gbdt.models):
        np.testing.assert_array_equal(a.split_feature, b.split_feature)
        np.testing.assert_array_equal(a.threshold, b.threshold)
    np.testing.assert_allclose(card.predict(X), cpu.predict(X), atol=1e-4)


@pytest.mark.parametrize("knob", [
    {"monotone_constraints": [1, -1, 0, 1, 0, 0, 0, 0, 0, 0]},
    {"feature_fraction": 0.7},
    {"lambda_l1": 0.5, "lambda_l2": 2.0},
    {"min_gain_to_split": 1.0},
    {"is_unbalance": True},
    {"scale_pos_weight": 2.0},
    {"max_depth": 4},
    {"min_sum_hessian_in_leaf": 5.0},
    {"feature_contri": [1.0, 0.5, 1.0, 0.8, 1.0, 1.0, 0.3, 1.0, 1.0, 1.0]},
    {"sigmoid": 0.7}], ids=lambda k: "-".join(k))
def test_knob_trees_identical(knob):
    """Each knob the port accepts grows the JAX package's trees on the
    seeded problem (ROADMAP fault 3.3's probe found these free of
    near-ties): 3 rounds, identical structure, leaf values within
    test_trees_identical's 1e-4, over sigmoid^2 (a leaf's hessian scales
    with it, so the same f32 summation error moves its value more)."""
    pytest.importorskip("jax")
    import lightgbm_tpu as lgb
    X, y = _data()
    params = {**PARAMS, **knob}
    mp = pytest.MonkeyPatch()
    mp.setenv("LGBM_TPU_FORCE_WAVE", "interpret")
    try:
        ref = lgb.train(params, lgb.Dataset(X, label=y), 3)
    finally:
        mp.undo()
    port = lt.train(params, lt.Dataset(X, label=y), 3, device="cpu")
    assert len(ref._gbdt.models) == len(port._gbdt.models) == 3
    for rt, pt in zip(ref._gbdt.models, port._gbdt.models):
        assert rt.num_leaves == pt.num_leaves
        nn = rt.num_leaves - 1
        for name in ("split_feature", "threshold", "decision_type",
                     "left_child", "right_child"):
            np.testing.assert_array_equal(getattr(pt, name),
                                          getattr(rt, name)[:nn])
        np.testing.assert_array_equal(pt.leaf_count, rt.leaf_count)
        np.testing.assert_allclose(pt.leaf_value, rt.leaf_value, rtol=0,
                                   atol=1e-4 / knob.get("sigmoid", 1.0) ** 2)
