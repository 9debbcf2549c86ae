"""Leaf refit and the model's own bin space (``lightgbm_tpu_torch/online/
refit.py`` and ``binspace.py``, ``GBDT.refit_models``, ``Booster.refit``)
against the JAX package's (twins of the refit and continue cases of
tests/test_online.py), on the CPU.

The models are trained by the port from numpy-seeded rows and saved; both
packages load the same model text and refit it on the same new rows:

- per leaf, the port's device refit (its torch steps, run here on CPU
  tensors) within 1e-6 of the JAX package's host oracle
  (``tpu_refit_device=false``) and of the port's own host oracle, on
  binary at decay 0 and 0.9, L1/L2/``max_delta_step``, categorical with
  NaN, and multiclass;
- the ``refit`` event of both paths, valid under the JAX package's schema;
- the model's own bin space: its mappers bin NaN, negative, fractional
  and unseen values as the JAX package's; replaying the forest onto new
  rows with NaNs and unseen categories gives the host walk's raw scores
  and the JAX package's replay; continued trees
  equal the JAX package's on a well-separated fixture (ROADMAP fault
  3.3's near-tie caveat), with thresholds from the base model's set;
  unused features stay out of the continue dataset.

The JAX package's 2-device mesh case (``test_device_refit_matches_host_
mesh_2dev``) has its twin in two gloo ranks of the data-parallel learner
(``test_device_refit_matches_host_two_ranks``).  The card-only cases (marked ``cuda``) hold the refit on the card against
the host oracle and against itself, byte for byte."""
import importlib

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import obs
from lightgbm_tpu_torch.online import continue_dataset, train_continue

PARAMS = {"objective": "binary", "num_leaves": 15, "learning_rate": 0.1,
          "min_data_in_leaf": 5, "verbose": -1}
REFIT_ATOL = 1e-6


@pytest.fixture(scope="module")
def jlgb():
    pytest.importorskip("jax")
    import lightgbm_tpu
    return lightgbm_tpu


@pytest.fixture(autouse=True)
def _obs_clean():
    yield
    obs.disable()
    obs.reset()


@pytest.fixture(autouse=True)
def _one_cpu_thread():
    """One intra-op thread a test: a parallel test run shares the machine
    among its workers, and torch's CPU thread pool then spends most of a
    small op waiting for oversubscribed threads (these tests ran 10-60x
    slower there).  Restored after each test."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _problem(n=1200, seed=0, f=6):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f))
    y = (X[:, 0] + X[:, 1] * X[:, 2] + 0.2 * rng.normal(size=n) > 0)
    return X, y.astype(np.float64)


def _cat_nan_problem(n=1000, seed=3, unseen=False):
    """Categorical feature 3 and NaNs everywhere: category bitsets and
    default-left routing both ways.  ``unseen`` adds categories the model
    never saw."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 5))
    hi = 12 if unseen else 8
    X[:, 3] = rng.integers(0, hi, size=n).astype(np.float64)
    X[rng.random((n, 5)) < 0.08] = np.nan
    y = (np.nan_to_num(X[:, 0]) + (X[:, 3] == 3) > 0.3)
    return X, y.astype(np.float64)


def _multiclass(n, rng):
    X = rng.normal(size=(n, 5))
    y = (X[:, 0] > 0).astype(int) + (X[:, 1] > 0.5).astype(int)
    return X, y.astype(np.float64)


def _model_file(tmp_path, params, X, y, rounds):
    bst = lt.train(params, lt.Dataset(X, label=y), rounds, device="cpu")
    path = str(tmp_path / "model.txt")
    bst.save_model(path)
    return path


def _worst(a, b):
    worst = 0.0
    for ta, tb in zip(a._gbdt.models, b._gbdt.models):
        assert ta.num_leaves == tb.num_leaves
        np.testing.assert_array_equal(ta.split_feature[:ta.num_leaves - 1],
                                      tb.split_feature[:tb.num_leaves - 1])
        worst = max(worst, float(np.max(np.abs(ta.leaf_value
                                               - tb.leaf_value))))
    return worst


def _cases():
    mc = {"objective": "multiclass", "num_class": 3, "num_leaves": 7,
          "min_data_in_leaf": 5, "verbose": -1}
    cat = dict(PARAMS, num_leaves=12, categorical_feature="3")
    l1l2 = dict(PARAMS, lambda_l1=0.3, lambda_l2=2.0, max_delta_step=0.05)
    return {
        "binary-decay0": (PARAMS, lambda: _problem(),
                          lambda: _problem(n=900, seed=7), 8, 0.0, {}),
        "binary-decay0.9": (PARAMS, lambda: _problem(),
                            lambda: _problem(n=900, seed=7), 8, 0.9, {}),
        "l1-l2-max-delta": (l1l2, lambda: _problem(seed=11),
                            lambda: _problem(n=800, seed=13), 6, 0.4,
                            {"lambda_l1": 0.3, "lambda_l2": 2.0,
                             "max_delta_step": 0.05}),
        "categorical-nan": (cat, lambda: _cat_nan_problem(),
                            lambda: _cat_nan_problem(n=800, seed=5), 6, 0.7,
                            {"categorical_feature": [3]}),
        "multiclass": (mc, lambda: _multiclass(900, np.random.default_rng(2)),
                       lambda: _multiclass(700, np.random.default_rng(12)),
                       5, 0.5, {}),
    }


@pytest.mark.parametrize("case", list(_cases()))
def test_device_refit_matches_host_oracles(jlgb, tmp_path, case):
    """The port's device refit against the JAX package's host oracle and
    the port's own, per leaf within 1e-6; predictions within 1e-6."""
    params, train_rows, new_rows, rounds, decay, kw = _cases()[case]
    X, y = train_rows()
    path = _model_file(tmp_path, params, X, y, rounds)
    Xn, yn = new_rows()
    ref = jlgb.Booster(model_file=path).refit(
        Xn, yn, decay_rate=decay, tpu_refit_device=False, **kw)
    port = lt.Booster(model_file=path, device="cpu")
    dev = port.refit(Xn, yn, decay_rate=decay, tpu_refit_device=True, **kw)
    host = port.refit(Xn, yn, decay_rate=decay, tpu_refit_device=False,
                      **kw)
    assert dev._gbdt.last_refit["mode"] == "device"
    assert host._gbdt.last_refit["mode"] == "host"
    assert len(dev._gbdt.models) == len(ref._gbdt.models)
    assert _worst(ref, dev) <= REFIT_ATOL
    assert _worst(host, dev) <= REFIT_ATOL
    np.testing.assert_allclose(dev.predict(Xn), ref.predict(Xn), rtol=0,
                               atol=1e-6)
    # the refit moved the leaves, and the structure stayed
    base = lt.Booster(model_file=path, device="cpu")
    assert _worst(base, dev) > 1e-3


def test_refit_event_emitted_both_paths(tmp_path):
    """One ``refit`` event per refit, from both paths, with the JAX
    package's fields; the stream validates against its schema."""
    pytest.importorskip("jax")
    report = importlib.import_module("lightgbm_tpu.obs.report")
    X, y = _problem(n=600, seed=4)
    bst = lt.train(PARAMS, lt.Dataset(X, label=y), 4, device="cpu")
    sink = tmp_path / "t"
    obs.reset()
    obs.enable(str(sink))
    try:
        bst.refit(X, y, decay_rate=0.8, tpu_refit_device=True)
        bst.refit(X, y, decay_rate=0.8, tpu_refit_device=False)
    finally:
        obs.disable()
    events = report.load_events(str(sink))
    refits = [e for e in events if e.get("event") == "refit"]
    assert [e["mode"] for e in refits] == ["device", "host"]
    for e in refits:
        assert e["trees"] == 4 and e["rows"] == 600 and e["iterations"] == 4
        assert e["decay"] == pytest.approx(0.8)
        assert e["wall_s"] >= 0
    assert report.validate_events(events) == []


def test_refit_of_a_trained_booster_and_its_scores():
    """A trained booster refits with its own parameters, and a valid set
    attached to the refit booster afterwards replays its training scores
    bit for bit (the replay state follows the new leaves)."""
    X, y = _problem(n=700, seed=21)
    bst = lt.train(PARAMS, lt.Dataset(X, label=y), 5, device="cpu")
    nb = bst.refit(X[:500], 1.0 - y[:500], decay_rate=0.5)
    assert nb.num_trees() == 5
    valid = lt.Dataset(X[:500], label=1.0 - y[:500], reference=nb.train_set)
    nb.add_valid(valid, "v")
    np.testing.assert_allclose(nb._gbdt._valid_scores[0].numpy(),
                               nb._gbdt._train_score.numpy(), rtol=0,
                               atol=0)


# ---------------------------------------------------------------------------
# the model's own bin space
# ---------------------------------------------------------------------------

def test_continue_replay_roundtrip_categorical_nan(jlgb, tmp_path):
    """New rows with NaNs (default-left both ways) and unseen categories,
    binned in the model's bin space: replaying the forest (0 new rounds)
    gives the host walk's raw scores, and the JAX package's replay."""
    X, y = _cat_nan_problem()
    p = dict(PARAMS, num_leaves=12, categorical_feature="3")
    path = _model_file(tmp_path, p, X, y, 6)
    Xn, yn = _cat_nan_problem(n=700, seed=6, unseen=True)
    b = train_continue(path, Xn, yn, params=dict(p, device_type="cpu"),
                       num_boost_round=0, keep_training_booster=True)
    replayed = b._raw_train_score()
    host = lt.Booster(model_file=path, device="cpu").predict(Xn,
                                                             raw_score=True)
    np.testing.assert_allclose(replayed, host, rtol=0, atol=1e-5)
    from lightgbm_tpu.online import train_continue as jtrain_continue
    jb = jtrain_continue(path, Xn, yn, params=dict(p), num_boost_round=0,
                         keep_training_booster=True)
    np.testing.assert_allclose(replayed, jb._raw_train_score(), rtol=0,
                               atol=1e-5)


def test_train_continue_equals_jax_and_keeps_thresholds(jlgb, tmp_path):
    """Five continued rounds grow the JAX package's trees (structure and
    counts equal, leaves within 1e-4 as in test_torch_train.py), every
    new threshold is one of the base model's, and the new trees fit the
    window better than the base model."""
    X, y = _problem()
    path = _model_file(tmp_path, PARAMS, X, y, 6)
    Xn, yn = _problem(n=900, seed=21)
    p = dict(PARAMS, num_leaves=7)
    port = train_continue(path, Xn, yn, params=dict(p, device_type="cpu"),
                          num_boost_round=5)
    mp = pytest.MonkeyPatch()
    mp.setenv("LGBM_TPU_FORCE_WAVE", "interpret")
    try:
        from lightgbm_tpu.online import train_continue as jtrain_continue
        ref = jtrain_continue(path, Xn, yn, params=p, num_boost_round=5)
    finally:
        mp.undo()
    assert port.num_trees() == ref.num_trees() == 11
    for rt, pt in zip(ref._gbdt.models[6:], port._gbdt.models[6:]):
        assert rt.num_leaves == pt.num_leaves
        nn = rt.num_leaves - 1
        for name in ("split_feature", "threshold", "decision_type",
                     "left_child", "right_child"):
            np.testing.assert_array_equal(getattr(pt, name)[:nn],
                                          getattr(rt, name)[:nn])
        np.testing.assert_array_equal(pt.leaf_count, rt.leaf_count)
        np.testing.assert_allclose(pt.leaf_value, rt.leaf_value, rtol=0,
                                   atol=1e-4)
    base = lt.Booster(model_file=path, device="cpu")
    base_thr = {float(t) for tr in base._gbdt.models
                for t in tr.threshold[:max(tr.num_leaves - 1, 0)]}
    for tr in port._gbdt.models[6:]:
        for i in range(max(tr.num_leaves - 1, 0)):
            assert float(tr.threshold[i]) in base_thr

    def logloss(p_):
        p_ = np.clip(p_, 1e-9, 1 - 1e-9)
        return -np.mean(yn * np.log(p_) + (1 - yn) * np.log(1 - p_))
    assert logloss(port.predict(Xn)) < logloss(base.predict(Xn))


def test_continue_dataset_unused_features_trivial(jlgb):
    """A model that splits on 3 of 8 columns: the continue dataset keeps
    all 8 as total features, only the split ones as inner features, and
    its bins equal the JAX package's."""
    X, y = _problem(n=400, seed=30, f=8)
    p = dict(PARAMS, num_leaves=4)
    bst = lt.train(p, lt.Dataset(X[:, :3], label=y), 2, device="cpu")
    d = continue_dataset(list(bst._gbdt.models), X, label=y, params=p)
    h = d._handle
    assert h.num_total_features == 8 and h.num_data == 400
    assert h.num_features <= 3
    from lightgbm_tpu.online import continue_dataset as jcontinue_dataset
    jh = jcontinue_dataset(list(bst._gbdt.models), X, label=y,
                           params=p)._handle
    np.testing.assert_array_equal(h.X_bin, jh.X_bin)
    np.testing.assert_array_equal(h.real_feature_idx, jh.real_feature_idx)


def test_collect_split_state_cats_match_jax(jlgb, tmp_path):
    """``want_cats`` decodes the bitsets into the JAX package's category
    sets; without it the sets stay empty (serving's cost)."""
    X, y = _cat_nan_problem()
    p = dict(PARAMS, num_leaves=12, categorical_feature="3")
    path = _model_file(tmp_path, p, X, y, 6)
    from lightgbm_tpu.serve.packing import collect_split_state as jcollect
    from lightgbm_tpu_torch.serve.packing import collect_split_state
    models = lt.Booster(model_file=path, device="cpu")._gbdt.models
    got = collect_split_state(models, 5, want_cats=True)
    want = jcollect(models, 5, want_cats=True)
    assert got[3] == want[3] and got[3][3]
    np.testing.assert_array_equal(got[2], want[2])
    assert got[4] == want[4]
    assert all(not c for c in collect_split_state(models, 5)[3])


def test_model_bin_mappers_bin_like_jax(jlgb, tmp_path):
    """``BinMapper.from_thresholds`` and ``categorical_from_categories``
    (through ``model_bin_mappers``) bin NaN, zero, negative, fractional
    and unseen values as the JAX package's do, on a model with
    NaN-default-left splits and a categorical feature."""
    X, y = _cat_nan_problem()
    p = dict(PARAMS, num_leaves=12, categorical_feature="3")
    path = _model_file(tmp_path, p, X, y, 6)
    from lightgbm_tpu.online import model_bin_mappers as jmappers
    from lightgbm_tpu_torch.online import model_bin_mappers
    models = lt.Booster(model_file=path, device="cpu")._gbdt.models
    probe = np.asarray([np.nan, 0.0, -1.0, -0.5, 0.3, 2.5, 3.0, 7.0, 11.0,
                        1e9, -1e9])
    got, want = model_bin_mappers(models, 5), jmappers(models, 5)
    assert got[3].bin_type == want[3].bin_type == 1
    for g, w in zip(got, want):
        assert (g.num_bin, g.missing_type, g.default_bin) == \
            (w.num_bin, w.missing_type, w.default_bin)
        np.testing.assert_array_equal(g.value_to_bin(probe),
                                      w.value_to_bin(probe))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_device_refit_on_card_repeatable_and_matches_host():
    """On the card the refit's per-leaf sums are integer adds: two refits
    of the same rows write byte-equal model text, within 1e-6 of the host
    oracle and of the same refit on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CPU twin is "
                    "test_device_refit_matches_host_oracles")
    X, y = _problem(n=20_000, seed=40)
    bst = lt.train(PARAMS, lt.Dataset(X, label=y), 20, device="cuda")
    Xn, yn = _problem(n=30_000, seed=41)
    a = bst.refit(Xn, yn, decay_rate=0.9)
    b = bst.refit(Xn, yn, decay_rate=0.9)
    assert a.model_to_string() == b.model_to_string()
    host = bst.refit(Xn, yn, decay_rate=0.9, tpu_refit_device=False)
    assert _worst(host, a) <= REFIT_ATOL
    cpu = lt.Booster(model_str=bst.model_to_string(), device="cpu").refit(
        Xn, yn, decay_rate=0.9)
    assert _worst(cpu, a) <= REFIT_ATOL


def test_device_refit_matches_host_two_ranks(tmp_path, jlgb):
    """Twin of tests/test_online.py::test_device_refit_matches_host_mesh_
    2dev: a data-sharded trainer (two gloo ranks, ``tree_learner=data``)
    refits on the device and with the host oracle; per leaf within 1e-6,
    both ranks the same model, and the JAX package's host refit of that
    model within 1e-6 too."""
    import json

    from lightgbm_tpu_torch.tools.dist_check import launch
    rng = np.random.default_rng(9)
    X = rng.normal(size=(1024, 6))
    y = (X[:, 0] + X[:, 1] * X[:, 2] + 0.2 * rng.normal(size=1024) > 0)
    Xn = np.random.default_rng(10).normal(size=(512, 6))
    yn = (Xn[:, 0] + Xn[:, 1] * Xn[:, 2] > 0).astype(np.float64)
    np.savez(tmp_path / "rows.npz", X=X, y=y.astype(np.float64))
    np.savez(tmp_path / "new.npz", X=Xn, y=yn)
    spec = {"device": "cpu", "refit": {
        "params": dict(PARAMS, tree_learner="data"), "rounds": 5,
        "data_train": str(tmp_path / "rows.npz"),
        "data": str(tmp_path / "new.npz"), "decay": 0.6}}
    with open(tmp_path / "spec.json", "w") as fh:
        json.dump(spec, fh)
    res = launch(str(tmp_path / "spec.json"), 2, str(tmp_path), timeout=300)
    for r in res:
        assert r["refit"]["trees"] == 5
        assert r["refit"]["leaf_parity"] <= REFIT_ATOL
    assert res[0]["refit"]["model"] == res[1]["refit"]["model"]
    # the JAX package refits the base model the ranks trained (its model
    # text equals the refit's tree structure) on the same rows
    got = lt.Booster(model_str=res[0]["refit"]["model"], device="cpu")
    p = dict(PARAMS, tree_learner="data")
    base = lt.train(p, lt.Dataset(X, label=y.astype(np.float64), params=p),
                    5, device="cpu")
    want = jlgb.Booster(model_str=base.model_to_string()).refit(
        Xn, yn, decay_rate=0.6, tpu_refit_device=False)
    for a, b in zip(got._gbdt.models, want._gbdt.models):
        np.testing.assert_array_equal(a.split_feature, b.split_feature[
            :len(a.split_feature)])
        np.testing.assert_allclose(a.leaf_value, b.leaf_value, rtol=0,
                                   atol=REFIT_ATOL)
