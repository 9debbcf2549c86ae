"""The port's training-health sentinels (``obs/health.py``) against the
JAX package's (twins of ``tests/test_health.py``): strict mode aborts
with the same attribution (phase, iteration, objective, first bad row and
class, node and feature), monitor mode streams events the JAX package's
``obs/report.py`` validates and summarizes, fingerprints follow
``tpu_fingerprint_freq``, and off is a boolean check.  The multi-rank
divergence audit gathers through ``parallel/distributed.py
rank_allgather_stats``; its single-process no-op and the simulated gather
are here.  The messages are compared with the
JAX package's, character for character."""
import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import obs
from lightgbm_tpu_torch.obs import health


def _toy(n=400, f=5, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f))
    y = (X[:, 0] + 0.5 * X[:, 1] > 0).astype(np.float64)
    return X, y


_PARAMS = {"objective": "binary", "num_leaves": 7, "min_data_in_leaf": 5,
           "verbose": -1}


@pytest.fixture(autouse=True)
def _health_off_after():
    yield
    obs.enable_health("")
    obs.disable()
    obs.reset()


@pytest.fixture(scope="module")
def jobs():
    pytest.importorskip("jax")
    from lightgbm_tpu import obs as jobs
    yield jobs
    jobs.enable_health("")


def _report():
    """The JAX package's ``obs/report.py`` (the module: ``obs.report`` is
    also a function)."""
    pytest.importorskip("jax")
    import importlib
    return importlib.import_module("lightgbm_tpu.obs.report")


def _booster(params=_PARAMS):
    X, y = _toy()
    ds = lt.Dataset(X, label=y, params=params)
    return lt.Booster(params=params, train_set=ds, device="cpu"), len(y)


def _jax_message(jobs, fn, *args, **kw):
    jobs.enable_health("strict")
    try:
        with pytest.raises(jobs.TrainingHealthError) as ei:
            fn(*args, **kw)
    finally:
        jobs.enable_health("")
    return str(ei.value)


def test_strict_mode_aborts_on_nan_gradients_with_attribution():
    bst, n = _booster()
    obs.enable_health("strict")
    bst.update()

    def bad_fobj(preds, train_data):
        g = np.zeros(n)
        h = np.ones(n)
        g[7] = np.nan
        return g, h
    with pytest.raises(obs.TrainingHealthError) as ei:
        bst.update(fobj=bad_fobj)
    msg = str(ei.value)
    assert "boosting (grad/hess)" in msg and "iteration 1" in msg
    assert "row 7" in msg and "objective=custom" in msg
    assert isinstance(ei.value, lt.LightGBMError)


def test_monitor_mode_records_failure_without_abort(tmp_path):
    report = _report()
    sink = tmp_path / "telem"
    obs.enable(str(sink))
    obs.enable_health("monitor")
    bst, n = _booster()

    def bad_fobj(preds, train_data):
        g = np.zeros(n)
        h = np.ones(n)
        g[3] = np.inf
        return g, h
    bst.update(fobj=bad_fobj)
    obs.disable()
    events = report.load_events(str(sink))
    bad = [e for e in events if e.get("event") == "health"
           and not e.get("ok", True)]
    assert bad and bad[0]["check"] == "gradients"
    assert bad[0]["phase"] == "boosting (grad/hess)"
    assert bad[0]["iteration"] == 0
    assert bad[0]["detail"]["first_bad_row"] == 3
    assert report.validate_events(events) == []
    assert obs.counter_value("health/failures") >= 1


def test_attribution_messages_equal_jax(jobs):
    """[N, K] gradients map the flat index to (row, class); the messages
    are the JAX package's."""
    import jax.numpy as jnp
    g = torch.zeros((10, 3))
    g[7, 2] = float("nan")
    h = torch.ones((10, 3))
    obs.enable_health("strict")
    with pytest.raises(obs.TrainingHealthError, match="row 7 class 2") as ei:
        obs.check_gradients(g, h, phase="boosting (grad/hess)",
                            iteration=0, objective="multiclass")
    want = _jax_message(jobs, jobs.check_gradients,
                        jnp.zeros((10, 3)).at[7, 2].set(jnp.nan),
                        jnp.ones((10, 3)), phase="boosting (grad/hess)",
                        iteration=0, objective="multiclass")
    assert str(ei.value) == want
    s = torch.zeros((10, 3))
    s[4, 1] = float("inf")
    obs.enable_health("strict")
    with pytest.raises(obs.TrainingHealthError, match="row 4") as ei:
        obs.check_score(s, phase="dart normalize", iteration=0)
    assert str(ei.value) == _jax_message(
        jobs, jobs.check_score, jnp.zeros((10, 3)).at[4, 1].set(jnp.inf),
        phase="dart normalize", iteration=0)


def _tree(**fields):
    """A tree of capacity 8 on the CPU (``core/grower.py _empty_tree``)
    with ``fields`` set, as tensors and as the JAX package's arrays."""
    from lightgbm_tpu_torch.convert import tree_arrays_from_numpy
    from lightgbm_tpu_torch.core.grower import _empty_tree
    t = _empty_tree(8, 1)._asdict()
    for name, (idx, val) in fields.items():
        if idx is None:
            t[name] = np.asarray(val, t[name].dtype)
        else:
            t[name] = t[name].copy()
            for i, v in zip(idx, val):
                t[name][i] = v
    return tree_arrays_from_numpy(t, torch.device("cpu")), t


def test_tree_check_attributes_node_and_feature(jobs):
    import jax.numpy as jnp

    from lightgbm_tpu.core.grower import _empty_tree as j_empty
    t, raw = _tree(split_gain=([2], [np.nan]), split_feature=([2], [4]),
                   num_leaves=(None, 4), internal_count=([0], [10]),
                   internal_weight=([0], [5.0]))
    obs.enable_health("strict")
    with pytest.raises(obs.TrainingHealthError,
                       match=r"node 2 \(feature 4\)") as ei:
        obs.check_tree(t, phase="tree growth", iteration=5, class_id=1)
    jt = j_empty(8, 1)
    jt = jt._replace(**{k: jnp.asarray(raw[k]) for k in jt._fields
                        if k in raw})
    assert str(ei.value) == _jax_message(
        jobs, jobs.check_tree, jt, phase="tree growth", iteration=5,
        class_id=1)
    t2, _ = _tree(num_leaves=(None, 2), internal_count=([0], [100]),
                  internal_weight=([0], [50.0]),
                  leaf_count=([0, 1], [40, 40]),
                  leaf_weight=([0, 1], [20.0, 20.0]))
    obs.enable_health("strict")
    with pytest.raises(obs.TrainingHealthError, match="conservation"):
        obs.check_tree(t2, phase="tree growth", iteration=0)
    assert obs.check_tree(_tree()[0], phase="tree growth", iteration=0)


def test_objective_tap_and_fingerprints(tmp_path):
    """The objective's tap runs every iteration; strict over a healthy
    run emits fingerprints (a digest an iteration, moving with the
    scores) and no failure, in events the JAX package validates."""
    report = _report()
    sink = tmp_path / "telem"
    obs.enable(str(sink))
    obs.enable_health("strict")
    bst, _ = _booster()
    for _ in range(3):
        bst.update()
    obs.disable()
    events = report.load_events(str(sink))
    fps = [e for e in events if e.get("event") == "fingerprint"]
    assert [e["iteration"] for e in fps] == [0, 1, 2]
    assert all(len(e["digest"]) == 16 for e in fps)
    assert fps[0]["digest"] != fps[1]["digest"]
    assert not [e for e in events if e.get("event") == "health"
                and not e.get("ok", True)]
    assert report.validate_events(events) == []
    hs = report.health_summary(events)
    assert hs["failures"] == 0
    assert hs["last_fingerprint"]["iteration"] == 2


def test_fingerprint_interval_param(tmp_path):
    report = _report()
    sink = tmp_path / "telem"
    params = dict(_PARAMS, tpu_health="monitor", tpu_fingerprint_freq=2,
                  tpu_telemetry=str(sink))
    bst, _ = _booster(params)
    for _ in range(4):
        bst.update()
    obs.disable()
    fps = [e["iteration"] for e in report.load_events(str(sink))
           if e.get("event") == "fingerprint"]
    assert fps == [0, 2]


def test_goss_and_dart_taps_run(tmp_path):
    params = dict(_PARAMS, boosting="goss", learning_rate=0.5,
                  top_rate=0.3, other_rate=0.2, tpu_health="monitor")
    bst, _ = _booster(params)
    obs.enable(str(tmp_path / "t"))   # counters count with a sink on
    for _ in range(4):  # sampling starts after 1/lr = 2 iterations
        bst.update()
    # objective tap + tree check each iteration, and the amplifier's
    assert obs.counter_value("health/checks") > 8
    assert obs.counter_value("health/failures") == 0
    dparams = dict(_PARAMS, boosting="dart", drop_rate=0.5, skip_drop=0.0,
                   tpu_health="strict")
    dart, _ = _booster(dparams)
    for _ in range(3):
        dart.update()
    assert dart.num_trees() == 3


def test_divergence_audit_simulated_corrupt_rank(monkeypatch):
    obs.enable_health("monitor")
    assert obs.divergence_audit(np.ones(4), iteration=0)  # one process
    rec = obs.model_fingerprint(torch.ones((32,)), iteration=0)
    monkeypatch.setattr(health, "_gather_override",
                        lambda s: np.stack([s, s, s]))
    assert obs.divergence_audit(rec["stats"], iteration=0)

    def corrupt(s):
        g = np.stack([s, s, s])
        g[1, 0] += 1e-3
        return g
    monkeypatch.setattr(health, "_gather_override", corrupt)
    with pytest.raises(obs.TrainingHealthError, match=r"rank\(s\) \[1\]"):
        obs.divergence_audit(rec["stats"], iteration=1)
    monkeypatch.setattr(health, "_gather_override",
                        lambda s: np.stack([s, s + 1.0]))
    with pytest.raises(obs.TrainingHealthError,
                       match=r"rank\(s\) \[0, 1\]"):
        obs.divergence_audit(rec["stats"], iteration=2)


def test_health_off_is_boolean_check():
    assert not obs.health_enabled()
    assert obs.check_gradients(None, None, phase="p", iteration=0)
    assert obs.check_score(None, phase="p", iteration=0)
    assert obs.check_tree(None, phase="p", iteration=0)
    assert obs.model_fingerprint(None, iteration=0) is None
    assert obs.divergence_audit(np.zeros(1), iteration=0)


def test_config_normalizes_health_modes():
    for value, want in (("ON", "monitor"), ("strict", "strict"), ("0", "")):
        cfg = lt.Config.from_params({"tpu_health": value, "verbose": -1})
        assert cfg.tpu_health == want
    with pytest.raises(lt.LightGBMError, match="tpu_health"):
        lt.Config.from_params({"tpu_health": "sometimes", "verbose": -1})
    with pytest.raises(lt.LightGBMError, match="tpu_fingerprint_freq"):
        lt.Config.from_params({"tpu_fingerprint_freq": -1, "verbose": -1})
