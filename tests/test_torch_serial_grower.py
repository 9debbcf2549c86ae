"""The port's serial grower (``core/grower.py build_grow_fn``) against the
JAX package's on seeded binary problems: forced splits, CEGB (split,
coupled and lazy penalties), by-node feature sampling and a dataset whose
every column has more than 256 bins.  On the CPU the JAX package trains
these on its XLA serial grower (``hist_scatter``), the port on its serial
grower with K2's plain version and the fixed-point wide histogram.  CEGB
without lazy penalties grows on both packages' wave growers.

Tolerances: trees identical (features, thresholds, decision types,
children, leaf counts); leaf values within 1e-4 (f32 histogram sums in
another order, as ``test_torch_train.py`` argues); the by-node masks
bit-equal to jax's draw.  On a card, K2 at C = 32 (the serial grower's
channel group) within the f32 bound of its plain version and two
launches bit-equal."""
import json

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.core.grower import bynode_masks
from lightgbm_tpu_torch.core.histogram import hist_fixed_point, hist_scatter
from lightgbm_tpu_torch.ops import hist_channels as hc

PARAMS = {"objective": "binary", "num_leaves": 15, "max_bin": 63,
          "learning_rate": 0.1, "min_data_in_leaf": 20, "verbose": -1}
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


def _data(n=3000, f=10, seed=1, wide=False):
    """Well separated, no NaNs (see test_torch_train.py); ``wide`` gives
    every column continuous values, so that max_bin 400 makes every column
    wider than 256 bins."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f))
    if not wide:
        X[:, 3] = np.round(X[:, 3])
    logit = X[:, 0] - 0.8 * X[:, 1] + X[:, 2] * X[:, 4] + 0.5 * X[:, 3]
    y = (logit + rng.logistic(size=n) > 0).astype(np.float64)
    return X, y


def _train_both(params, X, y, rounds=ROUNDS, force_wave=False):
    """Both packages on one problem; ``force_wave`` runs the JAX package's
    wave grower through the Pallas interpreter (LGBM_TPU_FORCE_WAVE), as
    ``test_torch_train.py`` does, for what the port grows on its wave."""
    import lightgbm_tpu as lgb
    mp = pytest.MonkeyPatch()
    if force_wave:
        mp.setenv("LGBM_TPU_FORCE_WAVE", "interpret")
    try:
        ref = lgb.train(params, lgb.Dataset(X, label=y), rounds)
    finally:
        mp.undo()
    port = lt.train(params, lt.Dataset(X, label=y), rounds, device="cpu")
    return ref, port


def _assert_trees_identical(ref, port):
    rts, pts = ref._gbdt.models, port._gbdt.models
    assert len(rts) == len(pts)
    for rt, pt in zip(rts, pts):
        assert rt.num_leaves == pt.num_leaves
        nn = rt.num_leaves - 1
        for name in ("split_feature", "threshold", "decision_type",
                     "left_child", "right_child"):
            np.testing.assert_array_equal(getattr(rt, name)[:nn],
                                          getattr(pt, name)[:nn])
        np.testing.assert_array_equal(rt.leaf_count[:nn + 1],
                                      pt.leaf_count[:nn + 1])
        np.testing.assert_allclose(pt.leaf_value[:nn + 1],
                                   rt.leaf_value[:nn + 1], rtol=0, atol=1e-4)


def _forced_file(tmp_path, tree):
    path = tmp_path / "forced.json"
    path.write_text(json.dumps(tree))
    return str(path)


FORCED = {"feature": 2, "threshold": 0.1,
          "left": {"feature": 5, "threshold": 0.0},
          "right": {"feature": 1, "threshold": -0.3}}


def test_forced_splits_trees_identical(tmp_path):
    X, y = _data()
    params = {**PARAMS, "forcedsplits_filename": _forced_file(tmp_path,
                                                              FORCED)}
    ref, port = _train_both(params, X, y)
    assert not port._gbdt.uses_wave
    _assert_trees_identical(ref, port)
    for t in port._gbdt.models:         # the BFS prefix stands
        assert list(t.split_feature[:3]) == [2, 5, 1]
        assert (t.left_child[0], t.right_child[0]) == (1, 2)


def test_rejected_forced_split_aborts_the_rest(tmp_path):
    """A prescription whose right side is empty has no gain: it and every
    later forced split are dropped, and growth is gain-driven from the
    start, as in the JAX package."""
    X, y = _data()
    tree = {"feature": 0, "threshold": 1e9,
            "left": {"feature": 5, "threshold": 0.0}}
    params = {**PARAMS, "forcedsplits_filename": _forced_file(tmp_path,
                                                              tree)}
    ref, port = _train_both(params, X, y)
    _assert_trees_identical(ref, port)
    plain = lt.train(PARAMS, lt.Dataset(X, label=y), ROUNDS, device="cpu")
    assert port._gbdt.models[0].split_feature[0] != 5
    assert port._gbdt.models[0].num_leaves == 15
    assert plain._gbdt.models[0].num_leaves == 15


def test_missing_forced_splits_file_is_fatal(tmp_path):
    X, y = _data(n=300)
    with pytest.raises(lt.LightGBMError, match="does not exist"):
        lt.train({**PARAMS, "forcedsplits_filename":
                  str(tmp_path / "absent.json")}, lt.Dataset(X, label=y), 1,
                 device="cpu")


LAZY = {"cegb_penalty_feature_lazy": [0.002] * 5 + [0.0] * 5}


@pytest.mark.parametrize("cegb,wave", [
    ({"cegb_penalty_split": 0.05}, True),
    ({"cegb_penalty_feature_coupled": [2.0] * 10}, True),
    (LAZY, False),
    ({"cegb_penalty_split": 0.05,
      "cegb_penalty_feature_coupled": [0.5] * 10, **LAZY}, False),
], ids=["split", "coupled", "lazy", "all_three"])
def test_cegb_trees_identical(cegb, wave):
    """Split and coupled penalties ride the wave grower in both packages;
    a lazy penalty needs per-row state, so both take the serial grower
    (with the split and coupled penalties beside it in ``all_three``)."""
    X, y = _data()
    ref, port = _train_both({**PARAMS, **cegb}, X, y, force_wave=wave)
    assert port._gbdt.uses_wave == ref._gbdt.uses_wave == wave
    _assert_trees_identical(ref, port)
    plain = lt.train(PARAMS, lt.Dataset(X, label=y), ROUNDS, device="cpu")
    # the penalty changed what was grown
    assert [t.num_leaves for t in port._gbdt.models] != [
        t.num_leaves for t in plain._gbdt.models] or any(
        not np.array_equal(a.split_feature, b.split_feature)
        for a, b in zip(port._gbdt.models, plain._gbdt.models))


@pytest.mark.parametrize("seed,keep", [(0, 5), (7, 1), (123456, 9)])
def test_bynode_masks_bit_equal_to_jax(seed, keep):
    jax = pytest.importorskip("jax")
    F, count = 10, 9
    key = jax.random.PRNGKey(np.uint32(seed))
    want = []
    for d in range(count):
        r = jax.random.uniform(jax.random.fold_in(key, d), (F,))
        th = jax.lax.top_k(r, keep)[0][-1]
        want.append(np.asarray(r >= th))
    got = bynode_masks(seed, count, F, keep)
    np.testing.assert_array_equal(got, np.stack(want))
    assert (got.sum(1) == keep).all()


def test_bynode_trees_identical():
    X, y = _data()
    ref, port = _train_both({**PARAMS, "feature_fraction_bynode": 0.5}, X, y)
    assert not port._gbdt.uses_wave
    _assert_trees_identical(ref, port)


def test_all_wide_trees_identical():
    X, y = _data(wide=True)
    ref, port = _train_both({**PARAMS, "max_bin": 400}, X, y)
    gb = port._gbdt
    assert not gb.uses_wave and gb._bins_fm[0] is None
    assert gb._bins_fm[1].dtype == torch.int32
    assert (gb.train_ds.phys_max_bins() > 256).all()
    _assert_trees_identical(ref, port)


def test_fixed_point_histogram_matches_scatter():
    """The wide histogram: counts exact, g and h within f32 rounding of
    the scatter-add (its fixed-point sums are exact to 2^-k)."""
    rng = np.random.default_rng(3)
    N, F, B = 4001, 3, 700
    bins = torch.from_numpy(rng.integers(0, B, (F, N)).astype(np.int32))
    g = torch.from_numpy(rng.normal(size=N).astype(np.float32))
    h = torch.from_numpy(rng.random(N).astype(np.float32))
    mask = torch.from_numpy((rng.random(N) < 0.6).astype(np.float32))
    got = hist_fixed_point(bins, g, h, mask, B)
    want = hist_scatter(bins.t().contiguous(), g, h, mask, B)
    torch.testing.assert_close(got[..., 2], want[..., 2], rtol=0, atol=0)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_k2_at_32_channels_on_card():
    """K2 at C = 32 (``hist_channels_fm``'s channel group) within the f32
    bound of its plain version, two launches bit-equal, on ragged rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    rng = np.random.default_rng(12)
    N, F, B = 100_003, 7, 256
    bins = torch.from_numpy(rng.integers(0, B, (F, N)).astype(
        np.uint8)).cuda()
    gh = torch.from_numpy(rng.normal(size=(N, 32)).astype(np.float32)).cuda()
    before = hc.hist_channels.launches
    first = hc.hist_channels(bins, gh, B)
    second = hc.hist_channels(bins, gh, B)
    assert hc.hist_channels.launches == before + 2
    assert torch.equal(first, second)
    want = hc.hist_channels_plain(bins, gh, B)
    mag = hc.hist_channels_plain(bins, gh.abs(), B)
    assert bool(((first - want).abs() <= 1e-5 * mag + 1e-6).all())
    g, h = gh[:, 0].contiguous(), gh[:, 1].abs().contiguous()
    mask = (gh[:, 2] > 0).float()
    fm = hc.hist_channels_fm(bins, g, h, mask, B)
    assert fm.shape == (F, B, 3)
    torch.testing.assert_close(fm[..., 2], hc.hist_channels_plain(
        bins, torch.stack([g * mask, h * mask, mask], 1), B)[..., 2],
        rtol=0, atol=0)
