"""Mixed-width columns in the port against the JAX package on the CPU: the
wide-column side-pass equals ``hist_wave_xla``; on a uint16 dataset with
narrow columns and a >256-bin categorical, the port's wave grower (K1's
triple layout on the narrow group, the side-pass on the wide one) grows
the JAX grower's tree on the same continuous gradients, split for split,
bitsets included, with the wide categorical split on (the model is
tests/test_wave.py's mixed-width test); whole training on such data
equals the JAX package's.  On a card: the side-pass bit-equal from call
to call, and K1's triple layout at the narrow group's shape against its
plain version."""
import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import convert
from lightgbm_tpu_torch.core.histogram import hist_wave_side

PARAMS = {"objective": "binary", "num_leaves": 15, "max_bin": 1024,
          "min_data_in_leaf": 5, "min_data_per_group": 5, "cat_smooth": 1.0,
          "cat_l2": 1.0, "verbose": -1}


def _mixed_problem(n=2000, seed=11):
    """tests/test_wave.py's problem: one 1000-category categorical (>256
    bins -> uint16) and three narrow numeric columns."""
    rng = np.random.default_rng(seed)
    cat = rng.integers(0, 1000, size=n)
    X = np.stack([
        cat.astype(np.float64),
        rng.integers(0, 40, size=n).astype(np.float64),
        rng.integers(0, 25, size=n).astype(np.float64),
        rng.normal(size=n).round(1),
    ], axis=1)
    y = (((cat % 7) < 3).astype(float) + 0.05 * X[:, 1]
         + 0.3 * rng.normal(size=n) > 0.6).astype(np.float64)
    return X, y


def _side_inputs(N, Fw, B, S, seed):
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, B, size=(N, Fw)).astype(np.int32)
    gv = rng.normal(size=N).astype(np.float32)
    hv = (0.1 + rng.random(size=N)).astype(np.float32)
    cv = (rng.random(size=N) < 0.9).astype(np.float32)
    leaf = rng.integers(0, 2 * S, size=N).astype(np.int32)
    slot = np.full(128, -1, np.int32)
    slot[:3 * S] = np.repeat(rng.permutation(2 * S)[:S], 3)
    return bins, gv * cv, hv * cv, cv, leaf, slot


@pytest.mark.parametrize("N,Fw,B,S", [(3000, 1, 1024, 1), (2500, 2, 512, 42),
                                      (700, 3, 1024, 7)])
def test_side_pass_equals_hist_wave_xla(N, Fw, B, S):
    """f32 sums of the same values in another order: within 1e-5 of each
    cell's sum of magnitudes; counts exact."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from lightgbm_tpu.core.histogram import hist_wave_xla
    arrs = _side_inputs(N, Fw, B, S, seed=N + S)
    want = np.asarray(hist_wave_xla(*(jnp.asarray(a) for a in arrs), B=B))
    t = [torch.from_numpy(a) for a in arrs]
    got = hist_wave_side(*t, B, lanes=3 * S).numpy()
    mag = np.asarray(hist_wave_xla(jnp.asarray(arrs[0]),
                                   jnp.abs(jnp.asarray(arrs[1])),
                                   jnp.abs(jnp.asarray(arrs[2])),
                                   *(jnp.asarray(a) for a in arrs[3:]), B=B))
    assert want.shape == got.shape == (Fw, B, 128)
    np.testing.assert_array_equal(got[..., 2::3], want[..., 2::3])
    assert np.all(np.abs(got - want) <= 1e-5 * mag + 1e-6)
    # the full lane count gives the same sums
    np.testing.assert_array_equal(hist_wave_side(*t, B).numpy()[..., :3 * S],
                                  got[..., :3 * S])


@pytest.fixture(scope="module")
def datasets():
    pytest.importorskip("jax")
    import lightgbm_tpu as lgb
    X, y = _mixed_problem()
    ref = lgb.Dataset(X, label=y, categorical_feature=[0], params=PARAMS)
    ref.construct()
    port = lt.Dataset(X, label=y, categorical_feature=[0], params=PARAMS)
    port.construct()
    return X, y, ref._handle, port._handle


@pytest.mark.parametrize("mode", ["2xbf16", "highest"])
def test_wave_grower_equals_reference_on_mixed_width(datasets, mode):
    import jax
    import jax.numpy as jnp
    from lightgbm_tpu.config import Config as RefConfig
    from lightgbm_tpu.core.meta import SplitConfig as RefSplit
    from lightgbm_tpu.core.meta import build_device_meta as ref_meta_fn
    from lightgbm_tpu.core.meta import padded_phys_width as ref_phys
    from lightgbm_tpu.core.wave_grower import MixedWidth as RefMixed
    from lightgbm_tpu.core.wave_grower import build_wave_grow_fn as ref_grow
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.core.meta import (SplitConfig, build_device_meta,
                                              padded_phys_width)
    from lightgbm_tpu_torch.core.wave_grower import (MixedWidth,
                                                     build_wave_grow_fn)
    _, _, rds, pds = datasets
    assert rds.X_bin.dtype == pds.X_bin.dtype == np.uint16
    assert rds.X_bin.tobytes() == pds.X_bin.tobytes()
    phys_bins = np.asarray(pds.phys_max_bins())
    wide = phys_bins > 256
    assert wide.any() and (~wide).any()
    kw = dict(narrow_idx=np.flatnonzero(~wide).astype(np.int32),
              wide_idx=np.flatnonzero(wide).astype(np.int32),
              B_narrow=int(max(8, 2 ** int(np.ceil(np.log2(
                  phys_bins[~wide].max()))))))
    n = pds.num_data
    rng = np.random.default_rng(3)
    g = rng.normal(size=n).astype(np.float32)
    h = (0.1 + rng.random(size=n)).astype(np.float32)
    mask = np.ones(n, np.float32)
    fmask = np.ones(pds.num_features, bool)
    xbt = pds.X_bin.T

    rmeta, rB = ref_meta_fn(rds, RefConfig.from_params(PARAMS))
    grow = jax.jit(ref_grow(
        rmeta, RefSplit.from_config(RefConfig.from_params(PARAMS)), rB,
        wave_capacity=42, highest=mode, interpret=True, gain_gate=0.5,
        B_phys=ref_phys(rds), mixed=RefMixed(**kw)))
    rt, rlid = grow((jnp.asarray(np.ascontiguousarray(
        xbt[kw["narrow_idx"]]).astype(np.uint8)), jnp.asarray(
            np.ascontiguousarray(xbt[kw["wide_idx"]]))), jnp.asarray(g),
        jnp.asarray(h), jnp.asarray(mask), jnp.asarray(fmask))

    cfg = Config.from_params(PARAMS)
    pmeta, pB = build_device_meta(pds, cfg, "cpu")
    assert pB == rB
    pgrow = build_wave_grow_fn(
        pmeta, SplitConfig.from_config(cfg), pB, wave_capacity=42,
        highest=mode, gain_gate=0.5, B_phys=padded_phys_width(pds),
        mixed=MixedWidth(**kw))
    pt, plid, (waves, _) = pgrow(
        (torch.from_numpy(np.ascontiguousarray(
            xbt[kw["narrow_idx"]]).astype(np.uint8)),
         torch.from_numpy(np.ascontiguousarray(
             xbt[kw["wide_idx"]]).astype(np.int32))),
        torch.from_numpy(g), torch.from_numpy(h), torch.from_numpy(mask),
        torch.from_numpy(fmask))
    want = convert.tree_arrays_to_numpy(convert.tree_arrays_from_numpy(
        {k: np.asarray(v) for k, v in jax.device_get(rt)._asdict().items()},
        "cpu"))
    got = convert.tree_arrays_to_numpy(pt)
    nn = int(want["num_leaves"]) - 1
    assert int(got["num_leaves"]) == nn + 1 == PARAMS["num_leaves"]
    for name in ("split_feature", "threshold_bin", "default_left",
                 "left_child", "right_child", "cat_bitset"):
        np.testing.assert_array_equal(got[name][:nn], want[name][:nn])
    np.testing.assert_allclose(got["leaf_value"], want["leaf_value"],
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(plid.numpy(), np.asarray(rlid))
    feats = set(got["split_feature"][:nn].tolist())
    assert 0 in feats and feats - {0}       # the wide categorical, and more
    assert waves > 1


def test_training_equals_reference_on_mixed_width():
    """End to end through the trainer on a bundled and mixed-width matrix
    (five dense columns, a 12-column exclusive count block EFB packs, a
    300-category column of more than 256 bins): the mixed-width gate, the
    wide column's int32 device bins, the bundled decode and five trees
    equal to the JAX package's.  Here the wide column is not split on:
    tree 0's gradients take two values under the binary objective, so
    categories with equal counts and positives tie exactly, and f32 sums
    in another order break such ties either way; the grower test above
    holds the wide split on continuous gradients."""
    pytest.importorskip("jax")
    import lightgbm_tpu as lgb
    rng = np.random.default_rng(3)
    n = 3000
    Xd = rng.normal(size=(n, 5))
    which = rng.integers(0, 12, size=n)
    Xs = np.zeros((n, 12))
    Xs[np.arange(n), which] = rng.integers(1, 8, size=n)
    wc = rng.integers(0, 300, size=n).astype(float)
    logit = (Xd[:, 0] - 0.7 * Xd[:, 1] + 0.4 * Xs[:, 2] - 0.3 * Xs[:, 5]
             + 0.2 * (which % 4) + 1.5 * ((wc % 7) == 0))
    y = (logit + rng.logistic(size=n) > 0).astype(float)
    X = np.column_stack([Xd, Xs, wc])
    params = {"objective": "binary", "num_leaves": 15, "max_bin": 63,
              "min_data_in_leaf": 20, "verbose": -1,
              "max_bin_by_feature": [63] * 17 + [511]}
    mp = pytest.MonkeyPatch()
    mp.setenv("LGBM_TPU_FORCE_WAVE", "interpret")
    try:
        ref = lgb.train(params, lgb.Dataset(X, label=y,
                                            categorical_feature=[17]), 5)
    finally:
        mp.undo()
    port = lt.train(params, lt.Dataset(X, label=y, categorical_feature=[17]),
                    5, device="cpu")
    gb = port._gbdt
    assert gb._wave_mixed is not None and gb._bundled
    assert gb.train_ds.X_bin.dtype == np.uint16
    for rt, pt in zip(ref._gbdt.models, gb.models):
        assert rt.num_leaves == pt.num_leaves
        nn = rt.num_leaves - 1
        np.testing.assert_array_equal(pt.split_feature,
                                      rt.split_feature[:nn])
        np.testing.assert_array_equal(pt.threshold, rt.threshold[:nn])
        np.testing.assert_allclose(pt.leaf_value, rt.leaf_value, rtol=0,
                                   atol=1e-4)
    np.testing.assert_allclose(port.predict(X), ref.predict(X), rtol=0,
                               atol=1e-4)


@pytest.mark.cuda
def test_side_pass_repeatable_on_card():
    """The side-pass's sums do not depend on the order of the adds: two
    calls on the card bit-equal, and within the f32 bound of the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    arrs = _side_inputs(200_000, 1, 1024, 42, seed=5)
    t = [torch.from_numpy(a).cuda() for a in arrs]
    first = hist_wave_side(*t, 1024, lanes=126)
    second = hist_wave_side(*t, 1024, lanes=126)
    assert torch.equal(first, second)
    cpu = hist_wave_side(*(torch.from_numpy(a) for a in arrs), 1024,
                         lanes=126)
    mag = hist_wave_side(torch.from_numpy(arrs[0]),
                         torch.from_numpy(arrs[1]).abs(),
                         torch.from_numpy(arrs[2]).abs(),
                         *(torch.from_numpy(a) for a in arrs[3:]), 1024,
                         lanes=126)
    assert bool(((first.cpu() - cpu).abs() <= 1e-5 * mag + 1e-6).all())


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [False, True])
def test_triple_kernel_at_narrow_group_shape_on_card(fused):
    """K1's triple layout (mixed width turns packed off) at the narrow
    group's width (B_narrow 64, 3 columns), 42 slots, against the plain
    version at the f32 bound."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from test_torch_hist_wave import _assert_f32_close, _leaves, _slots
    from lightgbm_tpu_torch.ops import hist_wave as hw
    rng = np.random.default_rng(21)
    N, F, B, S = 80_000, 3, 64, 42
    bins = rng.integers(0, B, size=(F, N)).astype(np.uint8)
    gv = rng.normal(size=N).astype(np.float32)
    hv = (0.05 + rng.random(size=N)).astype(np.float32)
    cv = np.ones(N, np.float32)
    leaf = rng.integers(0, 2 * S, size=N).astype(np.int32)
    t = [torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in
         (bins, gv, hv, cv, leaf, _slots(rng.permutation(2 * S)[:S], False))]
    par = torch.randn((F, B, 128), device="cuda") * 50 if fused else None
    got = hw.hist_wave(*t, B, highest="2xbf16", packed=False, parent=par,
                       num_slots=S)
    want = hw.hist_wave_plain(*t, B, highest="2xbf16", packed=False,
                              parent=par)
    mag = hw.hist_wave_plain(t[0], t[1].abs(), t[2].abs(), *t[3:], B,
                             highest="2xbf16", packed=False)
    _assert_f32_close(*(tuple(a.cpu() for a in _leaves(x))
                        for x in (got, want, mag)), False)


def test_device_predict_on_a_wide_numerical_column(monkeypatch):
    """A numerical column of more than 256 bins (mixed width without
    categorical features): the trained booster's device forest walk, fed
    int32 bins, equals its host walk."""
    from lightgbm_tpu_torch.boosting.gbdt import PredictorBase
    from lightgbm_tpu_torch.core import forest
    rng = np.random.default_rng(17)
    X = rng.normal(size=(3000, 4))
    y = (X[:, 0] + 0.5 * X[:, 1] + rng.logistic(size=3000) > 0).astype(float)
    params = {"objective": "binary", "num_leaves": 15, "max_bin": 63,
              "max_bin_by_feature": [1000, 63, 63, 63], "verbose": -1}
    bst = lt.train(params, lt.Dataset(X, label=y), 3, device="cpu")
    assert bst._gbdt._wave_mixed is not None
    host = bst.predict(X[:500])
    monkeypatch.setattr(PredictorBase, "_DEVICE_PREDICT_MIN_WORK", 1)
    before = forest.calls["predict"]
    np.testing.assert_allclose(bst.predict(X[:500]), host, rtol=0, atol=1e-6)
    assert forest.calls["predict"] == before + 1
