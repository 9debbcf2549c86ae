"""Exclusive Feature Bundling in the port against the JAX package on the
CPU: the same bundles (groups, feat2phys, feat_offset, needs_fix) and the
same physical bytes, a decode that gives back every feature's bins, the
bundled wave (K1 unfused on physical columns, expand_bundled,
fix_default_bins) growing the JAX package's trees (the JAX side through
the Pallas interpreter, LGBM_TPU_FORCE_WAVE=interpret), ``enable_bundle=
false`` leaving the layout as it is, and the quantized modes falling back
to 2xbf16 as the reference's do.  On a card, K1's unfused packed layout at
a bundled dataset's shape against its plain version."""
import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import convert
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.core.grower import decode_feature_col
from lightgbm_tpu_torch.core.histogram import (expand_bundled,
                                               fix_default_bins, hist_scatter)
from lightgbm_tpu_torch.core.meta import build_device_meta
from lightgbm_tpu_torch.io.dataset import BinnedDataset

PARAMS = {"objective": "binary", "num_leaves": 15, "max_bin": 63,
          "learning_rate": 0.1, "min_data_in_leaf": 20, "verbose": -1}
ROUNDS = 5


def _sparse_data(n=3000, k=12, seed=3, conflicts=0.0):
    """Five dense numeric columns and a one-hot-expanded count block of
    ``k`` columns: each row non-zero (1-7) in exactly one of them, plus,
    with ``conflicts``, a second non-zero in that share of rows."""
    rng = np.random.default_rng(seed)
    Xd = rng.normal(size=(n, 5))
    which = rng.integers(0, k, size=n)
    Xs = np.zeros((n, k))
    Xs[np.arange(n), which] = rng.integers(1, 8, size=n)
    extra = rng.random(n) < conflicts
    Xs[extra, (which[extra] + 1) % k] = 1.0
    logit = (Xd[:, 0] - 0.7 * Xd[:, 1] + 0.4 * Xs[:, 2] - 0.3 * Xs[:, 5]
             + 0.2 * (which % 4))
    y = (logit + rng.logistic(size=n) > 0).astype(np.float64)
    return np.column_stack([Xd, Xs]), y


@pytest.fixture(scope="module")
def lgb_interp():
    pytest.importorskip("jax")
    import lightgbm_tpu as lgb
    mp = pytest.MonkeyPatch()
    mp.setenv("LGBM_TPU_FORCE_WAVE", "interpret")
    yield lgb
    mp.undo()


@pytest.mark.parametrize("case", [
    dict(seed=3), dict(seed=4, k=24), dict(seed=5, conflicts=0.01),
    dict(seed=6, conflicts=0.01, max_conflict_rate=0.02),
    dict(seed=7, k=40, max_bin=15)])
def test_bundles_equal_build_bundles(case):
    pytest.importorskip("jax")
    from lightgbm_tpu.config import Config as RefConfig
    from lightgbm_tpu.io.dataset import BinnedDataset as RefDataset
    case = dict(case)
    params = {"max_bin": case.pop("max_bin", 63),
              "max_conflict_rate": case.pop("max_conflict_rate", 0.0)}
    X, _ = _sparse_data(**case)
    ref = RefDataset.from_matrix(X, RefConfig.from_params(params))
    port = BinnedDataset.from_matrix(X, Config.from_params(params))
    assert ref.bundle is not None and port.bundle is not None
    assert port.bundle.num_phys < port.num_features
    assert port.bundle.groups == ref.bundle.groups
    for name in ("feat2phys", "feat_offset", "needs_fix", "phys_num_bin"):
        np.testing.assert_array_equal(getattr(port.bundle, name),
                                      getattr(ref.bundle, name))
    assert port.X_bin.dtype == ref.X_bin.dtype
    assert port.X_bin.tobytes() == ref.X_bin.tobytes()
    assert port.num_phys_features == ref.num_phys_features
    np.testing.assert_array_equal(port.phys_max_bins(), ref.phys_max_bins())


def test_decode_and_histograms_round_trip():
    """Every feature's bins decode from its physical column exactly (the
    block has no conflicts), and the physical histogram expanded and
    default-bin-fixed equals the per-feature histogram of the unbundled
    bins."""
    X, _ = _sparse_data(n=2000, k=16, seed=9)
    ds = BinnedDataset.from_matrix(X, Config.from_params({"max_bin": 63}))
    flat = BinnedDataset.from_matrix(X, Config.from_params(
        {"max_bin": 63, "enable_bundle": False}))
    assert ds.bundle is not None and flat.bundle is None
    meta, B = build_device_meta(ds, None, "cpu")
    phys = torch.from_numpy(ds.X_bin.astype(np.int64))
    for i in range(ds.num_features):
        col = decode_feature_col(phys[:, int(meta.feat2phys[i])],
                                 meta.feat_offset[i], meta.num_bins[i],
                                 meta.default_bins[i])
        np.testing.assert_array_equal(col.numpy(), flat.X_bin[:, i])
    rng = np.random.default_rng(10)
    g = torch.from_numpy((np.round(rng.normal(size=len(X)) * 64) / 64)
                         .astype(np.float32))
    h = torch.from_numpy((np.round(rng.random(size=len(X)) * 64) / 64)
                         .astype(np.float32))
    mask = torch.from_numpy((rng.random(len(X)) < 0.8).astype(np.float32))
    B_phys = int(max(64, 2 ** int(np.ceil(np.log2(ds.phys_max_bins().max())))))
    hp = hist_scatter(torch.from_numpy(ds.X_bin), g, h, mask, B_phys)
    got = fix_default_bins(expand_bundled(hp, meta, B), (g * mask).sum(),
                           (h * mask).sum(), mask.sum(), meta)
    want = hist_scatter(torch.from_numpy(flat.X_bin), g, h, mask, B)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.fixture(scope="module")
def trained(lgb_interp):
    lgb = lgb_interp
    X, y = _sparse_data()
    ref = lgb.train(PARAMS, lgb.Dataset(X, label=y), ROUNDS)
    port = lt.train(PARAMS, lt.Dataset(X, label=y), ROUNDS, device="cpu")
    return X, y, ref, port


def _assert_same_trees(ref, port, atol=1e-4):
    assert len(ref._gbdt.models) == len(port._gbdt.models)
    for rt, pt in zip(ref._gbdt.models, port._gbdt.models):
        assert rt.num_leaves == pt.num_leaves
        nn = rt.num_leaves - 1
        for name in ("split_feature", "threshold", "decision_type",
                     "left_child", "right_child"):
            np.testing.assert_array_equal(getattr(pt, name),
                                          getattr(rt, name)[:nn])
        np.testing.assert_array_equal(pt.leaf_count, rt.leaf_count)
        np.testing.assert_allclose(pt.leaf_value, rt.leaf_value, rtol=0,
                                   atol=atol)


def test_trees_equal_reference_on_a_bundled_matrix(trained):
    X, _, ref, port = trained
    gb = port._gbdt
    assert gb._bundled and gb._wave_mixed is None
    # a split on a bundled member: the decode is on the path
    bundled = set(np.flatnonzero(gb.train_ds.bundle.needs_fix).tolist())
    assert any(set(t.split_feature.tolist()) & bundled for t in gb.models)
    _assert_same_trees(ref, port)
    np.testing.assert_allclose(port.predict(X), ref.predict(X), rtol=0,
                               atol=1e-4)


def test_valid_set_on_bundled_columns(trained):
    """A valid set in the bundled layout replays the trees through the
    physical-column decode to the training scores."""
    X, y, _, port = trained
    port.add_valid(lt.Dataset(X, label=y, reference=port.train_set), "again")
    gb = port._gbdt
    np.testing.assert_array_equal(gb._valid_scores[-1].numpy(),
                                  gb._train_score.numpy())


def test_enable_bundle_false_is_the_identity(lgb_interp):
    lgb = lgb_interp
    X, y = _sparse_data()
    params = {**PARAMS, "enable_bundle": False}
    port = lt.train(params, lt.Dataset(X, label=y), ROUNDS, device="cpu")
    gb = port._gbdt
    assert gb.train_ds.bundle is None and not gb._bundled
    assert gb.train_ds.num_phys_features == gb.train_ds.num_features
    np.testing.assert_array_equal(gb.meta.feat2phys.numpy(),
                                  np.arange(gb.train_ds.num_features))
    assert not gb.meta.needs_fix.any()
    ref = lgb.train(params, lgb.Dataset(X, label=y), ROUNDS)
    _assert_same_trees(ref, port)


def test_quantized_modes_fall_back_to_2xbf16(lgb_interp, trained, capsys):
    """int16 on a bundled dataset trains as 2xbf16, with the reference's
    log line, in both packages: the same trees as the 2xbf16 run."""
    lgb = lgb_interp
    X, y, ref2, port2 = trained
    params = {**PARAMS, "tpu_hist_dtype": "int16", "verbose": 1}
    port = lt.train(params, lt.Dataset(X, label=y), ROUNDS, device="cpu")
    assert "falling back to 2xbf16" in capsys.readouterr().err
    assert port._gbdt.hist_mode == "2xbf16"
    ref = lgb.train(params, lgb.Dataset(X, label=y), ROUNDS)
    _assert_same_trees(ref, port)
    _assert_same_trees(port2, port, atol=0)


def test_convert_carries_bundles(trained):
    _, _, ref, _ = trained
    rds = ref._gbdt.train_ds
    pds = convert.dataset_from_numpy(
        rds.X_bin, [m.to_dict() for m in rds.bin_mappers], bundle=rds.bundle)
    assert pds.bundle.groups == rds.bundle.groups
    meta, B = build_device_meta(pds, None, "cpu")
    for k in meta._fields:
        np.testing.assert_array_equal(getattr(meta, k).numpy(),
                                      np.asarray(getattr(ref._gbdt.meta, k)))


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [False, True])
def test_kernel_at_bundled_shape_on_card(fused):
    """K1 on a bundled dataset's physical columns (unfused, as the
    bundled wave runs it; fused for comparison), packed, the layout's
    most slots, against the plain version at the f32 bound."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from test_torch_hist_wave import _assert_f32_close, _leaves, _slots
    from lightgbm_tpu_torch.ops import hist_wave as hw
    X, _ = _sparse_data(n=60_000, k=32, seed=11)
    ds = BinnedDataset.from_matrix(X, Config.from_params({"max_bin": 63}))
    bins = np.ascontiguousarray(ds.X_bin.T)
    F, N = bins.shape
    B = 256
    rng = np.random.default_rng(12)
    S = hw.wave_capacity_max(True)
    leaf = rng.integers(0, 2 * S, size=N).astype(np.int32)
    gv = rng.normal(size=N).astype(np.float32)
    hv = (0.05 + rng.random(size=N)).astype(np.float32)
    cv = np.ones(N, np.float32)
    t = [torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in
         (bins, gv, hv, cv, leaf, _slots(rng.permutation(2 * S)[:S], True))]
    par = None
    if fused:
        par = tuple(torch.randn((F, B, 128), device="cuda") * 50
                    for _ in range(2))
    got = hw.hist_wave(*t, B, highest="2xbf16", packed=True, parent=par,
                       num_slots=S)
    want = hw.hist_wave_plain(*t, B, highest="2xbf16", packed=True,
                              parent=par)
    mag = hw.hist_wave_plain(t[0], t[1].abs(), t[2].abs(), *t[3:], B,
                             highest="2xbf16", packed=True)
    _assert_f32_close(*(tuple(a.cpu() for a in _leaves(x))
                        for x in (got, want, mag)), True)
