"""Quantized (int16/int8) and bagged training in the port against the JAX
package on the CPU (the JAX side through the Pallas interpreter,
LGBM_TPU_FORCE_WAVE=interpret).

* int16, int16 + bagging, 2xbf16 + bagging and balanced pos/neg bagging:
  five trees identical in structure, leaf values within 1e-4 (the f32
  split-scan sums run in another order, as in test_torch_train.py), the
  bag masks equal at every iteration.
* int8: the first tree identical; after it the two packages' training
  scores differ in the last bits (the split scan's f32 sums run in another
  order, and XLA's exp differs from torch's by an ulp on some inputs), and
  under int8's 1/127 steps one ulp of a gradient re-draws that row's
  stochastic rounding.  So the later rounds are held by replaying the
  port's own grower inputs through the reference grower: identical trees
  at every round, and the end-to-end train AUC within the reference's
  int8 budget (1e-2).
* The grower replay also covers the triple layout and the unfused sibling
  in both int modes.
"""
import numpy as np
import pytest

import lightgbm_tpu_torch as lt
from test_torch_train import PARAMS, _data

ROUNDS = 5
SEED = 1          # the fixture's seed: no near-tied split gains (seed 0 has
#                   one in the bagged 2xbf16 run, gains 9.310828 / 9.310836)
BAG = {"bagging_fraction": 0.8, "bagging_freq": 1}


@pytest.fixture(scope="module")
def lgb_interp():
    pytest.importorskip("jax")
    import lightgbm_tpu as lgb
    mp = pytest.MonkeyPatch()
    mp.setenv("LGBM_TPU_FORCE_WAVE", "interpret")
    yield lgb
    mp.undo()


def _assert_same_tree(rt, pt, atol=1e-4):
    assert rt.num_leaves == pt.num_leaves
    nn = rt.num_leaves - 1
    np.testing.assert_array_equal(rt.split_feature[:nn], pt.split_feature)
    np.testing.assert_array_equal(rt.threshold[:nn], pt.threshold)
    np.testing.assert_array_equal(rt.left_child[:nn], pt.left_child)
    np.testing.assert_array_equal(rt.right_child[:nn], pt.right_child)
    np.testing.assert_array_equal(rt.leaf_count, pt.leaf_count)
    np.testing.assert_allclose(pt.leaf_value, rt.leaf_value, rtol=0,
                               atol=atol)


def _train_both(lgb, extra, rounds=ROUNDS):
    """Both packages, iteration by iteration; returns the boosters and
    whether the bag masks agreed after every iteration."""
    X, y = _data(seed=SEED)
    params = {**PARAMS, **extra}
    ref = lgb.Booster(params, lgb.Dataset(X, label=y))
    port = lt.Booster(params, lt.Dataset(X, label=y), device="cpu")
    masks = []
    for _ in range(rounds):
        ref.update()
        port.update()
        masks.append(np.array_equal(ref._gbdt._bag_mask_host,
                                    port._gbdt._bag_mask_host))
    return X, y, ref, port, masks


@pytest.mark.parametrize("extra", [
    {"tpu_hist_dtype": "int16"},
    # seed 93 rounds the scaled hessians' maximum of 32767 up to 32768 in
    # about half the K1 launches; the int16 stream saturates it as the
    # reference's cast does
    {"tpu_hist_dtype": "int16", "seed": 93},
    {"tpu_hist_dtype": "int16", **BAG},
    BAG,
    {"pos_bagging_fraction": 0.7, "neg_bagging_fraction": 0.5,
     "bagging_freq": 2}], ids=["int16", "int16-saturating", "int16-bagging",
                               "2xbf16-bagging", "balanced-bagging"])
def test_training_matches_reference(lgb_interp, extra):
    _, _, ref, port, masks = _train_both(lgb_interp, extra)
    assert all(masks)
    if "bagging_freq" in extra:
        assert not port._gbdt._bag_mask_host.all()
    assert len(ref._gbdt.models) == len(port._gbdt.models) == ROUNDS
    for rt, pt in zip(ref._gbdt.models, port._gbdt.models):
        _assert_same_tree(rt, pt)


def _auc(y, score):
    order = np.argsort(score)
    ranks = np.empty(len(y))
    ranks[order] = np.arange(1, len(y) + 1)
    pos = y == 1
    return (ranks[pos].sum() - pos.sum() * (pos.sum() + 1) / 2) / (
        pos.sum() * (~pos).sum())


def test_int8_training_first_tree_and_auc_budget(lgb_interp):
    X, y, ref, port, masks = _train_both(lgb_interp,
                                         {"tpu_hist_dtype": "int8", **BAG})
    assert all(masks)
    _assert_same_tree(ref._gbdt.models[0], port._gbdt.models[0])
    a_ref = _auc(y, ref.predict(X, raw_score=True))
    a_port = _auc(y, port.predict(X, raw_score=True))
    assert abs(a_ref - a_port) <= 1e-2, (a_ref, a_port)


def _reference_grower(lgb, X, y, params, packed, fused):
    import jax
    from lightgbm_tpu.config import Config as RefConfig
    from lightgbm_tpu.core.meta import SplitConfig, build_device_meta
    from lightgbm_tpu.core.wave_grower import build_wave_grow_fn
    cfg = RefConfig.from_params(params)
    ds = lgb.Dataset(X, label=y, params=params).construct()._handle
    meta, B = build_device_meta(ds)
    grow = build_wave_grow_fn(
        meta, SplitConfig.from_config(cfg), B,
        wave_capacity=int(cfg.tpu_wave_capacity), highest=params[
            "tpu_hist_dtype"], interpret=True,
        gain_gate=float(cfg.tpu_wave_gain_gate), packed=packed,
        fused_sibling=fused, quant_seed=int(cfg.seed))
    return jax.jit(grow)


@pytest.mark.parametrize("mode,packed,fused", [
    ("int8", True, True), ("int8", False, True), ("int16", False, False),
    ("int16", True, False)])
def test_grower_replays_reference(lgb_interp, mode, packed, fused):
    """The port's grower inputs of each bagged round (gradients, hessians,
    bag mask) through both growers in one layout: the same tree and the
    same row partition every round."""
    import jax.numpy as jnp
    import torch
    from lightgbm_tpu_torch.core.wave_grower import build_wave_grow_fn
    X, y = _data(seed=SEED)
    params = {**PARAMS, "tpu_hist_dtype": mode, **BAG, "seed": 5}
    port = lt.Booster(params, lt.Dataset(X, label=y), device="cpu")
    gb = port._gbdt
    calls = []
    inner = gb._grow

    def record(*args):
        calls.append([a.clone() for a in args])
        return inner(*args)
    gb._grow = record
    for _ in range(3):
        port.update()
    port_grow = build_wave_grow_fn(
        gb.meta, gb.split_cfg, gb.B, highest=mode, packed=packed,
        fused_sibling=fused, gain_gate=float(gb.config.tpu_wave_gain_gate),
        quant_seed=5)
    ref_grow = _reference_grower(lgb_interp, X, y, params, packed, fused)
    for bins_fm, g, h, mask, fmask in calls:
        mine, leaf_id, _ = port_grow(bins_fm, g, h, mask, fmask)
        theirs, ref_leaf = ref_grow(*(jnp.asarray(t.numpy()) for t in
                                      (bins_fm, g, h, mask, fmask)))
        n = int(theirs.num_leaves)
        assert int(mine.num_leaves) == n > 2
        for k in ("split_feature", "threshold_bin", "left_child",
                  "right_child", "default_left"):
            np.testing.assert_array_equal(
                getattr(mine, k)[:n - 1].numpy(),
                np.asarray(getattr(theirs, k))[:n - 1], err_msg=k)
        np.testing.assert_array_equal(mine.leaf_count[:n].numpy(),
                                      np.asarray(theirs.leaf_count)[:n])
        # unshrunk outputs (~1): the split scan's f32 sums in another order
        np.testing.assert_allclose(mine.leaf_value[:n].numpy(),
                                   np.asarray(theirs.leaf_value)[:n],
                                   rtol=0, atol=1e-4)
        np.testing.assert_array_equal(leaf_id.numpy(), np.asarray(ref_leaf))
    assert not torch.equal(calls[0][3], calls[1][3])     # a fresh bag


@pytest.mark.cuda
def test_card_int16_training_matches_cpu():
    """The card's quantized K1 against the CPU's plain K1 inside a whole
    bagged int16 run: the same trees; predictions within 1e-4 (the
    objective's exp differs by an ulp between the two devices, which moves
    a row's rounding by one int16 step, ~3e-5 of max|g|)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    X, y = _data(seed=SEED)
    params = {**PARAMS, "tpu_hist_dtype": "int16", **BAG}
    cpu = lt.train(params, lt.Dataset(X, label=y), ROUNDS, device="cpu")
    card = lt.train(params, lt.Dataset(X, label=y), ROUNDS, device="cuda")
    for a, b in zip(cpu._gbdt.models, card._gbdt.models):
        np.testing.assert_array_equal(a.split_feature, b.split_feature)
        np.testing.assert_array_equal(a.threshold, b.threshold)
    np.testing.assert_allclose(card.predict(X), cpu.predict(X), atol=1e-4)
