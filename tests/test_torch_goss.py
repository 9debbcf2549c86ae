"""GOSS in the port against the JAX package on the CPU: the port's
threefry draw equals ``jax.random.uniform`` bit for bit, the sample mask
and the amplified gradients equal ``GOSS._bagging``'s on the same g/h,
the grown trees equal JAX GOSS's (the JAX side through the Pallas
interpreter, LGBM_TPU_FORCE_WAVE=interpret) in 2xbf16 and int16, and the
same parameter checks refuse.  On a card, the draw there equals the draw
on the CPU."""
import types

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.boosting.goss import GOSS
from lightgbm_tpu_torch.utils.random import fold_in, prng_key, uniform_f32
from test_torch_train import PARAMS, _data
from test_torch_train_quant import _assert_same_tree

ROUNDS = 5
# learning_rate 0.5: iterations 0 and 1 grow on every row, 2.. sample
GOSS_PARAMS = {**PARAMS, "boosting": "goss", "learning_rate": 0.5,
               "num_leaves": 15}


@pytest.fixture(scope="module")
def lgb_interp():
    pytest.importorskip("jax")
    import lightgbm_tpu as lgb
    mp = pytest.MonkeyPatch()
    mp.setenv("LGBM_TPU_FORCE_WAVE", "interpret")
    yield lgb
    mp.undo()


@pytest.mark.parametrize("n", [1, 7, 3000, 1_000_003])
def test_draw_equals_jax_uniform(n):
    jax = pytest.importorskip("jax")
    for seed, it in ((0, 0), (3, 10), (12345, 1), (2 ** 31 - 1, 99)):
        want = np.asarray(jax.random.uniform(
            jax.random.fold_in(jax.random.PRNGKey(seed), it), (n,)))
        got = uniform_f32(fold_in(prng_key(seed), it), n).numpy()
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))


def _goss_state(cfg, n, device="cpu"):
    return types.SimpleNamespace(
        config=cfg, train_ds=types.SimpleNamespace(num_data=n),
        device=torch.device(device), _key=prng_key(cfg.bagging_seed),
        _bag_mask=None)


@pytest.mark.parametrize("it", [0, 9, 10, 17])
def test_sample_equals_jax_bagging(it):
    """The same g/h through ``GOSS._bagging`` and the port's sampler: the
    mask and the amplified g/h equal (ties at the threshold included: g
    takes few values, so many rows tie)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from lightgbm_tpu.boosting.goss import GOSS as RefGOSS
    from lightgbm_tpu.config import Config as RefConfig
    from lightgbm_tpu_torch.config import Config
    n = 5000
    rng = np.random.default_rng(it)
    g = np.round(rng.normal(size=n), 1).astype(np.float32)
    h = rng.random(size=n).astype(np.float32) * 0.25 + 0.01
    params = {"boosting": "goss", "top_rate": 0.15, "other_rate": 0.2,
              "bagging_seed": 7, "learning_rate": 0.1}
    ref = _goss_state(RefConfig.from_params(params), n)
    rg, rh = RefGOSS._bagging(ref, it, jnp.asarray(g)[:, None],
                              jnp.asarray(h)[:, None])
    port = _goss_state(Config.from_params(params), n)
    pg, ph = GOSS._sample(port, it, torch.from_numpy(g), torch.from_numpy(h))
    np.testing.assert_array_equal(port._bag_mask.numpy(),
                                  np.asarray(ref._bag_mask))
    np.testing.assert_array_equal(pg.numpy(), np.asarray(rg)[:, 0])
    np.testing.assert_array_equal(ph.numpy(), np.asarray(rh)[:, 0])
    kept = float(port._bag_mask.sum()) / n
    assert kept == 1.0 if it < 10 else 0.2 < kept < 0.45


@pytest.mark.parametrize("extra", [{}, {"tpu_hist_dtype": "int16"}],
                         ids=["2xbf16", "int16"])
def test_trees_equal_jax_goss(lgb_interp, extra):
    lgb = lgb_interp
    X, y = _data(seed=1)
    params = {**GOSS_PARAMS, **extra}
    ref = lgb.train(params, lgb.Dataset(X, label=y), ROUNDS)
    port = lt.train(params, lt.Dataset(X, label=y), ROUNDS, device="cpu")
    assert len(ref._gbdt.models) == len(port._gbdt.models) == ROUNDS
    for rt, pt in zip(ref._gbdt.models, port._gbdt.models):
        _assert_same_tree(rt, pt)
    np.testing.assert_array_equal(port._gbdt._bag_mask.numpy(),
                                  np.asarray(ref._gbdt._bag_mask))
    assert float(port._gbdt._bag_mask.mean()) < 0.5   # the last one sampled


@pytest.mark.parametrize("bad", [
    {"top_rate": 0.7, "other_rate": 0.5}, {"top_rate": 0.0},
    {"other_rate": -0.1}, {"bagging_fraction": 0.5, "bagging_freq": 1}])
def test_init_refusals_match(lgb_interp, bad):
    lgb = lgb_interp
    X, y = _data(n=300)
    params = {**GOSS_PARAMS, **bad}
    with pytest.raises(lgb.basic.LightGBMError) as ref_err:
        lgb.train(params, lgb.Dataset(X, label=y), 1)
    with pytest.raises(lt.LightGBMError) as port_err:
        lt.train(params, lt.Dataset(X, label=y), 1, device="cpu")
    assert str(port_err.value).split(" in GOSS")[0] in str(ref_err.value)


@pytest.mark.cuda
def test_draw_on_card_equals_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    key = fold_in(prng_key(3), 11)
    cpu = uniform_f32(key, 1_000_003)
    card = uniform_f32(key, 1_000_003, "cuda")
    assert card.device.type == "cuda"
    assert torch.equal(card.cpu(), cpu)
