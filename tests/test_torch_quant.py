"""The port's quantized-gradient helpers against the JAX package:
``stochastic_round`` array-equal to lightgbm_tpu.ops.pallas_hist's over
~10^5 values (signed zeros, subnormals, integers, +-1e30, halves) for
three seeds; its floor-or-ceil and zero-preserving properties; and the
config surface of the int16/int8 modes and of bagging."""
import numpy as np
import pytest
import torch

from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.ops import quant
from lightgbm_tpu_torch.utils.log import LightGBMError

SEEDS = [0, 7, 0x9E3779B9]


def _values():
    rng = np.random.default_rng(11)
    special = np.array([0.0, -0.0, 1e30, -1e30, 3e38, -3e38, 1e-40, -1e-40,
                        1e-45, -1e-45, 1.17e-38, 0.5, -0.5, 1.5, -2.5,
                        32767.0, -32767.0, 127.0, -127.0, 2.0 ** 24],
                       np.float32)
    return np.concatenate([
        special,
        (rng.normal(size=40_000) * 3e4).astype(np.float32),
        rng.normal(size=20_000).astype(np.float32),
        rng.integers(-40_000, 40_000, size=15_000).astype(np.float32),
        rng.integers(-40_000, 40_000, size=15_000).astype(np.float32) + 0.5,
        (rng.random(size=10_000) * 1e-38).astype(np.float32),   # subnormal
    ]).astype(np.float32)


@pytest.mark.parametrize("seed", SEEDS)
def test_stochastic_round_bit_identical_to_reference(seed):
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from lightgbm_tpu.ops.pallas_hist import stochastic_round as ref
    x = _values()
    want = np.asarray(ref(jnp.asarray(x), jnp.uint32(seed)))
    got = quant.stochastic_round(torch.from_numpy(x), seed).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("seed", SEEDS)
def test_stochastic_round_is_floor_or_ceil_and_keeps_zeros(seed):
    """floor(x) or ceil(x) — except that ``x + u`` is rounded to f32 before
    the floor, so an integer-valued x whose spacing exceeds 1 - u rounds up
    to x + 1 (the reference does the same, bit for bit).  Such cases are
    rare: a few in 10^4 at the int16 range."""
    x = _values()
    x = x[np.abs(x) < 1e7]
    got = quant.stochastic_round(torch.from_numpy(x), seed).numpy()
    up = got - np.floor(x)
    assert np.all((up == 0) | (up == 1))
    off = ~((got == np.floor(x)) | (got == np.ceil(x)))
    assert np.all(x[off] == np.round(x[off])) and off.mean() < 1e-3
    zeros = quant.stochastic_round(torch.tensor([0.0, -0.0]), seed)
    assert torch.equal(zeros, torch.zeros(2))


def test_quant_error_bound_and_constants():
    assert quant.QUANT_MODES == ("int16", "int8")
    assert quant.QUANT_QMAX == {"int16": 32767.0, "int8": 127.0}
    np.testing.assert_allclose(quant.quant_error_bound([0, 3, 10], 0.25),
                               [0.0, 0.75, 2.5])


def test_config_quantized_modes_and_bagging():
    assert Config.from_params({"tpu_hist_dtype": "int16"}).hist_mode() == "int16"
    assert Config.from_params({"tpu_hist_dtype": "int8"}).hist_mode() == "int8"
    # an explicit double-precision ask outranks a quantization ask
    assert Config.from_params({"tpu_hist_dtype": "int8",
                               "gpu_use_dp": True}).hist_mode() == "highest"
    Config.from_params({"tpu_hist_dtype": "int16", "num_leaves": 32000})
    with pytest.raises(LightGBMError, match="32000"):
        Config.from_params({"tpu_hist_dtype": "int16", "num_leaves": 32001})
    Config.from_params({"num_leaves": 40000})          # float modes: no cap
    assert Config().bagging_seed == 3
    cfg = Config.from_params({"bagging_fraction_seed": 11, "subsample": 0.5,
                              "subsample_freq": 2, "pos_bagging": 0.4})
    assert (cfg.bagging_seed, cfg.bagging_fraction, cfg.bagging_freq,
            cfg.pos_bagging_fraction) == (11, 0.5, 2, 0.4)
    with pytest.raises(LightGBMError, match="bagging_fraction"):
        Config.from_params({"bagging_fraction": 0.0})
    # GOSS, DART and RF are in the port; an unknown boosting is refused
    assert Config.from_params({"boosting": "goss"}).boosting == "goss"
    assert Config.from_params({"boosting": "dart"}).boosting == "dart"
    with pytest.raises(LightGBMError, match="boosting"):
        Config.from_params({"boosting": "dartboard"})
