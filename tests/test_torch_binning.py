"""Host binning of the port against the JAX package: identical bin
bounds and identical X_bin bytes on seeded matrices with NaNs and zeros,
with and without row sampling, for training and validation data."""
import numpy as np
import pytest

from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.io.dataset import BinnedDataset


def _matrix(n=5000, f=8, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f))
    X[:, 1] = np.round(X[:, 1] * 3)                  # few distinct values
    X[rng.random(size=n) < 0.5, 2] = 0.0             # half zeros
    X[rng.random(size=(n, f)) < 0.1] = np.nan        # NaNs everywhere
    X[:, 4] = np.abs(X[:, 4])                        # one-signed + zeros
    X[:, 5] = -np.abs(X[:, 5])
    X[:, 6] = 7.0                                    # constant: trivial
    X[:, 7] = rng.exponential(size=n) * 1e3
    return X


CASES = [({"max_bin": 255}, 0), ({"max_bin": 63}, 1),
         ({"max_bin": 255, "bin_construct_sample_cnt": 1500}, 2),
         ({"max_bin": 15, "min_data_in_bin": 10, "zero_as_missing": True}, 3),
         ({"max_bin": 63, "use_missing": False}, 4)]


@pytest.mark.parametrize("params,seed", CASES)
def test_bins_identical_to_reference(params, seed):
    pytest.importorskip("jax")
    from lightgbm_tpu.config import Config as RefConfig
    from lightgbm_tpu.io.dataset import BinnedDataset as RefDataset
    X = _matrix(seed=seed)
    ref = RefDataset.from_matrix(X, RefConfig.from_params(dict(params)))
    port = BinnedDataset.from_matrix(X, Config.from_params(dict(params)))
    assert ref.bundle is None
    np.testing.assert_array_equal(port.real_feature_idx, ref.real_feature_idx)
    for pm, rm in zip(port.bin_mappers, ref.bin_mappers):
        assert (pm.num_bin, pm.missing_type, pm.is_trivial, pm.default_bin) \
            == (rm.num_bin, rm.missing_type, rm.is_trivial, rm.default_bin)
        np.testing.assert_array_equal(pm.bin_upper_bound, rm.bin_upper_bound)
        assert (pm.min_val, pm.max_val) == (rm.min_val, rm.max_val)
    assert port.X_bin.dtype == ref.X_bin.dtype == np.uint8
    assert port.X_bin.tobytes() == ref.X_bin.tobytes()
    # validation data binned in the training bin space
    Xv = _matrix(n=700, seed=seed + 10)
    assert (BinnedDataset.from_matrix(Xv, Config(), reference=port).X_bin
            .tobytes()
            == RefDataset.from_matrix(Xv, RefConfig(), reference=ref).X_bin
            .tobytes())


def test_bundling_candidates_refused():
    """Two mostly-zero, mutually exclusive columns are EFB candidates.  The
    port once refused them; it now bundles them as the reference does
    (same groups, same bytes), and with bundling off bins them like the
    reference too."""
    pytest.importorskip("jax")
    from lightgbm_tpu.config import Config as RefConfig
    from lightgbm_tpu.io.dataset import BinnedDataset as RefDataset
    X = _matrix(seed=5)
    rng = np.random.default_rng(5)
    for j in (0, 3):
        X[(rng.random(size=len(X)) < 0.9) | np.isnan(X[:, j]), j] = 0.0
    X[X[:, 0] != 0.0, 3] = 0.0          # never non-zero in the same row
    # 63 bins each: two columns fit one 256-bin group
    port = BinnedDataset.from_matrix(X, Config.from_params({"max_bin": 63}))
    ref = RefDataset.from_matrix(X, RefConfig.from_params({"max_bin": 63}))
    assert ref.bundle is not None and port.bundle is not None
    assert port.bundle.groups == ref.bundle.groups
    assert port.X_bin.tobytes() == ref.X_bin.tobytes()
    off = {"enable_bundle": False}
    port = BinnedDataset.from_matrix(X, Config.from_params(off))
    ref = RefDataset.from_matrix(X, RefConfig.from_params(off))
    assert port.bundle is None
    assert port.X_bin.tobytes() == ref.X_bin.tobytes()
