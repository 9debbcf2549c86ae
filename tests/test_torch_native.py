"""Native binning and text loading of the port against the JAX package:
the port's own g++ library builds, its native path and its numpy path give
the JAX package's bin bounds and X_bin bytes, ``max_bin_by_feature`` and
forced bins give the JAX package's bounds, and ``load_text`` returns the
JAX package's arrays."""
import json

import numpy as np
import pytest

from lightgbm_tpu_torch import native
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.io.dataset import BinnedDataset
from lightgbm_tpu_torch.io.text_loader import load_text
from lightgbm_tpu_torch.utils.log import LightGBMError


def _matrix(n=50_000, f=28, seed=0):
    """HIGGS-shaped columns with NaNs, exact zeros, a few-valued column, a
    one-signed pair and a constant."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f))
    X[rng.random(size=(n, f)) < 0.05] = np.nan
    X[rng.random(size=(n, f)) < 0.1] = 0.0
    X[:, 3] = np.round(X[:, 3] * 2)
    X[:, 4] = np.abs(X[:, 4])
    X[:, 5] = -np.abs(X[:, 5])
    X[:, 6] = 3.5
    X[:, 7] = rng.exponential(size=n) * 1e4
    return X


def _ref_dataset(X, params):
    from lightgbm_tpu.config import Config as RefConfig
    from lightgbm_tpu.io.dataset import BinnedDataset as RefDataset
    return RefDataset.from_matrix(X, RefConfig.from_params(dict(params)))


def _assert_same_bins(port, ref):
    np.testing.assert_array_equal(port.real_feature_idx, ref.real_feature_idx)
    for pm, rm in zip(port.bin_mappers, ref.bin_mappers):
        assert (pm.num_bin, pm.missing_type, pm.is_trivial, pm.default_bin) \
            == (rm.num_bin, rm.missing_type, rm.is_trivial, rm.default_bin)
        np.testing.assert_array_equal(pm.bin_upper_bound, rm.bin_upper_bound)
    assert port.X_bin.dtype == ref.X_bin.dtype == np.uint8
    assert port.X_bin.tobytes() == ref.X_bin.tobytes()


def test_native_library_builds():
    lib = native.lib()
    assert lib is not None
    assert native.BUILD_DIR.name == "build"
    assert str(native.BUILD_DIR) in lib._name


@pytest.mark.parametrize("path", ["native", "numpy"])
def test_bins_identical_to_reference(path, monkeypatch):
    """50,000 x 28 with NaNs and zeros: the native path (the default here)
    and the numpy path (native library hidden) both give the JAX package's
    bounds and bytes."""
    pytest.importorskip("jax")
    X = _matrix()
    params = {"max_bin": 255, "bin_construct_sample_cnt": 20_000}
    ref = _ref_dataset(X, params)
    if path == "numpy":
        monkeypatch.setattr(native, "lib", lambda: None)
    _assert_same_bins(BinnedDataset.from_matrix(
        X, Config.from_params(params)), ref)


def test_native_and_numpy_paths_agree(monkeypatch):
    """The two paths of the port on its own: bounds, and value_to_bin on
    more than the native cut-over's 1,024 values, NaN included."""
    X = _matrix(n=20_000, seed=3)
    params = Config.from_params({"max_bin": 63})
    fast = BinnedDataset.from_matrix(X, params)
    monkeypatch.setattr(native, "lib", lambda: None)
    slow = BinnedDataset.from_matrix(X, params)
    for a, b in zip(fast.bin_mappers, slow.bin_mappers):
        np.testing.assert_array_equal(a.bin_upper_bound, b.bin_upper_bound)
        np.testing.assert_array_equal(a.value_to_bin(X[:, 0]),
                                      b.value_to_bin(X[:, 0]))
    assert fast.X_bin.tobytes() == slow.X_bin.tobytes()


def test_max_bin_by_feature_and_forced_bins(tmp_path):
    pytest.importorskip("jax")
    X = _matrix(n=8_000, f=8, seed=1)
    forced = tmp_path / "forced.json"
    forced.write_text(json.dumps([
        {"feature": 0, "bin_upper_bound": [-1.0, 0.25, 1.5]},
        {"feature": 7, "bin_upper_bound": [100.0, 2000.0]},
        {"feature": 2, "bin_upper_bound": [0.3]}]))
    params = {"max_bin": 63, "max_bin_by_feature": [7, 63, 15, 4, 255, 31,
                                                    8, 2],
              "forcedbins_filename": str(forced)}
    port = BinnedDataset.from_matrix(X, Config.from_params(params))
    _assert_same_bins(port, _ref_dataset(X, params))
    assert port.bin_mappers[0].num_bin <= 7
    for b in (-1.0, 0.25, 1.5):
        assert b in port.bin_mappers[0].bin_upper_bound


def test_max_bin_by_feature_checks():
    X = _matrix(n=1_000, f=8, seed=2)
    with pytest.raises(LightGBMError, match="same size"):
        BinnedDataset.from_matrix(
            X, Config.from_params({"max_bin_by_feature": [15, 15]}))
    # values above 255 are allowed now (wide columns); 1 or less is not
    with pytest.raises(LightGBMError, match="greater than 1"):
        BinnedDataset.from_matrix(X, Config.from_params(
            {"max_bin_by_feature": [15, 1] + [15] * 6}))


@pytest.mark.parametrize("delim,header,label", [
    (",", False, ""), ("\t", True, "name:target"), ("\t", False, "2"),
    (",", True, "0")])
def test_load_text_matches_reference(tmp_path, delim, header, label):
    pytest.importorskip("jax")
    from lightgbm_tpu.config import Config as RefConfig
    from lightgbm_tpu.io.text_loader import load_text as ref_load
    rng = np.random.default_rng(4)
    data = rng.normal(size=(500, 6)).round(6)
    data[rng.random(size=data.shape) < 0.05] = np.nan
    path = tmp_path / "data.txt"
    names = ["a", "b", "target", "c", "d", "e"]
    with open(path, "w") as fh:
        if header:
            fh.write(delim.join(names) + "\n")
        for row in data:
            fh.write(delim.join(repr(float(v)) for v in row) + "\n")
    params = {"header": header, "label_column": label,
              "ignore_column": "3" if label == "2" else ""}
    X, y, _, _, fnames = load_text(str(path), Config.from_params(params))
    rX, ry, _, _, rnames = ref_load(str(path), RefConfig.from_params(params))
    np.testing.assert_array_equal(X, rX)
    np.testing.assert_array_equal(y, ry)
    assert fnames == rnames
    # bit-equal to np.loadtxt
    want = np.loadtxt(path, delimiter=delim, skiprows=int(header), ndmin=2)
    col = names.index("target") if label == "name:target" else int(label or 0)
    np.testing.assert_array_equal(y, want[:, col])


@pytest.mark.parametrize("header", [False, True])
def test_load_text_weight_and_group_columns(tmp_path, header):
    """``weight_column`` / ``group_column`` (index forms not counting the
    label, ``name:`` forms) give the JAX package's arrays: the weights,
    the query sizes from adjacent ids, and X without those columns."""
    pytest.importorskip("jax")
    from lightgbm_tpu.config import Config as RefConfig
    from lightgbm_tpu.io.text_loader import load_text as ref_load
    rng = np.random.default_rng(5)
    qid = np.repeat(np.arange(9), rng.integers(1, 12, size=9))
    n = len(qid)
    data = np.column_stack([rng.integers(0, 4, n), rng.normal(size=n),
                            qid, rng.uniform(0.5, 2, n).round(3),
                            rng.normal(size=n)])
    path = tmp_path / "rank.tsv"
    names = ["y", "f0", "qid", "w", "f1"]
    with open(path, "w") as fh:
        if header:
            fh.write("\t".join(names) + "\n")
        for row in data:
            fh.write("\t".join(repr(float(v)) for v in row) + "\n")
    params = ({"header": True, "weight_column": "name:w",
               "group_column": "name:qid"} if header else
              {"weight_column": "2", "group_column": "1"})
    got = load_text(str(path), Config.from_params(params))
    want = ref_load(str(path), RefConfig.from_params(params))
    for a, b in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(a, b)
    assert got[4] == want[4]
    np.testing.assert_array_equal(got[2], data[:, 3])
    np.testing.assert_array_equal(got[3], np.bincount(qid))
    assert got[0].shape == (n, 2)


def test_load_text_refusals(tmp_path):
    """What load_text still refuses: a missing data file, a ``name:``
    column without a header, a missing init-score file.  (LibSVM files,
    two_round and the .weight/.query/.init sidecars load since the eighth
    slice: tests/test_torch_libsvm.py.)"""
    from lightgbm_tpu_torch.io.text_loader import load_init_scores
    cfg = Config()
    with pytest.raises(LightGBMError, match="does not exist"):
        load_text(str(tmp_path / "absent.tsv"), cfg)
    dense = tmp_path / "data.tsv"
    dense.write_text("1\t0.5\t2.0\n0\t0.1\t3.0\n")
    with pytest.raises(LightGBMError, match="not found in header"):
        load_text(str(dense), Config.from_params(
            {"label_column": "name:target"}))
    with pytest.raises(LightGBMError, match="does not exist"):
        load_init_scores(str(dense), str(tmp_path / "absent.init"))
    (tmp_path / "data.tsv.weight").write_text("1\n2\n")
    assert load_text(str(dense), cfg)[2].tolist() == [1.0, 2.0]