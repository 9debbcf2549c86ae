"""LibSVM files, sidecars, two_round loading and binary dataset files
against the JAX package's loaders: ``label [qid:Q] idx:val`` rows as a CSR
with ``qid:`` query boundaries, the ``.weight``/``.query``/``.init``
sidecars, ``load_text_two_round`` (dense and LibSVM), ``save_binary`` files
that load in either package, and the CLI's ``two_round``, ``input_model``
and init-score file.

Tolerances: parsed arrays and binned matrices equal; model trees equal."""
import os

import numpy as np
import pytest

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import native
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.io import dataset_io
from lightgbm_tpu_torch.io.text_loader import (load_init_scores, load_text,
                                               load_text_two_round)


def _rank_file(path, n_queries=40, f=12, seed=0):
    rng = np.random.default_rng(seed)
    sizes = rng.integers(3, 20, size=n_queries)
    n = int(sizes.sum())
    X = rng.normal(size=(n, f))
    X[rng.random((n, f)) < 0.4] = 0.0
    y = np.clip(np.round(X[:, 0] + X[:, 1] + rng.normal(size=n)), 0, 4)
    qid = np.repeat(np.arange(n_queries) + 100, sizes)
    with open(path, "w") as fh:
        for i in range(n):
            toks = [f"{int(y[i])}", f"qid:{qid[i]}"] + [
                f"{j + 1}:{X[i, j]:.6g}" for j in range(f) if X[i, j] != 0]
            fh.write(" ".join(toks) + "\n")
    return n, sizes


def _ref_config(params=None):
    pytest.importorskip("jax")
    from lightgbm_tpu.config import Config as RefConfig
    return RefConfig.from_params(params or {})


def _same_loaded(got, want):
    Xg, Xw = got[0], want[0]
    if hasattr(Xw, "tocsr"):
        assert Xg.shape == Xw.shape
        np.testing.assert_array_equal(Xg.toarray(), Xw.toarray())
    else:
        np.testing.assert_array_equal(Xg, Xw)
    for a, b in zip(got[1:4], want[1:4]):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)
    assert list(got[4]) == list(want[4])


@pytest.mark.parametrize("parser", ["native", "python"])
def test_libsvm_with_qid_matches_reference(tmp_path, monkeypatch, parser):
    from lightgbm_tpu.io.text_loader import load_text as ref_load
    path = str(tmp_path / "rank.svm")
    n, sizes = _rank_file(path)
    want = ref_load(path, _ref_config())
    if parser == "python":
        monkeypatch.setattr(native, "lib", lambda: None)
    got = load_text(path, Config())
    _same_loaded(got, want)
    assert got[0].shape == (n, 13)
    np.testing.assert_array_equal(got[3], sizes)


def test_sidecars_match_reference(tmp_path):
    from lightgbm_tpu.app import _load_init_scores
    from lightgbm_tpu.io.text_loader import load_text as ref_load
    rng = np.random.default_rng(1)
    dense = str(tmp_path / "d.tsv")
    data = np.column_stack([rng.integers(0, 2, 30), rng.normal(size=(30, 3))])
    np.savetxt(dense, data, delimiter="\t")
    np.savetxt(dense + ".weight", rng.uniform(0.5, 2, 30))
    np.savetxt(dense + ".query", [10, 20], fmt="%d")
    np.savetxt(dense + ".init", rng.normal(size=(30, 3)))
    _same_loaded(load_text(dense, Config()), ref_load(dense, _ref_config()))
    np.testing.assert_array_equal(load_init_scores(dense),
                                  _load_init_scores(dense))
    assert load_init_scores(dense).shape == (90,)       # class major
    svm = str(tmp_path / "r.svm")
    _rank_file(svm, n_queries=5)
    rows = load_text(svm, Config())[0].shape[0]
    np.savetxt(svm + ".weight", rng.uniform(0.5, 2, rows))
    np.savetxt(svm + ".query", [rows - 4, 4], fmt="%d")   # beats qid:
    got, want = load_text(svm, Config()), ref_load(svm, _ref_config())
    _same_loaded(got, want)
    np.testing.assert_array_equal(got[3], [rows - 4, 4])


@pytest.mark.parametrize("sample_cnt", [200000, 150])
def test_two_round_dense_matches_reference(tmp_path, sample_cnt):
    """Reservoir sampling of the lines (``bin_construct_sample_cnt`` below
    the rows draws from ``default_rng(data_random_seed)`` as the JAX
    package does): equal mappers and ``X_bin``."""
    from lightgbm_tpu.io.text_loader import load_text_two_round as ref_two
    rng = np.random.default_rng(2)
    path = str(tmp_path / "d.csv")
    data = np.column_stack([rng.integers(0, 2, 500), rng.normal(size=(500, 6)),
                            rng.integers(0, 5, 500)])
    np.savetxt(path, data, delimiter=",", fmt="%.7g")
    params = {"bin_construct_sample_cnt": sample_cnt, "max_bin": 31,
              "ignore_column": "6"}
    got = load_text_two_round(path, Config.from_params(params))
    want = ref_two(path, _ref_config(params))
    np.testing.assert_array_equal(got[0].X_bin, want[0].X_bin)
    assert [m.to_dict() for m in got[0].bin_mappers] == \
        [m.to_dict() for m in want[0].bin_mappers]
    np.testing.assert_array_equal(got[1], want[1])
    if sample_cnt > 500:
        X, *_ = load_text(path, Config.from_params(params))
        from lightgbm_tpu_torch.io.dataset import BinnedDataset
        np.testing.assert_array_equal(BinnedDataset.from_matrix(
            X, Config.from_params(params)).X_bin, got[0].X_bin)


@pytest.mark.parametrize("sample_cnt", [200000, 100])
def test_two_round_libsvm_equals_in_memory(tmp_path, sample_cnt):
    """LibSVM two_round streams through ``ingest/``: its reservoir draws
    the JAX package's rows, so the binned dataset is the JAX package's at
    any sample size, and the in-memory ``from_csr`` one's while the sample
    holds every row."""
    from lightgbm_tpu.io.text_loader import load_text_two_round as ref_two
    from lightgbm_tpu_torch.io.dataset import BinnedDataset
    path = str(tmp_path / "rank.svm")
    n, sizes = _rank_file(path, n_queries=60)
    params = {"bin_construct_sample_cnt": sample_cnt, "max_bin": 31}
    cfg = Config.from_params(params)
    handle, label, weight, group, names = load_text_two_round(path, cfg)
    X, label_mem, *_ = load_text(path, cfg)
    np.testing.assert_array_equal(label, label_mem)
    np.testing.assert_array_equal(group, sizes)
    want = ref_two(path, _ref_config(params))
    np.testing.assert_array_equal(handle.X_bin, want[0].X_bin)
    if sample_cnt >= n:
        mem = BinnedDataset.from_csr(X, cfg)
        np.testing.assert_array_equal(handle.X_bin, mem.X_bin)


def test_binary_dataset_files_load_across_packages(tmp_path):
    pytest.importorskip("jax")
    import lightgbm_tpu as lgb
    from lightgbm_tpu.io import dataset_io as ref_io
    rng = np.random.default_rng(3)
    X = rng.normal(size=(400, 6))
    X[:, 5] = rng.integers(0, 4, 400)
    y = (X[:, 0] > 0).astype(float)
    w, init = rng.uniform(0.5, 2, 400), rng.normal(size=400)
    port_ds = lt.Dataset(X, label=y, weight=w, init_score=init,
                         group=[100, 300]).construct()
    path = str(tmp_path / "port.bin")
    port_ds.save_binary(path)
    assert dataset_io.is_dataset_file(path)
    loaded_ref = ref_io.load_dataset(path)
    ref_ds = lgb.Dataset(X, label=y, weight=w, init_score=init,
                         group=[100, 300]).construct()
    ref_path = str(tmp_path / "ref.bin")
    ref_ds.save_binary(ref_path)                 # writes ref.bin.npz
    loaded_port = dataset_io.load_dataset(ref_path + ".npz")
    for a in (loaded_ref, loaded_port):
        np.testing.assert_array_equal(a.X_bin, port_ds._handle.X_bin)
        np.testing.assert_array_equal(a.metadata.label, y)
        np.testing.assert_array_equal(a.metadata.weights, w.astype(
            np.float32))
        np.testing.assert_array_equal(a.metadata.init_score, init)
        np.testing.assert_array_equal(a.metadata.query_boundaries,
                                      [0, 100, 400])
    text = tmp_path / "rows.tsv"
    text.write_text("1\t0.5\n")
    with pytest.raises(lt.LightGBMError, match="not a binned dataset"):
        lt.Dataset(str(text)).construct()
    params = {"objective": "binary", "num_leaves": 7, "verbose": -1}
    a = lt.train(params, lt.Dataset(path), 2, device="cpu")
    b = lt.train(params, lt.Dataset(X, label=y, weight=w, init_score=init),
                 2, device="cpu")
    assert a.model_to_string() == b.model_to_string()


def _cli(args):
    from lightgbm_tpu_torch import app
    app.main(["device_type=cpu", "verbosity=-1", *args])


def _trees(path):
    with open(path) as fh:
        return fh.read().split("end of trees")[0]


def test_cli_two_round_input_model_and_init_file(tmp_path):
    path = str(tmp_path / "rank.svm")
    _rank_file(path, n_queries=80)
    common = [f"data={path}", "objective=lambdarank", "num_trees=2",
              "num_leaves=7", "min_data_in_leaf=5"]
    for tr in ("false", "true"):
        _cli([*common, f"two_round={tr}",
              f"output_model={tmp_path / f'm_{tr}.txt'}"])
    assert _trees(tmp_path / "m_false.txt") == _trees(tmp_path / "m_true.txt")
    _cli([*common, f"input_model={tmp_path / 'm_false.txt'}",
          f"output_model={tmp_path / 'cont.txt'}"])
    assert _trees(tmp_path / "cont.txt").count("\nTree=") == 4
    rows = load_text(path, Config())[0].shape[0]
    init = str(tmp_path / "start.txt")
    np.savetxt(init, np.full(rows, 0.5))
    _cli([*common, f"initscore_filename={init}", "save_binary=true",
          f"output_model={tmp_path / 'init.txt'}"])
    assert os.path.exists(path + ".bin")
    _cli([f"data={path}.bin", *common[1:],
          f"output_model={tmp_path / 'from_bin.txt'}"])
    assert _trees(tmp_path / "init.txt") == _trees(tmp_path / "from_bin.txt")
    assert "init_score" in str(dataset_io.load_dataset(path + ".bin")
                               .metadata.__dict__.keys())
