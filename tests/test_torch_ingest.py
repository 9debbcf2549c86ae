"""Streaming ingestion in the port (lightgbm_tpu_torch/ingest/) against the
JAX package's (lightgbm_tpu/ingest/) and against the port's in-memory
loaders, on the CPU: the twins of tests/test_ingest_stream.py and of the
two_round cases of tests/test_ingest.py on LibSVM input.

Held exactly: the reservoir's rows (the same draw from the same seed, at
any chunk size), the shard plans, the bin matrices, the mappers, the
metadata and ``dataset_digest``.  Trained models: a streamed dataset's
trees are byte-equal to the in-memory dataset's in the port; against the
JAX package (its wave grower through the Pallas interpreter,
``LGBM_TPU_FORCE_WAVE=interpret``) the trees are equal in structure, each
leaf value within 5e-5 of its tree's largest |leaf value| and the
predictions within rtol 1e-5 / atol 1e-5 (the budget of
tests/test_torch_train_objectives.py: the packages sum f32 histograms in
other orders).  The fixtures have no near-tied split (ROADMAP fault 3.3)
but one: a NaN feature's default direction in a leaf without NaN rows is
a tie, which ``assert_models_close(nan_ties=True)`` leaves out.
"""
import os
import tracemalloc

import numpy as np
import pytest

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.ingest import (ArraySource, IngestError, NpzSource,
                                       ReservoirSampler, SyntheticSource,
                                       dataset_digest, dataset_from_stream,
                                       ingest_dataset, merge_shard_samples,
                                       plan_row_shards)
from lightgbm_tpu_torch.io.dataset import BinnedDataset

jax = pytest.importorskip("jax")
import lightgbm_tpu as lgb                                  # noqa: E402
from lightgbm_tpu import ingest as J                        # noqa: E402
from lightgbm_tpu.config import Config as JConfig           # noqa: E402

TREE_TOL = 5e-5
PRED_TOL = 1e-5


@pytest.fixture(autouse=True)
def _one_cpu_thread():
    """One intra-op thread a test: a parallel test run shares the machine
    among its workers.  Restored after each test."""
    import torch
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def jax_wave(monkeypatch):
    """The JAX package's training through its wave grower (the Pallas
    interpreter), the port's grower on the CPU."""
    monkeypatch.setenv("LGBM_TPU_FORCE_WAVE", "interpret")


def assert_mappers_equal(a_list, b_list):
    """Field-wise mapper equality (NaN bounds compare equal)."""
    assert len(a_list) == len(b_list)
    for a, b in zip(a_list, b_list):
        da, db = a.to_dict(), b.to_dict()
        assert set(da) == set(db)
        for k in da:
            if k == "bin_upper_bound":
                np.testing.assert_array_equal(np.asarray(da[k]),
                                              np.asarray(db[k]))
            else:
                assert da[k] == db[k], (k, da[k], db[k])


def assert_datasets_equal(ds, oracle):
    assert ds.num_data == oracle.num_data
    np.testing.assert_array_equal(np.asarray(ds.X_bin),
                                  np.asarray(oracle.X_bin))
    np.testing.assert_array_equal(ds.bin_offsets, oracle.bin_offsets)
    np.testing.assert_array_equal(ds.used_feature_map,
                                  oracle.used_feature_map)
    np.testing.assert_array_equal(ds.real_feature_idx,
                                  oracle.real_feature_idx)
    assert_mappers_equal(ds.bin_mappers, oracle.bin_mappers)
    assert (ds.bundle is None) == (oracle.bundle is None)
    if ds.bundle is not None:
        assert [list(g) for g in ds.bundle.groups] == \
            [list(g) for g in oracle.bundle.groups]
        np.testing.assert_array_equal(ds.bundle.feat_offset,
                                      oracle.bundle.feat_offset)


def assert_metadata_equal(md, jmd):
    for name in ("label", "weights", "query_boundaries"):
        a, b = getattr(md, name), getattr(jmd, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype, name


def assert_same_as_jax(ds, jds):
    """The port's ingested dataset is the JAX package's, digest too."""
    assert_datasets_equal(ds, jds)
    assert_metadata_equal(ds.metadata, jds.metadata)
    assert dataset_digest(ds) == J.dataset_digest(jds)


def assert_models_close(port, ref, X, nan_ties=False):
    """Trees equal in structure, leaves and predictions within the file's
    budget (module docstring).  ``nan_ties``: the fixture has NaNs, and a
    split on a NaN feature in a leaf with no NaN rows sends them either
    way with the same gain (ROADMAP fault 3.3), so ``decision_type``'s
    default-left bit is left out; the partitions are the same."""
    pts, rts = port._gbdt.models, ref._gbdt.models
    assert len(pts) == len(rts)
    names = ("split_feature", "threshold", "left_child", "right_child") + \
        (() if nan_ties else ("decision_type",))
    for pt, rt in zip(pts, rts):
        assert pt.num_leaves == rt.num_leaves
        nn = rt.num_leaves - 1
        for name in names:
            np.testing.assert_array_equal(getattr(pt, name),
                                          getattr(rt, name)[:nn])
        want = rt.leaf_value[:rt.num_leaves]
        np.testing.assert_allclose(pt.leaf_value, want, rtol=0,
                                   atol=TREE_TOL * np.abs(want).max())
    np.testing.assert_allclose(port.predict(X), ref.predict(X),
                               rtol=PRED_TOL, atol=PRED_TOL)


def _both(params):
    return (Config.from_params({"verbose": -1, **params}),
            JConfig.from_params({"verbose": -1, **params}))


def _problem(n=2500, f=6, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f))
    X[rng.random(n) < 0.06, 0] = np.nan          # missing
    X[:, 3] = rng.integers(0, 9, n)              # categorical candidate
    y = (np.nan_to_num(X[:, 0]) + 0.5 * X[:, 1] > 0).astype(np.float64)
    return X, y


def _trees(bst):
    return bst.model_to_string(num_iteration=-1).split("\nparameters:")[0]


# ---------------------------------------------------------------------------
# the streamed dataset against the in-memory one and the JAX package's
# ---------------------------------------------------------------------------

def test_stream_matches_from_matrix_dense_nan_categorical():
    X, y = _problem()
    w = np.linspace(0.5, 2.0, len(y))
    cfg, jcfg = _both({"max_bin": 63})
    ds = ingest_dataset(ArraySource(X, label=y, weight=w, chunk_rows=257),
                        cfg, categorical_features=[3])
    oracle = BinnedDataset.from_matrix(X, cfg, categorical_features=[3])
    assert_datasets_equal(ds, oracle)
    np.testing.assert_array_equal(ds.metadata.label, y.astype(np.float32))
    np.testing.assert_array_equal(ds.metadata.weights, w.astype(np.float32))
    jds = J.ingest_dataset(J.ArraySource(X, label=y, weight=w,
                                         chunk_rows=257),
                           jcfg, categorical_features=[3])
    assert_same_as_jax(ds, jds)


def test_stream_subsample_matches_oracle_given_same_sample():
    """Below the row count the reservoir draws the JAX package's rows;
    the streamed dataset is ``from_sample`` of those rows, binned."""
    X, y = _problem()
    cfg, jcfg = _both({"max_bin": 31, "bin_construct_sample_cnt": 400})
    s, js = (ReservoirSampler(400, seed=cfg.data_random_seed),
             J.ReservoirSampler(400, seed=jcfg.data_random_seed))
    for lo in range(0, len(X), 257):
        s.add(X[lo:lo + 257])
        js.add(X[lo:lo + 257])
    sample, idx = s.finish()
    jsample, jidx = js.finish()
    np.testing.assert_array_equal(idx, jidx)
    np.testing.assert_array_equal(sample, jsample)
    ds = ingest_dataset(ArraySource(X, label=y, chunk_rows=257), cfg,
                        categorical_features=[3])
    oracle = BinnedDataset.from_sample(X[idx], len(X), cfg, [3])
    oracle._binarize(X)
    assert_datasets_equal(ds, oracle)
    jds = J.ingest_dataset(J.ArraySource(X, label=y, chunk_rows=257), jcfg,
                           categorical_features=[3])
    assert_same_as_jax(ds, jds)


def test_stream_chunk_size_never_changes_the_dataset():
    X, y = _problem(n=1700)
    cfg, jcfg = _both({"max_bin": 31, "bin_construct_sample_cnt": 300})
    builds = [ingest_dataset(ArraySource(X, label=y, chunk_rows=c), cfg)
              for c in (64, 999, 1700)]
    for b in builds[1:]:
        np.testing.assert_array_equal(builds[0].X_bin, b.X_bin)
        assert_mappers_equal(builds[0].bin_mappers, b.bin_mappers)
        assert dataset_digest(builds[0]) == dataset_digest(b)
    jds = J.ingest_dataset(J.ArraySource(X, label=y, chunk_rows=64), jcfg)
    assert dataset_digest(builds[1]) == J.dataset_digest(jds)


def test_stream_bundled_matches_oracle():
    rng = np.random.default_rng(3)
    n, f = 2000, 12
    X = np.zeros((n, f))
    X[:, 0] = rng.normal(size=n)                 # dense
    block = n // (f + 2)
    for j in range(1, f):                        # strictly exclusive
        rows = np.arange((j - 1) * block, j * block)
        X[rows, j] = rng.normal(size=len(rows)) + j + 2.0
    y = (X[:, 0] > 0).astype(np.float64)
    cfg, jcfg = _both({"max_bin": 63})
    oracle = BinnedDataset.from_matrix(X, cfg)
    assert oracle.bundle is not None, "fixture failed to trigger EFB"
    ds = ingest_dataset(ArraySource(X, label=y, chunk_rows=333), cfg)
    assert_datasets_equal(ds, oracle)
    jds = J.ingest_dataset(J.ArraySource(X, label=y, chunk_rows=333), jcfg)
    assert_same_as_jax(ds, jds)


def test_stream_trained_model_bit_identical(jax_wave):
    """A streamed dataset trains the in-memory dataset's trees, byte for
    byte, in the port; the JAX package's streamed model within budget."""
    X, y = _problem(n=1200)
    P = {"objective": "binary", "num_leaves": 7, "min_data_in_leaf": 5,
         "verbose": -1, "max_bin": 63}
    b1 = lt.train(P, dataset_from_stream(
        ArraySource(X, label=y, chunk_rows=311), P,
        categorical_features=[3]), 5, device="cpu")
    b2 = lt.train(P, lt.Dataset(X, label=y, params=P,
                                categorical_feature=[3]), 5, device="cpu")
    assert _trees(b1) == _trees(b2)
    ref = lgb.train(P, J.dataset_from_stream(
        J.ArraySource(X, label=y, chunk_rows=311), P,
        categorical_features=[3]), num_boost_round=5, verbose_eval=False)
    assert_models_close(b1, ref, X, nan_ties=True)


def test_stream_reference_alignment_valid_set():
    X, y = _problem()
    Xv, yv = _problem(n=700, seed=9)
    cfg, jcfg = _both({"max_bin": 63})
    train = ingest_dataset(ArraySource(X, label=y, chunk_rows=400), cfg)
    valid = ingest_dataset(ArraySource(Xv, label=yv, chunk_rows=123), cfg,
                           reference=train)
    assert valid.bin_mappers is train.bin_mappers
    np.testing.assert_array_equal(
        valid.X_bin, BinnedDataset.from_matrix(Xv, cfg,
                                               reference=train).X_bin)
    jtrain = J.ingest_dataset(J.ArraySource(X, label=y, chunk_rows=400),
                              jcfg)
    jvalid = J.ingest_dataset(J.ArraySource(Xv, label=yv, chunk_rows=123),
                              jcfg, reference=jtrain)
    assert_same_as_jax(valid, jvalid)


# ---------------------------------------------------------------------------
# the reservoir: uniform over the whole stream
# ---------------------------------------------------------------------------

def test_reservoir_sample_covers_shifted_tail():
    """The sample is drawn from all N rows, not the stream's head: a tail
    shifted by +8 shows in the sample at about its share and gets bin
    bounds; the draw is the JAX package's."""
    n, k = 30000, 600
    cfg, jcfg = _both({"max_bin": 63, "bin_construct_sample_cnt": k})
    s = ReservoirSampler(k, seed=cfg.data_random_seed)
    for Xc, _ in SyntheticSource(n, n_features=4, chunk_rows=1024, seed=5,
                                 tail_shift=8.0):
        s.add(Xc)
    _, idx = s.finish()
    js = J.ReservoirSampler(k, seed=jcfg.data_random_seed)
    for Xc, _ in J.SyntheticSource(n, n_features=4, chunk_rows=1024, seed=5,
                                   tail_shift=8.0):
        js.add(Xc)
    np.testing.assert_array_equal(idx, js.finish()[1])
    assert len(idx) == k
    frac_tail = float((idx >= int(0.9 * n)).mean())
    assert 0.04 < frac_tail < 0.18, frac_tail
    assert idx.max() > 0.95 * n and idx.min() < 0.05 * n
    ds = ingest_dataset(SyntheticSource(n, n_features=4, chunk_rows=1024,
                                        seed=5, tail_shift=8.0), cfg)
    ub = np.asarray(ds.bin_mappers[0].bin_upper_bound)
    assert float(ub[np.isfinite(ub)].max()) > 4.5


def test_reservoir_matches_oracle_on_short_stream():
    X = np.arange(50, dtype=np.float64).reshape(25, 2)
    s = ReservoirSampler(100, seed=0)
    for lo in range(0, 25, 7):
        s.add(X[lo:lo + 7])
    sample, idx = s.finish()
    np.testing.assert_array_equal(sample, X)
    np.testing.assert_array_equal(idx, np.arange(25))


def test_merge_shard_samples_is_rank_ordered_concat():
    a = np.full((3, 2), 1.0)
    b = np.full((2, 2), 2.0)
    pooled, total = merge_shard_samples([a, b], [300, 200])
    np.testing.assert_array_equal(pooled, np.concatenate([a, b]))
    assert total == 500
    jpooled, jtotal = J.merge_shard_samples([a, b], [300, 200])
    np.testing.assert_array_equal(pooled, jpooled)
    assert total == jtotal


# ---------------------------------------------------------------------------
# shard plans
# ---------------------------------------------------------------------------

def test_two_shard_ingest_concatenates_to_oracle():
    X, y = _problem(n=2100)
    cfg, jcfg = _both({"max_bin": 63})
    oracle = BinnedDataset.from_matrix(X, cfg, categorical_features=[3])
    parts = []
    for sid in range(2):
        d = ingest_dataset(ArraySource(X, label=y, chunk_rows=400), cfg,
                           categorical_features=[3], num_shards=2,
                           shard_id=sid)
        assert_mappers_equal(d.bin_mappers, oracle.bin_mappers)
        assert d.num_data < oracle.num_data
        jd = J.ingest_dataset(J.ArraySource(X, label=y, chunk_rows=400),
                              jcfg, categorical_features=[3], num_shards=2,
                              shard_id=sid)
        assert_same_as_jax(d, jd)
        assert d.ingest_row_range == jd.ingest_row_range
        parts.append(d)
    np.testing.assert_array_equal(np.vstack([p.X_bin for p in parts]),
                                  oracle.X_bin)
    np.testing.assert_array_equal(
        np.concatenate([p.metadata.label for p in parts]),
        y.astype(np.float32))


def test_presharded_ingest_with_merged_samples_matches_shared():
    """Pre-partitioned ranks: each samples its own rows; pooled in rank
    order, the mappers bin every rank's rows as the pooled sample's
    dataset bins all of them."""
    X, y = _problem(n=1600)
    cfg, _ = _both({"max_bin": 31, "bin_construct_sample_cnt": 200})
    halves = [(X[:800], y[:800]), (X[800:], y[800:])]
    locals_, counts = [], []
    for Xh, _ in halves:
        s = ReservoirSampler(200, seed=cfg.data_random_seed)
        for lo in range(0, len(Xh), 199):
            s.add(Xh[lo:lo + 199])
        locals_.append(s.finish()[0])
        counts.append(len(Xh))
    pooled, total = merge_shard_samples(locals_, counts)
    assert total == len(X)
    ref = BinnedDataset.from_sample(pooled, total, cfg)
    ref._binarize(X)
    parts = [ingest_dataset(ArraySource(Xh, label=yh, chunk_rows=199), cfg,
                            reference=ref) for Xh, yh in halves]
    np.testing.assert_array_equal(np.vstack([p.X_bin for p in parts]),
                                  ref.X_bin)


def _ranking_problem(nq=60, seed=2):
    rng = np.random.default_rng(seed)
    sizes = rng.integers(4, 20, nq)
    n = int(sizes.sum())
    X = rng.normal(size=(n, 5))
    y = rng.integers(0, 3, n).astype(np.float64)
    qid = np.repeat(np.arange(nq), sizes)
    return X, y, sizes, qid, n


def test_query_aligned_shards_never_straddle():
    X, y, sizes, qid, n = _ranking_problem()
    boundaries = np.concatenate([[0], np.cumsum(sizes)])
    plan = plan_row_shards(n, 3, boundaries)
    jplan = J.plan_row_shards(n, 3, boundaries)
    np.testing.assert_array_equal(plan.cuts, jplan.cuts)
    np.testing.assert_array_equal(plan.query_cuts, jplan.query_cuts)
    assert plan.query_aligned
    assert int(plan.cuts[0]) == 0 and int(plan.cuts[-1]) == n
    for d in range(3):
        lo, hi = plan.shard_range(d)
        assert lo in boundaries and hi in boundaries
        inside = qid[lo:hi]
        for q in np.unique(inside):
            assert (qid == q).sum() == (inside == q).sum()


def test_ranking_stream_shards_and_trains(jax_wave):
    X, y, sizes, qid, n = _ranking_problem()
    P = {"objective": "lambdarank", "num_leaves": 7,
         "min_data_in_leaf": 5, "verbose": -1, "max_bin": 63}
    cfg, jcfg = _both(P)
    ds = ingest_dataset(ArraySource(X, label=y, group=sizes,
                                    chunk_rows=123), cfg)
    np.testing.assert_array_equal(
        ds.metadata.query_boundaries,
        np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32))
    jds = J.ingest_dataset(J.ArraySource(X, label=y, group=sizes,
                                         chunk_rows=123), jcfg)
    assert_same_as_jax(ds, jds)
    b1 = lt.train(P, dataset_from_stream(
        ArraySource(X, label=y, group=sizes, chunk_rows=123), P), 4,
        device="cpu")
    b2 = lt.train(P, lt.Dataset(X, label=y, group=sizes, params=P), 4,
                  device="cpu")
    assert _trees(b1) == _trees(b2)
    parts = [ingest_dataset(ArraySource(X, label=y, group=sizes,
                                        chunk_rows=123), cfg,
                            num_shards=2, shard_id=sid) for sid in range(2)]
    got = np.concatenate([np.diff(p.metadata.query_boundaries)
                          for p in parts])
    np.testing.assert_array_equal(got, sizes)
    assert sum(p.num_data for p in parts) == n


# ---------------------------------------------------------------------------
# bounded memory, memmap, serialization, resume
# ---------------------------------------------------------------------------

def test_bounded_memory_never_materializes_raw_matrix():
    """A stream of 20+ chunks ingests in O(chunk + sample + bin matrix)
    host memory, far below the raw [N, F] f64 bytes."""
    import gc
    n, f, chunk = 200_000, 12, 4096
    assert n >= 20 * chunk

    class FeatureStream:
        group_sizes = None

        def __iter__(self):
            for Xc, _ in SyntheticSource(n, n_features=f,
                                         chunk_rows=chunk, seed=1):
                yield Xc, {}

    cfg, _ = _both({"max_bin": 63, "bin_construct_sample_cnt": 5000})
    gc.collect()
    tracemalloc.start()
    tracemalloc.reset_peak()
    base = tracemalloc.get_traced_memory()[0]
    ds = ingest_dataset(FeatureStream(), cfg)
    peak = tracemalloc.get_traced_memory()[1] - base
    tracemalloc.stop()
    raw = n * f * 8
    assert ds.num_data == n
    budget = (ds.X_bin.nbytes + 8 * chunk * f * 8 + 4 * 5000 * f * 8
              + (2 << 20))
    assert peak < budget, (peak, budget)
    assert peak < raw // 2, (peak, raw)


def test_memmap_backed_ingest_save_load_roundtrip(tmp_path):
    from lightgbm_tpu_torch.io.dataset_io import load_dataset, save_dataset
    X, y = _problem(n=900)
    w = np.linspace(1, 2, len(y))
    cfg, jcfg = _both({"max_bin": 63})
    mm_path = str(tmp_path / "X_bin.npy")
    ds = ingest_dataset(ArraySource(X, label=y, weight=w, chunk_rows=200),
                        cfg, categorical_features=[3], memmap_path=mm_path)
    assert isinstance(ds.X_bin, np.memmap)
    assert os.path.exists(mm_path)
    oracle = BinnedDataset.from_matrix(X, cfg, categorical_features=[3])
    np.testing.assert_array_equal(np.asarray(ds.X_bin), oracle.X_bin)
    out = str(tmp_path / "ds.npz")
    save_dataset(ds, out)
    back = load_dataset(out)
    assert_datasets_equal(back, oracle)
    np.testing.assert_array_equal(back.metadata.weights,
                                  w.astype(np.float32))
    assert dataset_digest(back) == dataset_digest(ds)
    jds = J.ingest_dataset(J.ArraySource(X, label=y, weight=w,
                                         chunk_rows=200),
                           jcfg, categorical_features=[3])
    assert dataset_digest(ds) == J.dataset_digest(jds)
    # a directory target: a per-shard file inside it, and a second ingest
    # to the same target never truncates the first one's live file
    d2 = ingest_dataset(ArraySource(X, label=y, chunk_rows=200), cfg,
                        memmap_path=str(tmp_path))
    assert isinstance(d2.X_bin, np.memmap)
    assert (tmp_path / "X_bin.shard0.npy").exists()
    d2_bins = np.asarray(d2.X_bin).copy()
    d3 = ingest_dataset(ArraySource(X, label=y, chunk_rows=200), cfg,
                        memmap_path=str(tmp_path))
    assert d3.X_bin.filename != d2.X_bin.filename
    np.testing.assert_array_equal(np.asarray(d2.X_bin), d2_bins)


def test_memmap_dataset_trains_and_uploads_in_blocks(monkeypatch, tmp_path):
    """A memmap-backed dataset trains the in-RAM dataset's trees; the
    row-major upload fills the device tensor block by block (a uint16
    matrix included) with the bytes of ``astype(int32)``."""
    from lightgbm_tpu_torch.boosting.gbdt import GBDT
    X, y = _problem(n=900)
    P = {"objective": "binary", "num_leaves": 7, "min_data_in_leaf": 5,
         "verbose": -1, "max_bin": 63}
    mm = dataset_from_stream(ArraySource(X, label=y, chunk_rows=200), P,
                             memmap_path=str(tmp_path / "bins.npy"))
    assert isinstance(mm._handle.X_bin, np.memmap)
    a = lt.train(P, mm, 3, device="cpu")
    b = lt.train(P, lt.Dataset(X, label=y, params=P), 3, device="cpu")
    assert _trees(a) == _trees(b)
    monkeypatch.setattr(GBDT, "_UPLOAD_ROWS", 97)
    g = GBDT.__new__(GBDT)
    g.device = "cpu"
    wide = np.lib.format.open_memmap(str(tmp_path / "u16.npy"), mode="w+",
                                     dtype=np.uint16, shape=(500, 3))
    wide[:] = np.random.default_rng(0).integers(0, 1000, (500, 3))
    wide.flush()
    ro = np.lib.format.open_memmap(str(tmp_path / "u16.npy"), mode="r")
    got = g._device_phys_bins(ro)
    assert str(got.dtype) == "torch.int32"
    np.testing.assert_array_equal(got.numpy(), np.asarray(ro, np.int32))
    narrow = g._device_phys_bins(np.asarray(mm._handle.X_bin))
    assert str(narrow.dtype) == "torch.uint8"
    np.testing.assert_array_equal(narrow.numpy(), mm._handle.X_bin)


def test_crash_mid_ingest_resume_bit_exact(tmp_path):
    """A crash mid-training of an ingested dataset resumes to the
    uninterrupted model: the re-stream has the same digest, and the
    ingest knobs may change between the runs (they are outside the
    checkpoint's config digest)."""
    from lightgbm_tpu_torch.robust import DeviceWedgedError, faults
    X, y = _problem(n=900)
    P = {"objective": "binary", "num_leaves": 7, "min_data_in_leaf": 5,
         "verbose": -1, "max_bin": 63, "bagging_fraction": 0.8,
         "bagging_freq": 2}

    def make_ds(chunk):
        return dataset_from_stream(ArraySource(X, label=y, chunk_rows=chunk),
                                   dict(P, tpu_ingest_chunk_rows=chunk))

    d1 = ingest_dataset(ArraySource(X, label=y, chunk_rows=200),
                        Config.from_params(P))
    d2 = ingest_dataset(ArraySource(X, label=y, chunk_rows=200),
                        Config.from_params(P))
    assert dataset_digest(d1) == dataset_digest(d2)
    ref = _trees(lt.train(P, make_ds(200), 6, device="cpu"))
    ck = str(tmp_path / "ckpt")
    crash_p = dict(P, tpu_on_device_error="abort", tpu_checkpoint_dir=ck,
                   tpu_checkpoint_freq=2)
    faults.configure("device_execute:raise@iter=4")
    try:
        with pytest.raises(DeviceWedgedError):
            lt.train(crash_p, make_ds(200), 6, device="cpu")
    finally:
        faults.disarm()
    resumed = _trees(lt.train(dict(crash_p, tpu_ingest_chunk_rows=333),
                              make_ds(333), 6, device="cpu"))
    assert resumed == ref


# ---------------------------------------------------------------------------
# readers, the CLI, the config surface
# ---------------------------------------------------------------------------

def test_npy_source_streams_with_sidecars(tmp_path):
    X, y = _problem(n=600)
    p = str(tmp_path / "data.npy")
    np.save(p, X)
    np.save(str(tmp_path / "data.y.npy"), y)
    np.save(str(tmp_path / "data.weight.npy"), np.linspace(1, 2, 600))
    cfg, jcfg = _both({"max_bin": 31, "tpu_ingest_chunk_rows": 128})
    ds = ingest_dataset(NpzSource(p, chunk_rows=128), cfg)
    oracle = BinnedDataset.from_matrix(X, cfg)
    np.testing.assert_array_equal(ds.X_bin, oracle.X_bin)
    np.testing.assert_array_equal(ds.metadata.label, y.astype(np.float32))
    assert_same_as_jax(ds, J.ingest_dataset(J.NpzSource(p, chunk_rows=128),
                                            jcfg))


def _svm_file(path, n_queries=30, seed=4, trailing_newline=True):
    rng = np.random.default_rng(seed)
    lines = []
    for q in range(n_queries):
        for _ in range(int(rng.integers(4, 12))):
            rel = int(rng.integers(0, 3))
            feats = " ".join(f"{j}:{rng.normal() + rel:.3f}" for j in
                             sorted(rng.choice(25, size=8, replace=False)))
            lines.append(f"{rel} qid:{q} {feats}")
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + ("\n" if trailing_newline else ""))
    return len(lines)


def test_libsvm_two_round_streams_bit_identical(tmp_path):
    """two_round LibSVM streams through ingest/: the from_csr dataset and
    the JAX package's, qids as query boundaries, with the native parser
    and with the Python one."""
    import lightgbm_tpu_torch.native as native
    from lightgbm_tpu.io.text_loader import \
        load_text_two_round as jax_two_round
    from lightgbm_tpu_torch.io.text_loader import (_load_libsvm,
                                                   load_text_two_round)
    p = str(tmp_path / "rank.svm")
    _svm_file(p)
    cfg, jcfg = _both({"max_bin": 63, "two_round": True})
    h, label, weight, group, names = load_text_two_round(p, cfg)
    Xo, lo, _, go, _ = _load_libsvm(p)
    assert_datasets_equal(h, BinnedDataset.from_csr(Xo, cfg))
    np.testing.assert_array_equal(label, lo)
    np.testing.assert_array_equal(group, go)
    jh, jlabel, _, jgroup, jnames = jax_two_round(p, jcfg)
    assert_same_as_jax(h, jh)
    np.testing.assert_array_equal(group, jgroup)
    assert names == jnames
    old = native._lib, native._tried
    native._lib, native._tried = None, True
    try:
        h2, label2, _, group2, _ = load_text_two_round(p, cfg)
    finally:
        native._lib, native._tried = old
    np.testing.assert_array_equal(h2.X_bin, h.X_bin)
    np.testing.assert_array_equal(label2, label)
    np.testing.assert_array_equal(group2, group)


def test_two_round_matches_in_memory(tmp_path):
    """LibSVM two_round with a ``.weight`` sidecar: the in-memory dataset
    (labels, weights, query sizes) and, against a reference, its bin
    space reused."""
    from lightgbm_tpu_torch.io.text_loader import (load_text,
                                                   load_text_two_round)
    p = str(tmp_path / "w.svm")
    n = _svm_file(p, seed=7)
    np.savetxt(p + ".weight", np.linspace(0.5, 2.0, n))
    cfg, _ = _both({"max_bin": 63})
    X, label, weight, group, names = load_text(p, cfg)
    h1 = BinnedDataset.from_csr(X, cfg, feature_names=names)
    h2, label2, weight2, group2, names2 = load_text_two_round(p, cfg)
    assert names2 == names
    np.testing.assert_array_equal(label2, label)
    np.testing.assert_array_equal(weight2, weight)
    np.testing.assert_array_equal(group2, group)
    np.testing.assert_array_equal(h2.metadata.weights,
                                  weight.astype(np.float32))
    assert_datasets_equal(h2, h1)
    h3, *_ = load_text_two_round(p, cfg, reference=h1)
    np.testing.assert_array_equal(h3.X_bin, h1.X_bin)
    assert h3.bin_mappers is h1.bin_mappers


def test_two_round_reservoir_subsample(tmp_path):
    """Past ``bin_construct_sample_cnt`` rows the reservoir draws the JAX
    package's sample; every row is binned within its feature's bins."""
    from lightgbm_tpu.io.text_loader import \
        load_text_two_round as jax_two_round
    from lightgbm_tpu_torch.io.text_loader import load_text_two_round
    p = str(tmp_path / "s.svm")
    n = _svm_file(p, n_queries=60, seed=8)
    cfg, jcfg = _both({"max_bin": 31, "bin_construct_sample_cnt": 100})
    h, label, *_ = load_text_two_round(p, cfg)
    assert h.num_data == len(label) == n
    assert int(h.feature_max_bins().max()) <= 32
    nb = h.feature_max_bins()
    for inner in range(h.num_features):
        assert h.X_bin[:, inner].max() < nb[inner]
    assert_same_as_jax(h, jax_two_round(p, jcfg)[0])


def test_two_round_no_trailing_newline(tmp_path):
    from lightgbm_tpu.io.text_loader import \
        load_text_two_round as jax_two_round
    from lightgbm_tpu_torch.io.text_loader import load_text_two_round
    p = str(tmp_path / "nonl.svm")
    n = _svm_file(p, seed=9, trailing_newline=False)
    cfg, jcfg = _both({"max_bin": 31, "bin_construct_sample_cnt": 50})
    h, label, *_ = load_text_two_round(p, cfg)
    assert h.num_data == n
    jh, jlabel, *_ = jax_two_round(p, jcfg)
    np.testing.assert_array_equal(label, jlabel)
    assert_same_as_jax(h, jh)


def _write_csv(path, X, y):
    with open(path, "w") as fh:
        for yi, row in zip(y, X):
            fh.write(",".join(
                "nan" if np.isnan(v) else repr(float(v))
                for v in np.concatenate([[yi], row])) + "\n")


def test_cli_tpu_ingest_trains_identical_model(tmp_path):
    """``task=train tpu_ingest=true`` trains the in-memory load's model
    (the sample holds every row), parameters block aside."""
    from lightgbm_tpu_torch.app import main
    X, y = _problem(n=700)
    p = str(tmp_path / "train.csv")
    _write_csv(p, X, y)
    outs = []
    for i, extra in enumerate(["tpu_ingest=false", "tpu_ingest=true"]):
        out = str(tmp_path / f"m{i}.txt")
        main(["task=train", f"data={p}", "objective=binary", "num_trees=6",
              "num_leaves=7", "verbose=-1", "device_type=cpu",
              f"output_model={out}", extra])
        outs.append(open(out).read())
    strip = [[ln for ln in o.splitlines()
              if not ln.startswith("[") and ln != "end of parameters"]
             for o in outs]
    assert strip[0] == strip[1]


def test_cli_sharded_ingest_cuts_init_scores(tmp_path):
    """A sharded ``tpu_ingest`` load keeps its rows of a whole-stream
    init-score file, class by class."""
    from lightgbm_tpu_torch.app import _dataset_ingest
    X, y = _problem(n=300)
    p = str(tmp_path / "train.csv")
    _write_csv(p, X, y)
    init = np.random.default_rng(1).normal(size=(300, 3))
    np.savetxt(p + ".init", init)
    for sid in range(2):
        params = {"tpu_ingest": True, "tpu_ingest_shards": 2,
                  "tpu_ingest_shard_id": sid, "verbose": -1}
        ds = _dataset_ingest(p, Config.from_params(params), params)
        lo, hi = ds._handle.ingest_row_range
        np.testing.assert_array_equal(ds._handle.metadata.init_score,
                                      init[lo:hi].T.ravel())


def test_sharded_ingest_file_slices_sidecars(tmp_path):
    """Whole-stream ``.weight`` / ``.query`` sidecars are cut to the
    shard, and the cuts lie on the sidecar's query boundaries."""
    from lightgbm_tpu_torch.ingest import ingest_file
    rng = np.random.default_rng(6)
    sizes = rng.integers(4, 16, 40)
    n = int(sizes.sum())
    X = rng.normal(size=(n, 4))
    y = rng.integers(0, 3, n).astype(np.float64)
    w = np.linspace(0.5, 2.0, n)
    p = str(tmp_path / "rank.csv")
    _write_csv(p, X, y)
    np.savetxt(p + ".weight", w)
    np.savetxt(p + ".query", sizes, fmt="%d")
    boundaries = np.concatenate([[0], np.cumsum(sizes)])
    parts = []
    for sid in range(2):
        shard = {"max_bin": 31, "tpu_ingest_shards": 2,
                 "tpu_ingest_shard_id": sid}
        cfg, jcfg = _both(shard)
        h, label, weight, group, _ = ingest_file(p, cfg)
        lo, hi = h.ingest_row_range
        assert h.num_data == hi - lo < n
        np.testing.assert_array_equal(weight, w[lo:hi].astype(np.float32))
        assert lo in boundaries and hi in boundaries
        jh = J.ingest_file(p, jcfg)[0]
        assert_same_as_jax(h, jh)
        parts.append((label, group))
    np.testing.assert_array_equal(np.concatenate([g for _, g in parts]),
                                  sizes)
    np.testing.assert_array_equal(np.concatenate([lb for lb, _ in parts]),
                                  y.astype(np.float32))


def test_ingest_config_validation():
    for bad, match in (({"tpu_ingest_chunk_rows": 0}, "chunk_rows"),
                       ({"tpu_ingest_shards": 2, "tpu_ingest_shard_id": 5},
                        "shard_id"),
                       ({"tpu_ingest_shards": -1}, "tpu_ingest_shards")):
        with pytest.raises(lt.LightGBMError, match=match):
            Config.from_params({**bad, "verbose": -1})
    cfg = Config.from_params({"tpu_ingest": True, "verbose": -1})
    assert cfg.tpu_ingest and cfg.tpu_ingest_chunk_rows == 65536


def test_ingest_knob_overrides(monkeypatch, tmp_path):
    from lightgbm_tpu_torch.ingest import (chunk_rows_from_config,
                                           memmap_from_config)
    cfg = Config.from_params({"tpu_ingest_chunk_rows": 1000,
                              "tpu_ingest_memmap": "cfg.npy"})
    assert chunk_rows_from_config(cfg) == 1000
    assert memmap_from_config(cfg) == "cfg.npy"
    monkeypatch.setenv("LGBM_TPU_INGEST_CHUNK_ROWS", "77")
    monkeypatch.setenv("LGBM_TPU_INGEST_MEMMAP", str(tmp_path / "env.npy"))
    assert chunk_rows_from_config(cfg) == 77
    assert memmap_from_config(cfg) == str(tmp_path / "env.npy")
    monkeypatch.setenv("LGBM_TPU_INGEST_CHUNK_ROWS", "many")
    assert chunk_rows_from_config(cfg) == 1000


def test_ingest_events_validate_and_digest(tmp_path):
    """The port's ``ingest_chunk`` / ``ingest_summary`` events pass the
    JAX package's validator and digest, and the flight ring keeps the
    summary with the dataset digest."""
    import importlib

    from lightgbm_tpu_torch import obs
    report = importlib.import_module("lightgbm_tpu.obs.report")
    X, y = _problem(n=500)
    cfg, _ = _both({"max_bin": 31})
    obs.enable_flight(64)
    obs.enable(str(tmp_path / "telem"))
    try:
        ds = ingest_dataset(ArraySource(X, label=y, chunk_rows=100), cfg)
        summ = [e for e in obs.flight_snapshot()
                if e.get("event") == "ingest_summary"]
        assert summ and summ[-1]["digest"] == dataset_digest(ds)
        obs.disable()
        events = report.load_events(str(tmp_path / "telem"))
        assert not report.validate_events(events)
        ing = [e for e in events if e.get("event") == "ingest_chunk"]
        assert len(ing) == 10          # 5 chunks x 2 passes
        assert {e["pass"] for e in ing} == {1, 2}
        digest = report.summarize(events)
        assert digest["ingest"]["rows_total"] == 500
        assert "ingest:" in report.render(digest)
    finally:
        obs.disable()
        obs.enable_flight(0)
        obs.reset()


def test_ingest_chunk_fault_point_retries_and_aborts():
    """Every fetch passes ``ingest_chunk``: a transient fault retries to
    the same dataset, a fatal one aborts the ingest."""
    from lightgbm_tpu_torch.robust import DeviceWedgedError, faults
    X, y = _problem(n=300)
    cfg, _ = _both({"max_bin": 31})
    want = ingest_dataset(ArraySource(X, label=y, chunk_rows=100), cfg)
    faults.configure("ingest_chunk:transient@call=2")
    try:
        got = ingest_dataset(ArraySource(X, label=y, chunk_rows=100), cfg)
    finally:
        faults.disarm()
    assert dataset_digest(got) == dataset_digest(want)
    faults.configure("ingest_chunk:raise@call=3")
    try:
        with pytest.raises(DeviceWedgedError, match="ingest_chunk"):
            ingest_dataset(ArraySource(X, label=y, chunk_rows=100), cfg)
    finally:
        faults.disarm()


def test_empty_and_inconsistent_streams_abort():
    cfg, _ = _both({})

    class Empty:
        group_sizes = None

        def __iter__(self):
            return iter(())

    with pytest.raises(IngestError, match="no rows"):
        ingest_dataset(Empty(), cfg)

    X, y = _problem(n=300)

    class ShrinkingSource:
        """Pass 2 sees fewer rows than pass 1: the file changed."""
        group_sizes = None

        def __init__(self):
            self.calls = 0

        def __iter__(self):
            self.calls += 1
            stop = 300 if self.calls == 1 else 200
            for lo in range(0, stop, 100):
                yield X[lo:lo + 100], {"label": y[lo:lo + 100]}

    with pytest.raises(IngestError, match="changed between passes"):
        ingest_dataset(ShrinkingSource(), cfg)

    class Drifting:
        group_sizes = None

        def __iter__(self):
            yield X[:100], {}
            yield X[100:200, :4], {}

    with pytest.raises(IngestError, match="columns"):
        ingest_dataset(Drifting(), cfg)


def test_public_names_match_the_jax_package():
    import lightgbm_tpu_torch.ingest as port
    assert sorted(port.__all__) == sorted(J.__all__)
    assert all(hasattr(port, name) for name in port.__all__)
