"""Epsilon-shaped training (the benchmark's ``epsilon`` configuration,
400,000 x 2,000 dense rows, binary) at a small size on the CPU: the
port's normal path held to the benchmark's plain reference under the
cell's limits, the rows' generator, the ``grow.hist_store`` range, and
the host binning that wide dense data needed made fast (bins found and
rows binned on threads, dense features not binned again for EFB) with
the same bytes as the one-column-at-a-time loops."""
import json
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import lightgbm_tpu_torch as lt
from gbdt_bench.data import epsilon_like
from gbdt_bench.reference import check, model_text
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.io import bundling
from lightgbm_tpu_torch.io import dataset as dataset_mod
from lightgbm_tpu_torch.io.binning import BinMapper
from lightgbm_tpu_torch.io.dataset import BinnedDataset

ROOT = Path(__file__).resolve().parent.parent
CONFIG = json.loads((ROOT / "gbdt_bench/configs/epsilon.json").read_text())
LIMITS = json.loads(
    (ROOT / "gbdt_bench/limits/epsilon.train.json").read_text())
SEED = 2**31 + 4242
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _one_cpu_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _rows(rows, seed=SEED, **over):
    return epsilon_like.make(dict(CONFIG["data"], rows=rows, **over), seed,
                             CPU)


def test_rows_are_seeded_unit_length_and_balanced():
    a, b = _rows(2000), _rows(2000)
    c = _rows(2000, seed=SEED + 1)
    X = a["X"]
    assert X.dtype == np.float32 and X.shape == (2000, 2000)
    np.testing.assert_array_equal(X, b["X"])
    np.testing.assert_array_equal(a["label"], b["label"])
    assert not np.array_equal(X, c["X"])
    np.testing.assert_allclose(np.linalg.norm(X, axis=1), 1.0, atol=1e-5)
    assert a["group"] is None
    assert set(np.unique(a["label"])) == {0.0, 1.0}
    assert 0.45 < a["label"].mean() < 0.55


def test_small_epsilon_job_within_the_cells_limits():
    """3,000 x 2,000 with 15 bins and 15 leaves (a hessian floor of 10,
    so that 3,000 rows fill them) through ``Dataset``, ``Booster`` and
    ``update()``; every number the cell compares lies within its
    limit."""
    data = _rows(3000)
    X, y = data["X"], data["label"]
    params = {**CONFIG["params"], "max_bin": 15, "num_leaves": 15,
              "min_sum_hessian_in_leaf": 10}
    ds = lt.Dataset(X, label=y, params=params).construct()
    bounds = [np.asarray(m.bin_upper_bound, np.float64)
              for m in ds._handle.bin_mappers]
    bst = lt.Booster(params, ds, device="cpu")
    iters = 4
    for _ in range(iters):
        bst.update()
    score = bst._gbdt._train_score.detach().cpu().clone()
    trees = model_text.parse_trees(bst.model_to_string())
    assert all(t["num_leaves"] == 15 for t in trees)
    numbers = check.compare(trees, iters, torch.as_tensor(X),
                            torch.as_tensor(y).double(), None, params,
                            [0, 1, 2], score, bounds, window_tree=iters - 1)
    assert set(LIMITS) <= set(numbers)
    for key, limit in LIMITS.items():
        assert numbers[key] <= limit, (key, numbers[key], limit)


def _ranges(prof):
    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events() if e.name.startswith("lgbm/")]


@pytest.mark.parametrize("extra", [{}, {"tpu_hist_dtype": "int16"},
                                   {"tpu_fused_sibling": False}],
                         ids=["fused", "int16", "unfused"])
def test_hist_store_opens_inside_every_storing_hist(extra):
    """Each wave's second ``grow.hist`` (K1 and the stores) holds one
    ``grow.hist_store``; with the fused sibling the first (the parents
    gathered into K1's layout) holds one too.  The stores' two index
    copies are the only waits inside one."""
    rng = np.random.default_rng(7)
    X = rng.normal(size=(800, 6))
    y = (X[:, 0] + X[:, 1] * X[:, 2] > 0).astype(np.float64)
    params = {"objective": "binary", "num_leaves": 15, "verbose": -1,
              "min_data_in_leaf": 5, **extra}
    bst = lt.Booster(params, lt.Dataset(X, label=y), device="cpu")
    bst.update()
    gb = bst._gbdt
    trees0 = len(gb.wave_stats)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            bst.update()
    waves = sum(w for w, _ in gb.wave_stats[trees0:])
    rs = _ranges(prof)
    hist = sorted(r for r in rs if r[0] == "lgbm/grow.hist")
    store = [r for r in rs if r[0] == "lgbm/grow.hist_store"]
    assert len(hist) == 2 * waves and waves > 2

    def held(r, outer):
        return [o for o in outer if o[1] <= r[1] and r[2] <= o[2]]
    assert all(len(held(r, hist)) == 1 for r in store)
    per_hist = [sum(1 for s in store if h[1] <= s[1] and s[2] <= h[2])
                for h in hist]
    fused = extra.get("tpu_fused_sibling", True)
    assert per_hist == [1 if fused else 0, 1] * waves
    waits = [r for r in rs if r[0] == "lgbm/wait"]
    per_store = [sum(1 for w in waits if held(w, [s]))
                 for s in sorted(store)]
    assert per_store == ([0, 2] if fused else [2]) * waves


def _serial_mappers(sample, n, config):
    """The bin mappers of one unsorted column at a time."""
    out = []
    for j in range(sample.shape[1]):
        col = sample[:, j]
        m = BinMapper()
        m.find_bin(col[~((col > -1e-35) & (col <= 1e-35))], sample.shape[0],
                   config.max_bin, config.min_data_in_bin,
                   int(config.min_data_in_leaf * sample.shape[0] / n),
                   config.use_missing, config.zero_as_missing)
        out.append(m)
    return out


def test_threaded_binning_gives_the_serial_bytes(monkeypatch):
    """Bins found on threads from sorted columns, and rows binned in row
    chunks on threads, equal the serial per-column loops' mappers and
    ``X_bin`` (the threads' floor lowered so that these rows take them,
    more threads than the chunks need)."""
    rng = np.random.default_rng(3)
    n = 5000
    X = rng.normal(size=(n, 12)).astype(np.float32)
    X[rng.random(X.shape) < 0.02] = np.nan
    X[:, 3] = np.round(X[:, 3] * 2)            # few distinct values
    monkeypatch.setattr(dataset_mod, "THREAD_MIN_ROWS", 777)
    monkeypatch.setattr(dataset_mod, "_workers", lambda: 5)
    cfg = Config.from_params({"max_bin": 63, "verbose": -1})
    ds = BinnedDataset.from_matrix(X, cfg)
    want = _serial_mappers(X, n, cfg)
    for m, w in zip(ds.bin_mappers, want):
        np.testing.assert_array_equal(m.bin_upper_bound, w.bin_upper_bound)
        assert (m.default_bin, m.missing_type, m.sparse_rate) == \
            (w.default_bin, w.missing_type, w.sparse_rate)
    used = ds.real_feature_idx
    serial = np.stack([ds.bin_mappers[int(j)].value_to_bin(X[:, int(j)])
                       for j in used], 1)
    np.testing.assert_array_equal(ds.X_bin, serial.astype(ds.X_bin.dtype))


def test_bundles_skip_no_candidate():
    """EFB's grouping with the dense features' rows left unbinned equals
    the grouping over every feature's non-default rows: sparse features
    bundle, dense ones (NaNs in one) stay alone."""
    rng = np.random.default_rng(11)
    n = 4000
    dense = rng.normal(size=(n, 4))
    dense[rng.random(n) < 0.05, 1] = np.nan
    sparse = np.zeros((n, 6))
    for j in range(6):                      # exclusive: one per row block
        rows = np.arange(j * 600, j * 600 + 400)
        sparse[rows, j] = rng.normal(size=len(rows))
    X = np.concatenate([dense, sparse], 1)
    cfg = Config.from_params({"max_bin": 15, "verbose": -1})
    ds = BinnedDataset.from_matrix(X, cfg)
    assert ds.bundle is not None
    mappers, used = ds.bin_mappers, ds.real_feature_idx
    idxs = [np.flatnonzero(mappers[int(j)].value_to_bin(X[:, int(j)])
                           != mappers[int(j)].default_bin) for j in used]
    rates = [1.0 - len(i) / n for i in idxs]
    groups = bundling.find_groups(idxs, [mappers[int(j)].num_bin
                                         for j in used], rates, n,
                                  cfg.max_conflict_rate)
    assert ds.bundle.groups == groups
    assert sum(len(g) > 1 for g in groups) >= 1


def test_device_bins_are_the_feature_major_bins():
    """The wave grower's bins, transposed by torch, are the binned
    matrix's columns byte for byte."""
    rng = np.random.default_rng(5)
    X = rng.normal(size=(700, 9))
    y = (X[:, 0] > 0).astype(np.float64)
    bst = lt.Booster({"objective": "binary", "verbose": -1},
                     lt.Dataset(X, label=y), device="cpu")
    fm = bst._gbdt._bins_fm
    assert fm.is_contiguous() and fm.dtype == torch.uint8
    np.testing.assert_array_equal(fm.numpy(), bst._gbdt.train_ds.X_bin.T)
