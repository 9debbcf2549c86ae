"""The port's stacked-forest walk (core/forest.py, serve/packing.py)
against the JAX package's on the same model files: the model-derived bin
space bins rows identically, raw scores agree within 1e-6 with and
without prediction early stop, and leaf indices are equal.  The card
cases hold the walk on the card against the same walk on the CPU."""
import os

import numpy as np
import pytest
import torch

from lightgbm_tpu_torch import Booster
from lightgbm_tpu_torch.core import forest as forest_mod
from lightgbm_tpu_torch.core.forest import (forest_leaf_fn,
                                            forest_predict_fn, stack_forest)
from lightgbm_tpu_torch.serve.packing import ServeBinSpace

FIX = os.path.join(os.path.dirname(__file__), "fixtures")
MODELS = [("ref_plain20_model.txt", "binary_test_rows.npy"),
          ("ref_cat_model.txt", "cat_rows.npy")]
EARLY_STOPS = [None, {"kind": "binary", "round_period": 5,
                      "margin_threshold": 1.5},
               {"kind": "binary", "round_period": 1,
                "margin_threshold": 0.5}]


def _rows(name, n_rep=4, seed=0):
    """The fixture's rows, repeated with jitter, NaNs and (for the
    categorical model) negative and unseen categories."""
    X = np.load(os.path.join(FIX, name))
    if X.shape[1] == 29:
        X = X[:, 1:]
    rng = np.random.default_rng(seed)
    Xs = [X]
    for _ in range(n_rep - 1):
        Xj = X + rng.normal(scale=0.05, size=X.shape)
        Xj[rng.random(X.shape) < 0.03] = np.nan
        Xs.append(Xj)
    X = np.vstack(Xs)
    if name == "cat_rows.npy":
        X[:, 0] = np.round(X[:, 0])
        X[::17, 0] = -3.0
        X[::23, 0] = 77.0
    return X


def _port_forest(name, device="cpu"):
    g = Booster(model_file=os.path.join(FIX, name), device=device)._gbdt
    space = ServeBinSpace(g.models, g.num_features, device)
    forest = stack_forest([space.tree_arrays_np(t) for t in g.models],
                          np.zeros(len(g.models), np.int32), device,
                          min_words=space.min_words)
    return g, space, forest


def _ref_forest(name):
    import lightgbm_tpu as lgb
    from lightgbm_tpu.core.forest import stack_forest as ref_stack
    from lightgbm_tpu.serve.packing import ServeBinSpace as RefSpace
    g = lgb.Booster(model_file=os.path.join(FIX, name))._gbdt
    space = RefSpace(list(g.models), g._model_num_features())
    forest = ref_stack([space.tree_arrays_np(t) for t in g.models],
                       np.zeros(len(g.models), np.int32),
                       min_words=space.min_words)
    return space, forest


@pytest.mark.parametrize("name,rows", MODELS)
def test_bin_space_matches_reference(name, rows):
    pytest.importorskip("jax")
    X = _rows(rows)
    _, space, forest = _port_forest(name)
    ref_space, ref_forest = _ref_forest(name)
    np.testing.assert_array_equal(space.bin_matrix(X),
                                  ref_space.bin_matrix(X))
    assert (space.min_words, space.sentinel) == (ref_space.min_words,
                                                 ref_space.sentinel)
    for key in ("num_bins", "default_bins", "missing_types",
                "is_categorical"):
        np.testing.assert_array_equal(getattr(space.meta, key).numpy(),
                                      np.asarray(getattr(ref_space.meta, key)))
    for key in ("threshold_bin", "default_left", "left_child",
                "right_child", "leaf_value", "num_leaves"):
        np.testing.assert_array_equal(getattr(forest, key).numpy(),
                                      np.asarray(getattr(ref_forest, key)))
    np.testing.assert_array_equal(
        forest.cat_bitset.numpy().view(np.uint32),
        np.asarray(ref_forest.cat_bitset))


@pytest.mark.parametrize("es", range(len(EARLY_STOPS)))
@pytest.mark.parametrize("name,rows", MODELS)
def test_forest_predict_matches_reference(name, rows, es):
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from lightgbm_tpu.core.forest import forest_predict_fn as ref_fn
    early_stop = EARLY_STOPS[es]
    X = _rows(rows)
    _, space, forest = _port_forest(name)
    ref_space, ref_forest = _ref_forest(name)
    bins = space.bin_matrix(X)
    got = forest_predict_fn(space.meta, 1, early_stop)(
        forest, torch.from_numpy(bins)).numpy()
    want = np.asarray(ref_fn(ref_space.meta, 1, early_stop)(
        ref_forest, jnp.asarray(bins)))
    assert got.shape == want.shape == (X.shape[0], 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("name,rows", MODELS)
def test_forest_leaf_matches_reference(name, rows):
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from lightgbm_tpu.core.forest import forest_leaf_fn as ref_fn
    X = _rows(rows)
    g, space, forest = _port_forest(name)
    ref_space, ref_forest = _ref_forest(name)
    bins = space.bin_matrix(X)
    got = forest_leaf_fn(space.meta)(forest, torch.from_numpy(bins)).numpy()
    want = np.asarray(ref_fn(ref_space.meta)(ref_forest, jnp.asarray(bins)))
    np.testing.assert_array_equal(got, want)
    # and the host walk of the value-space trees
    np.testing.assert_array_equal(
        got.T, np.stack([t.predict_leaf(X) for t in g.models], axis=1))


def test_chunked_walk_equals_one_chunk(monkeypatch):
    """Rows walked in chunks of 1,024 give what one chunk gives."""
    X = _rows("cat_rows.npy", n_rep=6)
    _, space, forest = _port_forest("ref_cat_model.txt")
    bins = torch.from_numpy(space.bin_matrix(X))
    es = EARLY_STOPS[1]
    whole = forest_predict_fn(space.meta, 1, es)(forest, bins)
    leaves = forest_leaf_fn(space.meta)(forest, bins)
    monkeypatch.setattr(forest_mod, "_CHUNK_ELEMS", 1)
    assert torch.equal(forest_predict_fn(space.meta, 1, es)(forest, bins),
                       whole)
    assert torch.equal(forest_leaf_fn(space.meta)(forest, bins), leaves)


def test_depth_is_known_on_the_host():
    """stack_forest records each tree's level count; the walk runs that
    many steps and no more (one more step changes nothing)."""
    g, space, forest = _port_forest("ref_plain20_model.txt")
    from lightgbm_tpu_torch.core.tree import tree_depth
    want = [tree_depth(t.left_child, t.right_child, t.num_leaves)
            for t in g.models]
    np.testing.assert_array_equal(forest.depth, want)
    assert forest.depth.dtype == np.int32 and forest.depth.max() > 1


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the walk's device path has no "
                    "second implementation to compare on the CPU")


@pytest.mark.cuda
@pytest.mark.parametrize("es", range(len(EARLY_STOPS)))
@pytest.mark.parametrize("name,rows", MODELS)
def test_forest_scan_on_card_equals_cpu(name, rows, es):
    _card()
    X = _rows(rows)
    out = {}
    for dev in ("cpu", "cuda"):
        _, space, forest = _port_forest(name, dev)
        bins = torch.from_numpy(space.bin_matrix(X)).to(dev)
        out[dev] = (
            forest_predict_fn(space.meta, 1, EARLY_STOPS[es])(forest, bins),
            forest_leaf_fn(space.meta)(forest, bins))
    assert torch.equal(out["cuda"][1].cpu(), out["cpu"][1])
    # the same f32 ops in the same order on both devices
    assert torch.equal(out["cuda"][0].cpu(), out["cpu"][0])


def test_stack_forest_lanes_match_reference():
    """``stack_forest(model_ids=, with_counts=)``: the arena's tenant lane
    and the cover counts equal the JAX package's stacks of one arena
    forest of two tenants (the binary model twice: the categorical one
    types its column differently, which the arena remaps first)."""
    pytest.importorskip("jax")
    import lightgbm_tpu as lgb
    from lightgbm_tpu.serve.packing import ServeBinSpace as RefSpace
    names = [MODELS[0][0]] * 2
    port = [Booster(model_file=os.path.join(FIX, n), device="cpu")._gbdt
            for n in names]
    ref = [lgb.Booster(model_file=os.path.join(FIX, n))._gbdt for n in names]
    mids = np.concatenate([np.full(len(g.models), i, np.int32)
                           for i, g in enumerate(port)])
    F = max(g.num_features for g in port)
    trees = [t for g in port for t in g.models]
    ref_trees = [t for g in ref for t in g.models]
    space = ServeBinSpace(trees, F, "cpu")
    ref_space = RefSpace(ref_trees, F)
    cls = np.zeros(len(trees), np.int32)
    forest = space.pack(trees, cls, with_counts=True, model_ids=mids)
    ref_forest = ref_space.pack(ref_trees, cls, with_counts=True,
                                model_ids=mids)
    for key in ("model_id", "internal_count", "leaf_count", "threshold_bin",
                "leaf_value"):
        np.testing.assert_array_equal(getattr(forest, key).numpy(),
                                      np.asarray(getattr(ref_forest, key)),
                                      err_msg=key)
    plain = space.pack(trees, cls)
    assert plain.model_id is None and plain.internal_count is None


@pytest.mark.cuda
def test_arena_walk_on_card_equals_cpu():
    _card()
    from lightgbm_tpu_torch.core.forest import arena_predict_fn
    names = [MODELS[0][0]] * 2
    X = _rows(MODELS[0][1])
    out = []
    for dev in ("cpu", "cuda"):
        gs = [Booster(model_file=os.path.join(FIX, n), device=dev)._gbdt
              for n in names]
        trees = [t for g in gs for t in g.models]
        mids = np.concatenate([np.full(len(g.models), i, np.int32)
                               for i, g in enumerate(gs)])
        space = ServeBinSpace(trees, max(g.num_features for g in gs), dev)
        forest = space.pack(trees, np.zeros(len(trees), np.int32),
                            model_ids=mids)
        Xw = np.zeros((len(X), space.num_features))
        Xw[:, :X.shape[1]] = X
        rm = torch.from_numpy(np.arange(len(X), dtype=np.int32) % 3 - 1)
        out.append(arena_predict_fn(space.meta, 1)(
            forest, torch.from_numpy(space.bin_matrix(Xw)).to(dev),
            rm.to(dev)).cpu())
    assert torch.equal(out[0], out[1])
