"""The v2.3.2 Python API of the port against the JAX package's: public
signatures, the methods of ``Dataset`` and ``Booster`` (rollback, eval,
the split-value histogram, ``trees_to_dataframe``), pickling and copies,
pandas input and its ``pandas_categorical`` trailer, the parameter block
of model text, and the methods that wait for a later item.

The cases twin ``tests/test_api_extras.py``.  The JAX side trains on its
wave grower through the Pallas interpreter (``LGBM_TPU_FORCE_WAVE``).
Tolerances: copies and pickles 0.0 difference; trees identical and raw
scores within 1e-4 between the packages (``test_torch_train.py``); the
parameter block byte-equal."""
import copy
import inspect
import pickle

import numpy as np
import pytest

import lightgbm_tpu_torch as lt

pd = pytest.importorskip("pandas")

PARAMS = {"objective": "binary", "num_leaves": 15, "verbose": -1,
          "min_data_in_leaf": 5}


def _xy(n=600, seed=4):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 6))
    y = (X[:, 0] + 0.5 * X[:, 1] > 0).astype(np.float64)
    return X, y


@pytest.fixture(scope="module")
def jlgb():
    pytest.importorskip("jax")
    import lightgbm_tpu
    mp = pytest.MonkeyPatch()
    mp.setenv("LGBM_TPU_FORCE_WAVE", "interpret")
    yield lightgbm_tpu
    mp.undo()


@pytest.fixture(scope="module")
def pair(jlgb):
    """One 5-round model of each package on the same rows."""
    X, y = _xy()
    ref = jlgb.train(PARAMS, jlgb.Dataset(X, label=y, params=PARAMS), 5)
    port = lt.train(PARAMS, lt.Dataset(X, label=y, params=PARAMS), 5,
                    device="cpu")
    return X, y, ref, port


# ---------------------------------------------------------------------------
# signatures
# ---------------------------------------------------------------------------

def _params_of(fn):
    return [(p.name, p.kind, p.default)
            for p in inspect.signature(fn).parameters.values()]


def _public(cls):
    return sorted(n for n, v in vars(cls).items()
                  if callable(v) and not n.startswith("_"))


def _surface(mod):
    """(name, function) of every public callable the check covers."""
    out = [("train", mod.train), ("cv", mod.cv),
           ("Dataset.__init__", mod.Dataset.__init__),
           ("Booster.__init__", mod.Booster.__init__)]
    for cls in (mod.Dataset, mod.Booster):
        out += [(f"{cls.__name__}.{n}", getattr(cls, n))
                for n in _public(cls)]
    for cls in (mod.LGBMModel, mod.LGBMRegressor, mod.LGBMClassifier,
                mod.LGBMRanker):
        out += [(f"{cls.__name__}.{n}", getattr(cls, n))
                for n in ["__init__"] + _public(cls)]
    return out


def test_signatures_equal_the_jax_packages(jlgb):
    """Every public function and method of the JAX package's ``train``,
    ``cv``, ``Dataset``, ``Booster`` and the four estimators exists in the
    port with the same parameters (names, kinds, defaults, order); the
    port may add ``device`` last, and nothing else."""
    ours = dict(_surface(lt))
    for name, fn in _surface(jlgb):
        assert name in ours, name
        want, got = _params_of(fn), _params_of(ours[name])
        if got and got[-1][0] == "device":
            got = got[:-1]
        assert got == want, name


def test_positional_fobj_trains_three_trees():
    """``train(p, ds, 3, [ds], ["t"], fobj)``: the sixth argument is
    ``fobj``, as in v2.3.2."""
    X, y = _xy()
    ds = lt.Dataset(X, label=y)

    def fobj(preds, data):
        p = 1.0 / (1.0 + np.exp(-preds))
        return p - data.get_label(), p * (1.0 - p)
    bst = lt.train({**PARAMS, "device_type": "cpu"}, ds, 3, [ds], ["t"],
                   fobj)
    assert bst.num_trees() == 3


def test_feature_name_categorical_and_keep_training_booster():
    X, y = _xy()
    X[:, 5] = np.floor(np.abs(X[:, 5]) * 3)
    names = [f"f{i}" for i in range(6)]
    ds = lt.Dataset(X, label=y)
    bst = lt.train({**PARAMS, "device_type": "cpu"}, ds, 1,
                   feature_name=names, categorical_feature=["f5"])
    assert bst.feature_name() == names
    from lightgbm_tpu_torch.io.binning import BIN_CATEGORICAL
    assert ds._handle.bin_mappers[5].bin_type == BIN_CATEGORICAL
    assert bst.train_set is None            # freed without keep
    kept = lt.train({**PARAMS, "device_type": "cpu"},
                    lt.Dataset(X, label=y), 1, keep_training_booster=True)
    assert kept.train_set is not None


# ---------------------------------------------------------------------------
# pickling and copies (test_api_extras.py twins)
# ---------------------------------------------------------------------------

def test_pickle_and_copy_roundtrip(pair):
    X, _, _, bst = pair
    want = bst.predict(X)
    re = pickle.loads(pickle.dumps(bst))
    np.testing.assert_array_equal(re.predict(X), want)
    assert re.current_iteration() == bst.current_iteration()
    assert re.device == bst.device
    np.testing.assert_array_equal(copy.deepcopy(bst).predict(X), want)
    np.testing.assert_array_equal(copy.copy(bst).predict(X), want)


def test_unpickled_cuda_booster_without_a_card_raises(pair, monkeypatch):
    """A booster pickled on the card comes back on the card, and without
    one raises as ``resolve_device`` does (never lands on the CPU)."""
    import torch
    state = pair[3].__getstate__()
    state["device"] = "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    bst = lt.Booster.__new__(lt.Booster)
    with pytest.raises(lt.LightGBMError, match="device='cuda'"):
        bst.__setstate__(state)


def test_sklearn_estimator_pickles():
    rng = np.random.default_rng(21)
    X = rng.normal(size=(300, 5))
    y = (X[:, 0] > 0).astype(int)
    clf = lt.LGBMClassifier(n_estimators=4, num_leaves=7,
                            min_child_samples=5, verbose=-1,
                            device_type="cpu")
    clf.fit(X, y)
    re = pickle.loads(pickle.dumps(clf))
    np.testing.assert_array_equal(re.predict_proba(X), clf.predict_proba(X))
    assert (re.predict(X) == clf.predict(X)).all()


# ---------------------------------------------------------------------------
# Booster and Dataset methods, against the JAX package
# ---------------------------------------------------------------------------

def test_get_split_value_histogram_matches(pair):
    _, _, ref, port = pair
    hist, edges = port.get_split_value_histogram(0)
    assert hist.sum() == int(port.feature_importance("split")[0])
    want_h, want_e = ref.get_split_value_histogram(0)
    np.testing.assert_array_equal(hist, want_h)
    np.testing.assert_allclose(edges, want_e, rtol=0, atol=0)
    df = port.get_split_value_histogram("Column_0", xgboost_style=True)
    pd.testing.assert_frame_equal(
        df, ref.get_split_value_histogram("Column_0", xgboost_style=True))


def test_trees_to_dataframe_matches(pair):
    _, _, ref, port = pair
    df, want = port.trees_to_dataframe(), ref.trees_to_dataframe()
    assert list(df.columns) == list(want.columns)
    assert df.node_index.is_unique
    for col in ("tree_index", "node_depth", "node_index", "left_child",
                "right_child", "parent_index", "split_feature",
                "decision_type", "missing_direction", "count"):
        assert df[col].tolist() == want[col].tolist(), col
    np.testing.assert_allclose(df["value"].to_numpy(np.float64),
                               want["value"].to_numpy(np.float64),
                               rtol=0, atol=1e-4)
    for ti in range(5):
        sub = df[df.tree_index == ti]
        leaves = sub[sub.split_feature.isna()]
        root = sub[sub.node_depth == 1].iloc[0]
        assert len(leaves) == len(sub) - len(leaves) + 1
        assert leaves["count"].sum() == root["count"]


def test_rollback_and_eval_match(jlgb):
    X, y = _xy()
    Xv, yv = _xy(n=200, seed=5)
    p = {**PARAMS, "metric": "binary_logloss"}
    boosters = []
    for pkg, kw in ((jlgb, {}), (lt, {"device": "cpu"})):
        ds = pkg.Dataset(X, label=y, params=p)
        bst = pkg.Booster(params=p, train_set=ds, **kw)
        dv = ds.create_valid(Xv, label=yv)
        bst.add_valid(dv, "v")
        for _ in range(4):
            bst.update()
        bst.rollback_one_iter()
        boosters.append((bst, ds, dv))
    (ref, rds, rdv), (port, pds, pdv) = boosters
    assert port.current_iteration() == ref.current_iteration() == 3
    assert port.num_trees() == 3
    np.testing.assert_allclose(port._raw_train_score(),
                               ref._raw_train_score(), rtol=0, atol=1e-4)
    got, want = port.eval(pdv), ref.eval(rdv)
    assert [e[:2] for e in got] == [e[:2] for e in want]
    np.testing.assert_allclose([e[2] for e in got], [e[2] for e in want],
                               rtol=0, atol=1e-6)
    assert port.eval(pds)[0][:2] == ref.eval(rds)[0][:2]
    assert pds.get_feature_name() == rds.get_feature_name()
    port.free_dataset()
    assert port.train_set is None


def test_dataset_get_data_and_create_valid():
    X, y = _xy()
    ds = lt.Dataset(X, label=y, free_raw_data=False)
    assert ds.get_data() is X
    ds.construct()
    assert ds.get_data() is X
    dv = ds.create_valid(X[:50], label=y[:50])
    assert dv.reference is ds and dv.free_raw_data is False
    freed = lt.Dataset(X, label=y).construct()
    assert freed.get_data() is None


@pytest.mark.parametrize("method,item", [
    # Booster.refit runs since online/ was ported (item None): it returns
    # a refit booster, held against the JAX package's refit of the same
    # model text
    pytest.param("refit", None, id="refit-online and serve"),
    ("set_network", "parallel and fleet planes"),
    ("free_network", "parallel and fleet planes")])
def test_methods_of_later_items_name_them(pair, jlgb, method, item):
    X, y, _, bst = pair
    if item is None:
        got = bst.refit(X, 1.0 - y, decay_rate=0.5)
        want = jlgb.Booster(model_str=bst.model_to_string()).refit(
            X, 1.0 - y, decay_rate=0.5)
        assert isinstance(got, lt.Booster) and got is not bst
        assert got.num_trees() == bst.num_trees() == 5
        for g, w, b in zip(got._gbdt.models, want._gbdt.models,
                           bst._gbdt.models):
            np.testing.assert_array_equal(g.split_feature, b.split_feature)
            np.testing.assert_allclose(g.leaf_value, w.leaf_value, rtol=0,
                                       atol=1e-6)
            assert not np.allclose(g.leaf_value, b.leaf_value)
        return
    args = {"set_network": ("127.0.0.1",), "free_network": ()}[method]
    with pytest.raises(lt.LightGBMError, match=item):
        getattr(bst, method)(*args)


# ---------------------------------------------------------------------------
# pandas (test_api_extras.py twins), against the JAX package
# ---------------------------------------------------------------------------

def _cat_frame(n=800, seed=6):
    rng = np.random.default_rng(seed)
    colors = rng.choice(["red", "green", "blue", "teal"], n)
    x1 = rng.normal(size=n)
    y = ((colors == "red") | (colors == "teal") * (x1 > 0)).astype(float)
    return pd.DataFrame({"c": pd.Categorical(colors), "x": x1}), y


def test_pandas_categorical_roundtrip(jlgb):
    df, y = _cat_frame()
    p = dict(PARAMS, min_data_in_leaf=5)
    bst = lt.train(p, lt.Dataset(df, label=y, params=p), 5, device="cpu")
    ref = jlgb.train(p, jlgb.Dataset(df, label=y, params=p), 5)
    assert bst.pandas_categorical == ref.pandas_categorical
    pred = bst.predict(df)
    np.testing.assert_allclose(pred, ref.predict(df), rtol=0, atol=1e-4)
    # the training category order wins at prediction time
    df2 = df.copy()
    df2["c"] = df2["c"].cat.set_categories(["teal", "blue", "green", "red"])
    np.testing.assert_array_equal(bst.predict(df2), pred)
    # an unseen category routes as missing
    df3 = df.copy().astype({"c": str})
    df3.loc[:, "c"] = "violet"
    df3["c"] = pd.Categorical(df3["c"])
    assert np.isfinite(bst.predict(df3)).all()
    # the trailer is the JAX package's, byte for byte
    txt = bst.model_to_string()
    trailer = txt[txt.rindex("\npandas_categorical:"):]
    want = ref.model_to_string()
    assert trailer == want[want.rindex("\npandas_categorical:"):]
    re = lt.Booster(model_str=txt, device="cpu")
    assert re.pandas_categorical == bst.pandas_categorical
    np.testing.assert_array_equal(re.predict(df2), pred)


def test_pandas_plain_dataframe_unchanged(jlgb):
    rng = np.random.default_rng(8)
    X = rng.normal(size=(400, 4))
    y = (X[:, 0] > 0).astype(np.float64)
    df = pd.DataFrame(X, columns=[f"f{i}" for i in range(4)])
    bst = lt.train(PARAMS, lt.Dataset(df, label=y, params=PARAMS), 3,
                   device="cpu")
    np.testing.assert_array_equal(bst.predict(df), bst.predict(X))
    ref = jlgb.train(PARAMS, jlgb.Dataset(df, label=y, params=PARAMS), 3)
    assert bst.feature_name() == ref.feature_name() == ["f0", "f1", "f2",
                                                        "f3"]


def test_pandas_int_categories_json_roundtrip():
    rng = np.random.default_rng(12)
    n = 400
    codes = rng.integers(10, 14, n)
    df = pd.DataFrame({"c": pd.Categorical(codes), "x": rng.normal(size=n)})
    y = (codes % 2).astype(float)
    bst = lt.train(PARAMS, lt.Dataset(df, label=y, params=PARAMS), 3,
                   device="cpu")
    re = lt.Booster(model_str=bst.model_to_string(), device="cpu")
    np.testing.assert_array_equal(re.predict(df), bst.predict(df))
    re2 = pickle.loads(pickle.dumps(bst))
    assert re2.pandas_categorical == bst.pandas_categorical
    np.testing.assert_array_equal(re2.predict(df), bst.predict(df))


def test_params_categorical_fallback_with_plain_dataframe():
    rng = np.random.default_rng(13)
    X = rng.integers(0, 5, size=(500, 3)).astype(float)
    y = (X[:, 2] % 2).astype(float)
    p = dict(PARAMS, categorical_feature=[2], min_data_in_leaf=5)
    ds = lt.Dataset(pd.DataFrame(X, columns=["a", "b", "c"]), label=y,
                    params=p)
    ds.construct()
    from lightgbm_tpu_torch.io.binning import BIN_CATEGORICAL
    assert ds._handle.bin_mappers[2].bin_type == BIN_CATEGORICAL


# ---------------------------------------------------------------------------
# model text (fault 3.9) and compat
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("extra", [
    {}, {"objective": "lambdarank", "eval_at": [1, 3]},
    {"max_bin_by_feature": [63] * 6, "bagging_fraction": 0.8,
     "bagging_freq": 1}], ids=["binary", "lambdarank", "lists"])
def test_parameter_block_byte_equal(jlgb, extra):
    """The parameter block of saved model text is the JAX package's,
    byte for byte: the list-typed fields always, the others off their
    default."""
    from lightgbm_tpu.config import Config as JConfig

    from lightgbm_tpu_torch.config import Config
    p = dict(PARAMS, **extra)

    def block(cfg):
        out = []
        for k, v in cfg.to_params().items():
            if isinstance(v, (list, tuple)):
                v = ",".join(str(x) for x in v)
            out.append(f"[{k}: {v}]")
        return "\n".join(out)
    assert block(Config.from_params(p)) == block(JConfig.from_params(p))


def test_saved_model_parameter_block_equals_jax(pair):
    _, _, ref, port = pair

    def block(txt):
        return txt[txt.index("\nparameters:"):txt.index("end of parameters")]
    assert block(port.model_to_string()) == block(ref.model_to_string())


def test_compat_module():
    import importlib.util
    import json

    from lightgbm_tpu_torch import compat
    for flag, mod in (("PANDAS_INSTALLED", "pandas"),
                      ("MATPLOTLIB_INSTALLED", "matplotlib"),
                      ("SKLEARN_INSTALLED", "sklearn"),
                      ("GRAPHVIZ_INSTALLED", "graphviz")):
        assert getattr(compat, flag) == bool(importlib.util.find_spec(mod))
    assert json.dumps({"v": np.int64(3), "a": np.array([1, 2])},
                      default=compat.json_default_with_numpy) \
        == '{"v": 3, "a": [1, 2]}'
    assert issubclass(compat.LGBMDeprecationWarning, UserWarning)
