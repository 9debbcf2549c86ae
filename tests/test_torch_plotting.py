"""The port's plots against the JAX package's (twins of
``tests/test_plotting.py`` and of ``test_sklearn.py``'s plotting case):
Axes contents, not pixels.  One model of each package on the same seeded
rows (the JAX side on its wave grower through the Pallas interpreter);
the importance bars are equal, the metric curve equal within 1e-6."""
import numpy as np
import pytest

import lightgbm_tpu_torch as lt

matplotlib = pytest.importorskip("matplotlib")
matplotlib.use("Agg")  # headless

PARAMS = {"objective": "binary", "num_leaves": 15, "verbose": -1,
          "min_data_in_leaf": 5, "metric": ["auc", "binary_logloss"]}


@pytest.fixture(scope="module")
def trained():
    pytest.importorskip("jax")
    import lightgbm_tpu as jlgb
    rng = np.random.default_rng(5)
    X = rng.normal(size=(500, 6))
    y = (X[:, 0] + 0.5 * X[:, 1] > 0).astype(np.float64)
    out = []
    mp = pytest.MonkeyPatch()
    mp.setenv("LGBM_TPU_FORCE_WAVE", "interpret")
    try:
        for pkg, kw in ((jlgb, {}), (lt, {"device": "cpu"})):
            ds = pkg.Dataset(X, label=y, params=PARAMS)
            dv = pkg.Dataset(X[:200], label=y[:200], reference=ds)
            res = {}
            bst = pkg.train(PARAMS, ds, 5, valid_sets=[dv],
                            valid_names=["v"],
                            callbacks=[pkg.record_evaluation(res)], **kw)
            out.append((bst, res))
    finally:
        mp.undo()
    return jlgb, out[0], out[1]


def _bars(ax):
    return [(round(p.get_width(), 9), round(p.get_y(), 9))
            for p in ax.patches]


def _labels(ax):
    return [t.get_text() for t in ax.get_yticklabels()]


def test_plot_importance(trained):
    jlgb, (ref, _), (bst, _) = trained
    ax = lt.plot_importance(bst)
    want = jlgb.plot_importance(ref)
    assert ax.get_xlabel() == "Feature importance"
    assert len(ax.patches) > 0
    assert _bars(ax) == _bars(want) and _labels(ax) == _labels(want)
    ax2 = lt.plot_importance(bst, importance_type="gain",
                             max_num_features=3)
    assert len(ax2.patches) <= 3
    assert _labels(ax2) == _labels(jlgb.plot_importance(
        ref, importance_type="gain", max_num_features=3))


def test_plot_metric(trained):
    jlgb, (_, jres), (_, res) = trained
    ax = lt.plot_metric(res, metric="auc")
    assert len(ax.get_lines()) == 1
    got = ax.get_lines()[0].get_ydata()
    assert len(got) == 5
    want = jlgb.plot_metric(jres, metric="auc").get_lines()[0].get_ydata()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_plot_split_value_histogram(trained):
    jlgb, (ref, _), (bst, _) = trained
    ax = lt.plot_split_value_histogram(bst, feature=0)
    heights = [p.get_height() for p in ax.patches]
    assert heights == list(bst.get_split_value_histogram(0, bins="auto")[0])
    # the same number of splits on the feature as the JAX package's (a
    # threshold may sit elsewhere in a run of empty bins, a near-tie of
    # ROADMAP.md 3.3, which moves numpy's automatic bins)
    want = jlgb.plot_split_value_histogram(ref, feature=0)
    assert sum(heights) == sum(p.get_height() for p in want.patches) > 0


def test_plot_tree_and_digraph(trained):
    jlgb, (ref, _), (bst, _) = trained
    g = lt.create_tree_digraph(bst, tree_index=0)
    src = g.source if hasattr(g, "source") else str(g)
    assert "leaf" in src.lower()
    want = jlgb.create_tree_digraph(ref, tree_index=0)
    # the same nodes and edges (values may differ in the last digits)
    assert src.count("->") == want.source.count("->")


def test_plot_importance_on_loaded_model(trained, tmp_path):
    _, _, (bst, _) = trained
    path = str(tmp_path / "m.txt")
    bst.save_model(path)
    ax = lt.plot_importance(lt.Booster(model_file=path, device="cpu"))
    assert _bars(ax) == _bars(lt.plot_importance(bst))


def test_plotting_with_estimators():
    """plot_importance / plot_metric / split-value histogram / digraph of
    a fitted estimator (``test_sklearn.py``'s plotting case)."""
    rng = np.random.default_rng(8)
    X = rng.normal(size=(400, 5))
    y = np.where(X[:, 0] + X[:, 1] > 0, "pos", "neg")
    clf = lt.LGBMClassifier(n_estimators=4, num_leaves=7,
                            min_child_samples=5, device_type="cpu")
    clf.fit(X, y, eval_set=[(X, y)], eval_metric="binary_logloss")
    assert lt.plot_importance(clf) is not None
    assert lt.plot_metric(clf) is not None
    used = int(np.flatnonzero(clf.feature_importances_ > 0)[0])
    assert lt.plot_split_value_histogram(clf, used) is not None
    assert "leaf" in lt.create_tree_digraph(clf, tree_index=0).source
