"""The traffic generators: one seed, one data set; the query sizes are one
set whatever the seed."""
import numpy as np
import pytest
import torch

from gbdt_bench.data import higgs_like, mslr_like

HIGGS = {"rows": 3000, "features": 28, "informative": 8, "problem_seed": 0,
         "interaction": 0.5}
MSLR = {"rows": 4000, "features": 136, "informative": 12, "problem_seed": 0,
        "noise_scale": 2.0,
        "size_seed": 0, "mean_docs": 120.0, "max_docs": 1251,
        "size_sigma": 1.0, "grade_quantiles": [0.5, 0.75, 0.9, 0.97]}
CPU = torch.device("cpu")


@pytest.mark.parametrize("gen,spec", [(higgs_like, HIGGS), (mslr_like, MSLR)])
def test_same_seed_same_data(gen, spec):
    a = gen.make(spec, 2**31 + 7, CPU)
    b = gen.make(spec, 2**31 + 7, CPU)
    c = gen.make(spec, 8, CPU)
    assert a["X"].dtype == np.float32
    assert a["X"].shape == (spec["rows"], spec["features"])
    np.testing.assert_array_equal(a["X"], b["X"])
    np.testing.assert_array_equal(a["label"], b["label"])
    assert not np.array_equal(a["X"], c["X"])
    if a["group"] is not None:
        np.testing.assert_array_equal(a["group"], b["group"])


def test_query_sizes_are_one_set_in_another_order():
    a = mslr_like.make(MSLR, 1, CPU)["group"]
    b = mslr_like.make(MSLR, 2, CPU)["group"]
    assert a.sum() == b.sum() == MSLR["rows"]
    assert a.max() <= 1251 and a.min() >= 1
    np.testing.assert_array_equal(np.sort(a), np.sort(b))
    assert not np.array_equal(a, b)


def test_grades_match_the_per_query_loop():
    rng = np.random.default_rng(3)
    sizes = np.array([1, 2, 5, 17, 40], np.int64)
    score = rng.normal(size=sizes.sum())
    qs = [0.5, 0.75, 0.9, 0.97]
    want = np.zeros_like(score)
    lo = 0
    for s in sizes:
        q = score[lo:lo + s]
        want[lo:lo + s] = np.searchsorted(np.quantile(q, qs), q)
        lo += s
    got = mslr_like.grades(torch.as_tensor(score), torch.as_tensor(sizes), qs)
    np.testing.assert_array_equal(got.numpy(), want)


def test_higgs_labels_are_binary_and_mixed():
    y = higgs_like.make(HIGGS, 5, CPU)["label"]
    assert set(np.unique(y)) == {0.0, 1.0}
    assert 0.2 < y.mean() < 0.8
