"""The reference's own binning check and split scan on small hand-made
rows, against plain loops."""
import numpy as np
import torch

from gbdt_bench.reference import check

RNG = np.random.default_rng(11)


def _bounds(col, bins):
    edges = np.quantile(col, np.arange(1, bins) / bins)
    return np.append(edges, np.inf)


def test_even_bins_read_one_share_and_no_missing_bin():
    x = RNG.uniform(size=(1000, 1))
    gap, share, Xb, nbins = check.bin_numbers(
        torch.as_tensor(x), [_bounds(x[:, 0], 10)], 10)
    assert gap == 0.0 and nbins == [10]
    assert 1.0 <= share <= 1.01
    want = np.searchsorted(_bounds(x[:, 0], 10)[:-1], x[:, 0], side="left")
    np.testing.assert_array_equal(Xb[:, 0].numpy(), want)


def test_coarse_bins_read_their_shortfall_and_share():
    x = RNG.uniform(size=(1000, 1))
    gap, share, _, _ = check.bin_numbers(
        torch.as_tensor(x), [_bounds(x[:, 0], 5)], 10)
    assert gap == 5.0
    assert 1.98 <= share <= 2.02


def test_a_heavy_value_in_its_own_bin_is_even():
    x = np.repeat([0.0, 1.0, 2.0], [500, 250, 250])[:, None]
    gap, share, _, _ = check.bin_numbers(
        torch.as_tensor(x), [np.array([0.5, 1.5, np.inf])], 255)
    assert gap == 0.0 and share == 1.0
    gap, share, _, _ = check.bin_numbers(
        torch.as_tensor(x), [np.array([1.5, np.inf])], 255)
    assert gap == 1.0 and share == 1.5


def test_best_gains_match_a_loop_over_every_threshold():
    N, F, B = 300, 3, 6
    Xb = torch.as_tensor(RNG.integers(0, B, size=(N, F)), dtype=torch.int16)
    nbins = [B, B - 2, B]
    Xb[:, 1] = Xb[:, 1].clamp(max=B - 3)
    g = torch.as_tensor(RNG.normal(size=N))
    h = torch.as_tensor(RNG.uniform(0.1, 1.0, size=N))
    c = torch.ones(N, dtype=torch.float64)
    # root (node 0) -> leaf 0 | node 1 -> leaf 1 | leaf 2
    tree = {"num_leaves": 3, "left_child": np.array([-1, -2]),
            "right_child": np.array([1, -3])}
    leaf = torch.as_tensor(RNG.integers(0, 3, size=N))
    params = {"min_data_in_leaf": 5, "min_sum_hessian_in_leaf": 3.0,
              "lambda_l2": 0.5}
    got = check.best_gains(tree, leaf, c, g, h, Xb, nbins, params)

    def loop(rows):
        G, H = g[rows].sum(), h[rows].sum()
        best = -np.inf
        for f in range(F):
            for t in range(nbins[f] - 1):
                left = rows & (Xb[:, f].long() <= t)
                right = rows & ~left
                if min(int(left.sum()), int(right.sum())) < 5:
                    continue
                if min(float(h[left].sum()), float(h[right].sum())) < 3.0:
                    continue
                gain = (g[left].sum() ** 2 / (h[left].sum() + 0.5)
                        + g[right].sum() ** 2 / (h[right].sum() + 0.5)
                        - G ** 2 / (H + 0.5))
                best = max(best, float(gain))
        return best
    want = [loop(torch.ones(N, dtype=torch.bool)), loop(leaf >= 1)]
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_split_gap_reads_the_shortfall_of_the_chosen_split():
    best = np.array([10.0, 4.0, 1.0])
    assert check.split_gap(best, best.copy()) == 0.0
    # node 1 chose a split worth 3 of its best 4: 1 / max(4, median 4)
    assert check.split_gap(best, np.array([10.0, 3.0, 1.0])) == 0.25
