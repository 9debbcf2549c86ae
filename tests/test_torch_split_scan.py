"""The wave's split scan (``ops/split_scan.py``): the wrapper's plain path
against ``best_split`` followed by the wave grower's unpacking, case by
case (``tools/split_scan_cases.py``: missing types, monotone windows,
regularization, guards at their edges, a feature mask, CEGB penalties,
quantization scales, ``max_depth``); the grower's dispatch (categorical
data to ``best_split``, the rest through ``split_scan``, one scan a wave);
the cost the bound is stated from; and, on a card, the kernel against
the plain version."""
import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.convert import to_device_async
from lightgbm_tpu_torch.core.splitter import best_split, bitset_words
from lightgbm_tpu_torch.ops import split_scan as ss
from lightgbm_tpu_torch.tools.split_scan_cases import (CASES, compare_to_plain,
                                                        make_case, plain_lead)


def _unpack(res):
    """``scan_children``'s reading of a result block into the host state."""
    res = np.asarray(res)
    return dict(gain=res[:, 0].astype(np.float32),
                feature=res[:, 1].astype(np.int32),
                threshold=res[:, 2].astype(np.int32),
                default_left=res[:, 3] > 0,
                sums=res[:, 4:7].astype(np.float32),
                outs=res[:, 7:9].astype(np.float32),
                bitset=res[:, 9:].astype(np.int64).astype(np.int32))


def _reference(case):
    """The scan as the wave grower ran it before the kernel: the
    candidates' columns copied one by one, ``best_split`` and the
    ``max_depth`` mask."""
    cand = case["cand"]
    g, h, c, lo, hi, depth = (torch.as_tensor(a[cand])
                              for a in case["state"])
    kw, cfg = case["kw"], case["cfg"]
    hist_c = case["hist"][torch.as_tensor(cand, dtype=torch.int64)]
    if kw["scales"] is not None:
        hist_c = hist_c * kw["scales"]
    pen = (c[:, None] * kw["split_pen"] + kw["coupled"][None, :]
           if "coupled" in kw else None)
    bs = best_split(hist_c, g, h, c, case["meta"], cfg, lo, hi,
                    feature_mask=kw.get("feature_mask"), has_cat=False,
                    penalty_sub=pen)
    gain = bs.gain
    if cfg.max_depth > 0:
        gain = torch.where(depth < cfg.max_depth, gain,
                           torch.full_like(gain, float("-inf")))
    return dict(gain=gain.numpy(), feature=bs.feature.int().numpy(),
                threshold=bs.threshold.int().numpy(),
                default_left=bs.default_left.numpy(),
                sums=torch.stack([bs.left_g, bs.left_h, bs.left_c],
                                 1).numpy(),
                outs=torch.stack([bs.left_out, bs.right_out], 1).numpy(),
                bitset=bs.cat_bitset.numpy())


@pytest.mark.parametrize("name", CASES)
def test_plain_scan_matches_best_split(name):
    case = make_case(name, seed=7)
    cfg, kw = case["cfg"], case["kw"]
    blk = to_device_async(case["blk"], "cpu")
    calls, launches = ss.split_scan.plain_calls, ss.split_scan.launches
    res = ss.split_scan(case["hist"], blk, case["meta"], cfg, **kw)
    assert ss.split_scan.plain_calls == calls + 1
    assert ss.split_scan.launches == launches
    n, W = len(case["cand"]), bitset_words(case["hist"].shape[2])
    assert res.dtype == torch.float64 and res.shape == (n, 9 + W)
    got, ref = _unpack(res), _reference(case)
    for key in got:
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
    found = got["gain"] > -np.inf
    assert (got["feature"] >= 0).sum() >= n // 2, "few leaves found a split"
    assert not got["bitset"].any()
    c = case["state"][2][case["cand"]]
    if name == "min_data_edge":
        # the first candidate's split sits at the guard and stays admitted
        assert cfg.min_data_in_leaf > 0 and found[0]
        assert min(got["sums"][0, 2], c[0] - got["sums"][0, 2]) == \
            cfg.min_data_in_leaf
    if name == "min_hess_edge":
        h = case["state"][1][case["cand"]]
        assert cfg.min_sum_hessian_in_leaf > 0 and found[0]
        assert min(got["sums"][0, 1], h[0] - got["sums"][0, 1]) == \
            np.float32(cfg.min_sum_hessian_in_leaf)
    if name == "max_depth":
        deep = case["state"][5][case["cand"]] >= cfg.max_depth
        assert deep.any() and (got["gain"][deep] == -np.inf).all()
    if name == "feature_mask":
        mask = kw["feature_mask"].numpy()
        assert mask[got["feature"][found]].all() and not mask.all()
    if name == "ties":
        # the repeated pair ties at most leaves: the lower index wins
        assert (got["feature"][found] == 0).sum() > n // 2
    assert not (got["feature"] == 1).any()


def test_pack_block_carries_ids_and_depths_as_int_bits():
    case = make_case("max_depth", n=4, F=3, B=8, seed=1)
    blk = torch.as_tensor(case["blk"])
    cand = case["cand"]
    assert blk.shape == (ss.BLOCK_ROWS, 4)
    assert blk[0].view(torch.int32).tolist() == cand.tolist()
    # the root wave's missing sibling (-1) is the scratch slot, the last
    root = ss.pack_block(np.array([0, -1]), *case["state"])
    assert root.view(np.int32)[0].tolist() == [0, len(case["state"][0]) - 1]
    assert blk[6].view(torch.int32).numpy().tolist() == \
        case["state"][5][cand].tolist()
    for r in range(1, 6):
        np.testing.assert_array_equal(blk[r].numpy(), case["state"][r - 1][
            cand])


def test_split_scan_cost_counts_histogram_bytes():
    """The bound of the source note: the candidates' histograms read once
    (12 bytes a cell) and their result rows written once."""
    ops, nbytes = ss.split_scan_cost(126, 28, 256)
    assert nbytes == 12 * 126 * 28 * 256 + 8 * 126 * (9 + 8)
    assert ops == 126 * 28 * 256 * (3 + 2 * 24)
    case = make_case("plain", n=5, F=4, B=16)
    assert ss.split_scan_call_cost(case["hist"], torch.as_tensor(
        case["blk"]), case["meta"], case["cfg"]) == ss.split_scan_cost(
        5, 4, 16)


def _train(X, y, categorical=(), **extra):
    params = {"objective": "binary", "num_leaves": 15, "verbose": -1,
              "min_data_in_leaf": 5, **extra}
    ds = lt.Dataset(X, label=y, categorical_feature=list(categorical))
    bst = lt.Booster(params, ds, device="cpu")
    for _ in range(3):
        bst.update()
    return bst._gbdt


@pytest.mark.parametrize("categorical", [False, True],
                         ids=["numerical", "categorical"])
def test_grower_dispatch(categorical, monkeypatch):
    """Numerical data scans every wave through ``split_scan`` (its plain
    path here) and never calls ``best_split`` outside it; a categorical
    feature sends every wave to ``best_split``."""
    rng = np.random.default_rng(5)
    X = rng.normal(size=(600, 4))
    X[:, 3] = rng.integers(0, 6, 600)
    y = (X[:, 0] + (X[:, 3] % 2) > 0.5).astype(np.float64)
    calls = []
    real = ss.best_split

    def counting(*a, **kw):
        calls.append(kw.get("has_cat"))
        return real(*a, **kw)

    monkeypatch.setattr(ss, "best_split", counting)
    plain0 = ss.split_scan.plain_calls
    gb = _train(X, y, categorical=[3] if categorical else [])
    waves = sum(w for w, _ in gb.wave_stats)
    scans = sum(s.scans for s in gb.wave_stats)
    assert waves > len(gb.wave_stats)
    if categorical:
        assert scans == 0 and ss.split_scan.plain_calls == plain0
        assert calls == [True] * waves
    else:
        assert scans == waves == ss.split_scan.plain_calls - plain0
        assert calls == [False] * waves


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the split-scan kernel has no CPU "
                    "form (its plain version is tested above)")


@pytest.mark.cuda
@pytest.mark.parametrize("name", CASES)
def test_kernel_matches_plain_on_card(name):
    _card()
    case = make_case(name, n=40, F=20, B=64, seed=11, device="cuda",
                     rows=(500, 2000))
    blk = to_device_async(case["blk"], "cuda")
    args = (case["hist"], blk, case["meta"], case["cfg"])
    launches = ss.split_scan.launches
    res = ss.split_scan(*args, **case["kw"])
    torch.cuda.synchronize()
    assert ss.split_scan.launches == launches + 1
    plain = ss.split_scan_plain(*args, **case["kw"])
    lead = plain_lead(*args, **case["kw"], distinct=name == "ties")
    out = compare_to_plain(res.cpu(), plain.cpu(), lead.cpu())
    assert not out["bad"], out
    assert out["decided"] >= out["found"] // 2
    # feature 1 repeats feature 0: the lower index wins every tie
    assert not (res[:, 1] == 1).any()
