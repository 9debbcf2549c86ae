"""K2's plain PyTorch version against the Pallas kernel
(``hist_pallas_channels``, run in the TPU interpreter on the CPU) at C=128
and C=256 and in the single-leaf ``hist_pallas_fm`` form; the CPU dispatch
of the wrapper; and, on a CUDA card, the kernel against the plain version.

Tolerance: rtol = atol = 1e-5 — both sides add the same f32 values, in
another order (the Pallas kernel's HIGHEST-precision one-hot products are
exact)."""
import numpy as np
import pytest
import torch

from lightgbm_tpu_torch.ops import hist_channels as hc


def _inputs(N=3001, F=5, B=64, C=128, seed=0):
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, B, size=(F, N)).astype(np.uint8)    # 0 .. B-1
    gh = rng.normal(size=(N, C)).astype(np.float32)
    return bins, gh


def _pallas(fn, *args, **kw):
    pytest.importorskip("jax")
    from jax.experimental.pallas import tpu as pltpu
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(fn(*args, **kw))


@pytest.mark.parametrize("C", [128, 256])
def test_plain_matches_pallas_interpret(C):
    from lightgbm_tpu.ops.pallas_hist import hist_pallas_channels
    bins, gh = _inputs(C=C, seed=C)
    bins[0, :7] = 70                     # past B: no lane in either version
    want = _pallas(hist_pallas_channels, bins, gh, B=64)
    got = hc.hist_channels_plain(torch.from_numpy(bins),
                                 torch.from_numpy(gh), 64)
    assert got.shape == (5, 64, C)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_fm_form_matches_pallas_interpret():
    from lightgbm_tpu.ops.pallas_hist import hist_pallas_fm
    bins, _ = _inputs(F=4, seed=3)
    rng = np.random.default_rng(4)
    n = bins.shape[1]
    g = rng.normal(size=n).astype(np.float32)
    h = rng.random(size=n).astype(np.float32)
    mask = (rng.random(size=n) < 0.7).astype(np.float32)
    want = _pallas(hist_pallas_fm, bins, g, h, mask, B=64)
    got = hc.hist_channels_fm(*(torch.from_numpy(a)
                                for a in (bins, g, h, mask)), 64)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got[..., 2].numpy(), want[..., 2])


def test_wrapper_takes_plain_on_cpu_without_counting():
    bins, gh = _inputs(N=500, seed=5)
    t = torch.from_numpy(bins), torch.from_numpy(gh)
    before = hc.hist_channels.launches
    assert torch.equal(hc.hist_channels(*t, 64),
                       hc.hist_channels_plain(*t, 64))
    assert hc.hist_channels.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("C", [128, 256])
def test_kernel_matches_plain_on_card(C):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    bins, gh = _inputs(N=100_003, F=6, B=256, C=C, seed=6)
    b, g = torch.from_numpy(bins).cuda(), torch.from_numpy(gh).cuda()
    before = hc.hist_channels.launches
    got = hc.hist_channels(b, g, 256)
    want = hc.hist_channels_plain(b, g, 256)
    assert hc.hist_channels.launches == before + 1
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-3)


def _skewed_bins(bins, seed):
    """90% of every feature's rows in one bin, the rest left spread."""
    rng = np.random.default_rng(seed)
    hot = rng.random(bins.shape) < 0.9
    return np.where(hot, (np.arange(bins.shape[0]) * 37 % 64)[:, None],
                    bins).astype(np.uint8)


def test_plain_matches_pallas_interpret_skewed_bins():
    from lightgbm_tpu.ops.pallas_hist import hist_pallas_channels
    bins, gh = _inputs(seed=8)
    bins = _skewed_bins(bins, seed=9)
    want = _pallas(hist_pallas_channels, bins, gh, B=64)
    got = hc.hist_channels_plain(torch.from_numpy(bins),
                                 torch.from_numpy(gh), 64)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("sms, smem, F, N, C, want", [
    # H100 at the main shape: 28 items a row chunk, 33 chunks, 7 rounds
    (132, 198_656, 28, 1_000_000, 128, (33, 132)),
    (132, 198_656, 28, 1_000_000, 256, (33, 132)),
    # few rows: one chunk per 4,096 rows, fewer blocks than the card holds
    (132, 198_656, 28, 3_001, 128, (1, 28)),
    (132, 198_656, 5, 0, 256, (1, 16)),
    # a small histogram lets two blocks share an SM
    (132, 99_328, 5, 1_000_000, 128, (33, 264)),
])
def test_launch_geometry(sms, smem, F, N, C, want):
    """The work items (row chunk, 32 channels, 4 features) make a whole
    number of rounds over the blocks the card holds, where the rows allow
    it."""
    chunks, grid = hc.geometry(sms, smem, F, N, C)
    assert (chunks, grid) == want
    items = chunks * -(-F // 4) * (C // 32)
    assert grid <= items
    if grid == sms * (2 if smem < 100_000 else 1):
        assert items % grid == 0


@pytest.mark.cuda
@pytest.mark.parametrize("skewed", [False, True])
def test_kernel_is_deterministic_and_handles_ragged_rows_on_card(skewed):
    """N not a multiple of the 256-row tile (nor of the row chunk), bins
    spread or 90% in one bin, and one past B: within the f32 bound of the
    plain version, and two launches bit-equal (every cell has one owner and
    the chunks are summed in order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    bins, gh = _inputs(N=100_003, F=7, B=64, C=128, seed=10)
    if skewed:
        bins = _skewed_bins(bins, seed=11)
    bins[2, :13] = 70                   # past B: adds nothing
    b, g = torch.from_numpy(bins).cuda(), torch.from_numpy(gh).cuda()
    first = hc.hist_channels(b, g, 64)
    second = hc.hist_channels(b, g, 64)
    assert torch.equal(first, second)
    want = hc.hist_channels_plain(b, g, 64)
    mag = hc.hist_channels_plain(b, g.abs(), 64)
    err = (first - want).abs()
    # f32 sums of the same values in another order (chip_smoke.py's bound)
    assert bool((err <= 1e-5 * mag + 1e-6).all()), float(err.max())
