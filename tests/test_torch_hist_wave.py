"""K1's plain PyTorch version against the Pallas kernel (interpret mode) in
the packed and triple layouts, fused and unfused, in every mode; the CPU
dispatch of the wrapper; and, on a CUDA card, the kernel against the plain
version.

Tolerance: counts exact; float-mode g/h at rtol=1e-5, atol=1e-5 — both
sides round g/h the same way and accumulate in f32, only the summation
order differs (as tests/test_wave.py holds the Pallas kernel to its XLA
oracle).  The int16/int8 modes are array-equal: integer sums (the
Pallas kernel's f32 sums are exact while every cell stays below 2^24, as
here; the card's kernel sums in int64 at any size)."""
import numpy as np
import pytest
import torch

from lightgbm_tpu_torch.core.histogram import hist_scatter
from lightgbm_tpu_torch.ops import hist_wave as hw

MODES = ["highest", "2xbf16", "bf16"]
QUANT = {"int16": 32767, "int8": 127}


def _inputs(N=700, F=6, B=64, pend=(3, 0, 7, 5, 9), seed=0):
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, B, size=(F, N)).astype(np.uint8)   # 0 .. B-1
    gv = rng.normal(size=N).astype(np.float32)
    hv = (0.05 + rng.random(size=N)).astype(np.float32)
    cv = (rng.random(size=N) < 0.9).astype(np.float32)   # bag-masked rows
    gv *= cv
    hv *= cv
    leaf = rng.integers(0, 12, size=N).astype(np.int32)
    slot = np.full(128, -1, np.int32)
    slot[:2 * len(pend)] = np.repeat(np.asarray(pend, np.int32), 2)
    parent = (rng.normal(size=(F, B, 128)).astype(np.float32) * 50,
              rng.integers(0, 500, size=(F, B, 128)).astype(np.float32))
    return bins, gv, hv, cv, leaf, slot, parent


def _torch(arrs):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrs]


def _assert_close(got, want):
    np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(want[1]))
    np.testing.assert_allclose(np.asarray(got[0]), np.asarray(want[0]),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_plain_matches_pallas_interpret(mode, fused):
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from lightgbm_tpu.ops.pallas_hist import hist_pallas_wave
    bins, gv, hv, cv, leaf, slot, parent = _inputs(seed=len(mode) + fused)
    B = 64
    ref = hist_pallas_wave(
        jnp.asarray(bins), jnp.asarray(gv), jnp.asarray(hv), jnp.asarray(cv),
        jnp.asarray(leaf), jnp.asarray(slot), B=B, highest=mode,
        interpret=True, packed=True,
        parent=tuple(jnp.asarray(p) for p in parent) if fused else None)
    got = hw.hist_wave_plain(*_torch([bins, gv, hv, cv, leaf, slot]), B,
                             highest=mode, packed=True,
                             parent=tuple(_torch(parent)) if fused else None)
    if fused:
        _assert_close(got[0], ref[0])
        _assert_close(got[1], ref[1])
    else:
        _assert_close(got, ref)


def _skew(bins, seed=0):
    """Low-cardinality features in place: feature 0 takes two bins (0 and
    B-1), feature 1 puts every row in one bin, feature 2 90% of its rows;
    the others stay spread over [0, B)."""
    rng = np.random.default_rng(seed)
    B = int(bins.max()) + 1
    N = bins.shape[1]
    bins = bins.copy()
    bins[0] = rng.integers(0, 2, size=N) * (B - 1)
    bins[1] = 5
    bins[2] = np.where(rng.random(N) < 0.9, 3, bins[2])
    return bins


def _slots(pend, packed):
    lanes = 2 if packed else 3
    slot = np.full(128, -1, np.int32)
    slot[:lanes * len(pend)] = np.repeat(np.asarray(pend, np.int32), lanes)
    return slot


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("mode", ["2xbf16", "highest"])
def test_plain_matches_pallas_interpret_skewed_bins(mode, packed, fused):
    """Skewed bins (the cells where the card's kernel reduces many rows):
    the plain version against the Pallas kernel in both layouts."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from lightgbm_tpu.ops.pallas_hist import hist_pallas_wave
    bins, gv, hv, cv, leaf, _, parent = _inputs(seed=20 + 2 * packed + fused)
    bins = _skew(bins, seed=packed + 2 * fused)
    slot = _slots((3, 0, 7, 5), packed)
    par = parent if packed else parent[0]
    jpar = tpar = None
    if fused:
        jpar = (tuple(jnp.asarray(p) for p in par) if packed
                else jnp.asarray(par))
        tpar = tuple(_torch(par)) if packed else _torch([par])[0]
    ref = hist_pallas_wave(
        *(jnp.asarray(a) for a in (bins, gv, hv, cv, leaf, slot)), B=64,
        highest=mode, interpret=True, packed=packed, parent=jpar)
    t = _torch([bins, gv, hv, cv, leaf, slot])
    got = hw.hist_wave_plain(*t, 64, highest=mode, packed=packed, parent=tpar)
    mag = hw.hist_wave_plain(t[0], t[1].abs(), t[2].abs(), *t[3:], 64,
                             highest=mode, packed=packed)
    _assert_f32_close(got, ref, mag, packed)
    child = _leaves(got)[0]
    assert child[1, 5].any() and not child[1, :5].any() \
        and not child[1, 6:].any()             # feature 1: one bin only


def _leaves(x):
    """The arrays of a K1 result (torch or jax), in order."""
    if isinstance(x, tuple):
        return [a for part in x for a in _leaves(part)]
    return [x]


def _assert_f32_close(got, want, mag, packed):
    """Counts equal, g/h within 1e-5 of each cell's sum of magnitudes
    ``mag`` (the plain version on |g|, |h|): both sides add the same
    rounded values in f32, in another order.  That holds for cells of up
    to 1,000 rows; the rounding of an f32 sum of n terms grows as sqrt(n)
    (either side's), so a cell of n rows more is held to sqrt(n / 1000)
    times it (chip_smoke.py's ROWS_AT_REL_TOL).  A fused sibling (parent -
    child) adds the rounding of the subtraction."""
    got = [np.asarray(a) for a in _leaves(got)]
    want = [np.asarray(a) for a in _leaves(want)]
    mag = [np.asarray(a) for a in _leaves(mag)]
    assert len(got) == len(want)
    lane = np.arange(128)
    rows = (want[1][..., lane // 2] if packed
            else want[0][..., np.minimum(lane // 3 * 3 + 2, 127)])
    scale = np.maximum(np.sqrt(rows / 1000.0), 1.0)
    for i, (g, w) in enumerate(zip(got, want)):
        if packed and i % 2 == 1:
            np.testing.assert_array_equal(g, w)           # counts
            continue
        if not packed:
            np.testing.assert_array_equal(g[..., 2::3], w[..., 2::3])
        lim = 1e-5 * mag[i % len(mag)] * scale + 1e-6
        if i >= len(mag):
            lim = lim + 1e-5 * np.abs(w)
        assert (np.abs(g - w) <= lim).all(), float(np.abs(g - w).max())


def test_plain_matches_scatter_oracle_per_slot():
    """Each lane pair holds its leaf's single-leaf histogram."""
    bins, gv, hv, cv, leaf, slot, _ = _inputs()
    t = _torch([bins, gv, hv, cv, leaf, slot])
    gh, cnt = hw.hist_wave_plain(*t, 64, highest="highest")
    for s, lf in enumerate(slot[0:10:2]):
        want = hist_scatter(t[0].T, t[1], t[2], t[3] * (t[4] == int(lf)), 64)
        torch.testing.assert_close(gh[:, :, 2 * s], want[..., 0],
                                   rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(gh[:, :, 2 * s + 1], want[..., 1],
                                   rtol=1e-5, atol=1e-5)
        assert torch.equal(cnt[:, :, s], want[..., 2])
    assert not gh[:, :, 10:].any() and not cnt[:, :, 5:].any()


def test_wrapper_takes_plain_on_cpu_without_counting():
    bins, gv, hv, cv, leaf, slot, parent = _inputs(seed=3)
    t = _torch([bins, gv, hv, cv, leaf, slot])
    before = hw.hist_wave.launches
    got = hw.hist_wave(*t, 64, highest="2xbf16", parent=tuple(_torch(parent)))
    want = hw.hist_wave_plain(*t, 64, highest="2xbf16",
                              parent=tuple(_torch(parent)))
    for g, w in zip(got, want):
        assert torch.equal(g[0], w[0]) and torch.equal(g[1], w[1])
    assert hw.hist_wave.launches == before


def _quant_inputs(mode, N=700, F=6, B=64, leaves=12, seed=0, packed=True,
                  n_slots=5):
    """Integer g/h as the quantized grower forms them (|q| <= QMAX, zeros
    on bag-masked rows), leaf ids, and the layout's slot map and parent
    in integer units."""
    rng = np.random.default_rng(seed)
    qmax = QUANT[mode]
    bins = rng.integers(0, B, size=(F, N)).astype(np.uint8)
    cv = (rng.random(size=N) < 0.9).astype(np.float32)
    gv = rng.integers(-qmax, qmax + 1, size=N).astype(np.float32) * cv
    hv = rng.integers(0, qmax + 1, size=N).astype(np.float32) * cv
    leaf = rng.integers(0, leaves, size=N).astype(np.int32)
    pend = rng.permutation(leaves)[:n_slots].astype(np.int32)
    lanes = 2 if packed else 3
    slot = np.full(128, -1, np.int32)
    slot[:lanes * n_slots] = np.repeat(pend, lanes)
    par = [rng.integers(-10 ** 6, 10 ** 6, size=(F, B, 128)).astype(np.float32)
           for _ in range(2 if packed else 1)]
    return (bins, gv, hv, cv, leaf, slot), (tuple(par) if packed else par[0])


def _as_np(x):
    return (tuple(np.asarray(a) for a in x) if isinstance(x, tuple)
            else np.asarray(x))


def _assert_equal(got, want):
    got, want = _as_np(got), _as_np(want)
    if isinstance(got, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("mode", list(QUANT))
def test_plain_quantized_equals_pallas_interpret(mode, packed, fused):
    """int16/int8: the plain version's integer sums are the Pallas
    kernel's, bit for bit, in both layouts, fused and unfused."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from lightgbm_tpu.ops.pallas_hist import hist_pallas_wave
    arrs, parent = _quant_inputs(mode, packed=packed,
                                 n_slots=5 if packed else 4,
                                 seed=2 * packed + fused)
    jpar = None
    if fused:
        jpar = (tuple(jnp.asarray(p) for p in parent) if packed
                else jnp.asarray(parent))
    ref = hist_pallas_wave(*(jnp.asarray(a) for a in arrs), B=64,
                           highest=mode, interpret=True, packed=packed,
                           parent=jpar)
    tpar = None
    if fused:
        tpar = tuple(_torch(parent)) if packed else _torch([parent])[0]
    got = hw.hist_wave_plain(*_torch(arrs), 64, highest=mode, packed=packed,
                             parent=tpar)
    if fused:
        _assert_equal(got[0], ref[0])
        _assert_equal(got[1], ref[1])
    else:
        _assert_equal(got, ref)


@pytest.mark.parametrize("mode", ["highest", "2xbf16", "bf16", "int16",
                                  "int8"])
def test_packed_and_triple_agree(mode):
    """The two layouts hold the same per-leaf sums: bit for bit in the int
    modes (integer units), and in the float modes wherever both round the
    value the same way (g, h; the packed count goes through bf16)."""
    if mode in QUANT:
        (bins, gv, hv, cv, leaf, _), _ = _quant_inputs(mode, seed=5)
    else:
        bins, gv, hv, cv, leaf, _, _ = _inputs(seed=5)
    pend = np.array([3, 0, 7, 5], np.int32)
    sp = np.full(128, -1, np.int32)
    sp[:8] = np.repeat(pend, 2)
    st = np.full(128, -1, np.int32)
    st[:12] = np.repeat(pend, 3)
    t = _torch([bins, gv, hv, cv, leaf])
    gh, cnt = hw.hist_wave_plain(*t, torch.from_numpy(sp), 64, highest=mode)
    tri = hw.hist_wave_plain(*t, torch.from_numpy(st), 64, highest=mode,
                             packed=False)
    assert torch.equal(tri[..., 0:12:3], gh[..., 0:8:2])
    assert torch.equal(tri[..., 1:12:3], gh[..., 1:8:2])
    assert torch.equal(tri[..., 2:12:3], cnt[..., :4])
    assert not tri[..., 12:].any()


def test_refuses_triple_layout_and_quantized_modes():
    """Unknown modes are refused.  Leaf ids past the int16 vector stream are
    refused where they would arise: ``num_leaves`` > 32000 under int16/int8.
    A stray one that reaches K1 saturates, as the reference's int16 cast
    does (array-equal to the Pallas kernel)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from lightgbm_tpu.ops.pallas_hist import hist_pallas_wave
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.utils.log import LightGBMError
    t = _torch(_inputs()[:6])
    with pytest.raises(LightGBMError, match="int16"):
        hw.hist_wave(*t, 64, highest="int4")
    for mode in QUANT:
        with pytest.raises(LightGBMError, match="32000"):
            Config.from_params({"tpu_hist_dtype": mode, "num_leaves": 32001})
    for packed in (True, False):
        arrs, _ = _quant_inputs("int16", packed=packed, seed=9)
        arrs[3][7] = 1.0                     # row 7 carries weight ...
        arrs[4][7] = 40000                   # ... and a leaf id past int16
        arrs[5][:2 if packed else 3] = 32767
        ref = hist_pallas_wave(*(jnp.asarray(a) for a in arrs), B=64,
                               highest="int16", interpret=True, packed=packed)
        got = hw.hist_wave(*_torch(arrs), 64, highest="int16", packed=packed)
        _assert_equal(got, ref)
        count0 = got[1][..., 0] if packed else got[..., 2]
        assert float(count0.sum()) == arrs[0].shape[0]   # row 7, per feature


# stochastic_round(32767.0, SAT_SEED) == 32768.0: the rounding lifts a
# scaled maximum past the int16 range under this seed
SAT_SEED = 1822


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("fused", [False, True])
def test_plain_saturates_like_pallas_interpret(packed, fused):
    """g and h at the int16 maximum, stochastic-rounded with a seed that
    lifts 32767 to 32768: the plain version saturates them as the
    reference's cast does, array-equal to the Pallas kernel, and does not
    raise."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from lightgbm_tpu.ops.pallas_hist import hist_pallas_wave
    from lightgbm_tpu_torch.ops.quant import stochastic_round
    arrs, parent = _quant_inputs("int16", packed=packed, seed=11 + fused)
    bins, gv, hv, cv, leaf, slot = arrs
    top = cv > 0
    top[np.nonzero(top)[0][50:]] = False          # 50 rows at the maximum
    gv = np.where(top, 32767.0, gv).astype(np.float32)
    hv = np.where(top, 32767.0, hv).astype(np.float32)
    gq = stochastic_round(torch.from_numpy(gv), SAT_SEED).numpy()
    hq = stochastic_round(torch.from_numpy(hv), SAT_SEED).numpy()
    assert gq.max() == hq.max() == 32768.0
    arrs = (bins, gq, hq, cv, leaf, slot)
    jpar = tpar = None
    if fused:
        jpar = (tuple(jnp.asarray(p) for p in parent) if packed
                else jnp.asarray(parent))
        tpar = tuple(_torch(parent)) if packed else _torch([parent])[0]
    ref = hist_pallas_wave(*(jnp.asarray(a) for a in arrs), B=64,
                           highest="int16", interpret=True, packed=packed,
                           parent=jpar)
    got = hw.hist_wave_plain(*_torch(arrs), 64, highest="int16",
                             packed=packed, parent=tpar)
    if fused:
        _assert_equal(got[0], ref[0])
        _assert_equal(got[1], ref[1])
    else:
        _assert_equal(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_kernel_matches_plain_on_card(mode, fused):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    bins, gv, hv, cv, leaf, slot, parent = _inputs(N=50_000, F=7, seed=4)
    t = [x.cuda() for x in _torch([bins, gv, hv, cv, leaf, slot])]
    par = tuple(x.cuda() for x in _torch(parent)) if fused else None
    before = hw.hist_wave.launches
    got = hw.hist_wave(*t, 64, highest=mode, parent=par, num_slots=5)
    want = hw.hist_wave_plain(*t, 64, highest=mode, parent=par)
    assert hw.hist_wave.launches == before + 1
    pairs = zip(got, want) if fused else [(got, want)]
    for g, w in pairs:
        assert torch.equal(g[1], w[1])
        torch.testing.assert_close(g[0], w[0], rtol=1e-5, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("mode", list(QUANT))
def test_quantized_kernel_equals_plain_on_card(mode, packed, fused):
    """Integer atomics are order-free: the kernel equals its plain version
    bit for bit, with leaf ids past the 4096-entry slot table."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    S = 30 if packed else 20
    arrs, parent = _quant_inputs(mode, N=150_000, F=7, B=256, leaves=9000,
                                 seed=6, packed=packed, n_slots=S)
    t = [torch.from_numpy(a).cuda() for a in arrs]
    par = None
    if fused:
        par = (tuple(torch.from_numpy(p).cuda() for p in parent) if packed
               else torch.from_numpy(parent).cuda())
    got = hw.hist_wave(*t, 256, highest=mode, packed=packed, parent=par,
                       num_slots=S)
    want = hw.hist_wave_plain(*t, 256, highest=mode, packed=packed,
                              parent=par)
    _assert_equal(tuple(x.cpu() for x in _flat(got)),
                  tuple(x.cpu() for x in _flat(want)))


def _flat(x):
    if isinstance(x, torch.Tensor):
        return (x,)
    return tuple(t for part in x for t in _flat(part))


def _card_matches_plain(arrs, B, mode, packed, parent, S):
    """One kernel launch on the card against the plain version on the
    same inputs (``_assert_f32_close``)."""
    t = [torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in arrs]
    par = None
    if parent is not None:
        par = (tuple(torch.from_numpy(p).cuda() for p in parent) if packed
               else torch.from_numpy(parent).cuda())
    before = hw.hist_wave.launches
    got = hw.hist_wave(*t, B, highest=mode, packed=packed, parent=par,
                       num_slots=S)
    assert hw.hist_wave.launches == before + 1
    want = hw.hist_wave_plain(*t, B, highest=mode, packed=packed, parent=par)
    mag = hw.hist_wave_plain(t[0], t[1].abs(), t[2].abs(), *t[3:], B,
                             highest=mode, packed=packed)
    _assert_f32_close(*(tuple(a.cpu() for a in _leaves(x))
                        for x in (got, want, mag)), packed)


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("many_slots", [False, True])
def test_kernel_matches_plain_on_card_skewed_bins(many_slots, packed, fused):
    """Skewed bins: many rows of a warp reduce into one cell.  4 slots
    take the float pass's shared-memory form (the whole histogram fits a
    block); the layout's most slots its L2 form."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    bins, gv, hv, cv, _, _, parent = _inputs(N=50_000, F=7, seed=30)
    bins = _skew(bins, seed=31)
    S = hw.wave_capacity_max(packed) if many_slots else 4
    rng = np.random.default_rng(32)
    leaf = rng.integers(0, 2 * S, size=bins.shape[1]).astype(np.int32)
    par = parent if packed else parent[0]
    _card_matches_plain((bins, gv, hv, cv, leaf,
                         _slots(rng.permutation(2 * S)[:S], packed)),
                        64, "2xbf16", packed, par if fused else None, S)


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("case", ["one_slot", "most_slots", "no_rows",
                                  "leaf_ids_past_table"])
def test_kernel_edge_shapes_on_card(case, packed):
    """S=1 with every row in its slot (a root wave, on skewed bins), the
    layout's most slots (63 packed, 42 triple), N=0 (the child is zero and
    the sibling the parent) and leaf ids past the 4,096-entry slot table,
    fused, against the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    rng = np.random.default_rng(40)
    N, F, B = (0 if case == "no_rows" else 60_000), 5, 256
    bins = rng.integers(0, B, size=(F, N)).astype(np.uint8)
    gv = rng.normal(size=N).astype(np.float32)
    hv = (0.05 + rng.random(size=N)).astype(np.float32)
    cv = np.ones(N, np.float32)
    S = wave_cap = hw.wave_capacity_max(packed)
    ids = np.arange(2 * wave_cap, dtype=np.int32)
    if case == "one_slot":
        S = 1
        bins = _skew(bins, seed=41) if N else bins
        ids = ids[:2] * 0 + 3
    elif case == "leaf_ids_past_table":
        S = 9
        ids = 5000 + 7 * ids
    leaf = ids[rng.integers(0, len(ids), size=N)]
    pend = rng.permutation(np.unique(ids))[:S]
    parent = [(rng.normal(size=(F, B, 128)) * 50).astype(np.float32),
              rng.integers(0, 500, size=(F, B, 128)).astype(np.float32)]
    _card_matches_plain((bins, gv, hv, cv, leaf, _slots(pend, packed)), B,
                        "2xbf16", packed,
                        tuple(parent) if packed else parent[0], S)


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_triple_kernel_matches_plain_on_card(mode, fused):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    bins, gv, hv, cv, leaf, _, _ = _inputs(N=50_000, F=7, seed=7)
    slot = np.full(128, -1, np.int32)
    slot[:15] = np.repeat(np.array([3, 0, 7, 5, 9], np.int32), 3)
    t = [x.cuda() for x in _torch([bins, gv, hv, cv, leaf, slot])]
    par = (torch.randn((7, 64, 128), device="cuda") * 50) if fused else None
    got = hw.hist_wave(*t, 64, highest=mode, packed=False, parent=par,
                       num_slots=5)
    want = hw.hist_wave_plain(*t, 64, highest=mode, packed=False, parent=par)
    for g, w in zip(_flat(got), _flat(want)):
        assert torch.equal(g[..., 2::3], w[..., 2::3])      # counts
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-3)


def _int_card_equal(arrs, B, mode, packed, parent, S):
    """One int kernel launch on the card, ``torch.equal`` to the plain
    version on the same inputs."""
    t = [torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in arrs]
    par = None
    if parent is not None:
        par = (tuple(torch.from_numpy(p).cuda() for p in parent) if packed
               else torch.from_numpy(parent).cuda())
    before = hw.hist_wave.launches
    got = hw.hist_wave(*t, B, highest=mode, packed=packed, parent=par,
                       num_slots=S)
    assert hw.hist_wave.launches == before + 1
    want = hw.hist_wave_plain(*t, B, highest=mode, packed=packed, parent=par)
    _assert_equal(tuple(x.cpu() for x in _flat(got)),
                  tuple(x.cpu() for x in _flat(want)))


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("many_slots", [False, True])
@pytest.mark.parametrize("mode", list(QUANT))
def test_quantized_kernel_equals_plain_on_card_skewed_bins(mode, many_slots,
                                                          packed, fused):
    """int16/int8 on skewed bins (many lanes of a warp on one cell), at one
    slot (the shared-memory form) and at the layout's most slots (the L2
    form): bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    S = hw.wave_capacity_max(packed) if many_slots else 1
    arrs, parent = _quant_inputs(mode, N=50_000, F=7, B=64, leaves=2 * S,
                                 seed=50 + 2 * packed + fused, packed=packed,
                                 n_slots=S)
    arrs = (_skew(arrs[0], seed=51),) + arrs[1:]
    _int_card_equal(arrs, 64, mode, packed, parent if fused else None, S)


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("S", [1, 63])
def test_quantized_kernel_cell_past_two_to_the_31_on_card(S, packed):
    """70,000 rows of g = 32,767, h = -32,768 in one slot and one bin of
    every feature: each cell's g and h totals pass 2^31 in magnitude (an
    int32 sum would wrap), in the shared-memory form (one slot) and the L2
    form (the layout's most slots at 256 bins, every row in the first).
    Bit for bit, fused, against the plain version's int64 sums."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    S = min(S, hw.wave_capacity_max(packed))
    N, F, B = 70_000, 3, 256
    bins = np.full((F, N), 7, np.uint8)
    gv = np.full(N, 32767.0, np.float32)
    hv = np.full(N, -32768.0, np.float32)
    cv = np.ones(N, np.float32)
    leaf = np.full(N, 5, np.int32)
    pend = np.concatenate([[5], 100 + np.arange(S - 1)]).astype(np.int32)
    rng = np.random.default_rng(60)
    par = [rng.integers(-10 ** 6, 10 ** 6, size=(F, B, 128)).astype(np.float32)
           for _ in range(2 if packed else 1)]
    assert N * 32767 > 2 ** 31
    _int_card_equal((bins, gv, hv, cv, leaf, _slots(pend, packed)), B,
                    "int16", packed, tuple(par) if packed else par[0], S)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [2, 33, 34])
def test_quantized_kernel_at_the_shared_memory_boundary_on_card(S):
    """At 28 features x 256 bins the int32 histograms of every feature fit
    a block's shared memory at S = 2, those of two features up to S = 33
    (the shared-memory form in feature tiles) and of one only at S = 34
    (the L2 form): all bit for bit, fused, packed."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    arrs, parent = _quant_inputs("int16", N=200_000, F=28, B=256,
                                 leaves=2 * S, seed=70 + S, n_slots=S)
    _int_card_equal(arrs, 256, "int16", True, parent, S)


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("many_slots", [False, True])
@pytest.mark.parametrize("mode", ["2xbf16", "highest"])
def test_float_kernel_is_repeatable_on_card(mode, many_slots, packed, fused):
    """The float modes sum g and h in fixed point, so two launches on the
    same inputs are bit-equal: skewed bins at one slot (the shared-memory
    form, the whole histogram in a block) and at the layout's most slots
    (the L2 form), in both layouts, fused and not."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    bins, gv, hv, cv, _, _, parent = _inputs(N=200_000, F=7, B=256, seed=80)
    bins = _skew(bins, seed=81)
    S = hw.wave_capacity_max(packed) if many_slots else 1
    rng = np.random.default_rng(82)
    leaf = rng.integers(0, 2 * S, size=bins.shape[1]).astype(np.int32)
    slot = _slots(rng.permutation(2 * S)[:S], packed)
    t = [torch.from_numpy(np.ascontiguousarray(a)).cuda()
         for a in (bins, gv, hv, cv, leaf, slot)]
    par = None
    if fused:
        par = (tuple(torch.from_numpy(p).cuda() for p in parent) if packed
               else torch.from_numpy(parent[0]).cuda())
    first = _leaves(hw.hist_wave(*t, 256, highest=mode, packed=packed,
                                 parent=par, num_slots=S))
    second = _leaves(hw.hist_wave(*t, 256, highest=mode, packed=packed,
                                  parent=par, num_slots=S))
    for a, b in zip(first, second):
        assert torch.equal(a, b)
