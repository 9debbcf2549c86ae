"""The learners across ranks (``lightgbm_tpu_torch/parallel/``), twins of
tests/test_parallel.py: two port ranks over gloo (one process each, a
file store in ``tmp_path``, ``tools/dist_check.py``, one start for every
mode) against the JAX package on the same rows, and world size 1
against the serial learners.

- ``data`` on the serial grower (the forced-splits file sends both
  packages to it, and both ignore it under a parallel learner),
  ``feature`` and ``voting`` (top_k=2, so the gate drops columns) against
  the JAX ``tpu_mesh_shape="data:2"`` mesh trained end to end;
- ``data`` on the wave grower in 2xbf16 and int16, GOSS and bagging
  under ``data``: against the JAX wave grower (Pallas interpreter).  The
  JAX trainer's mesh branch does not pass the interpreter on to its wave
  grower, so on the CPU its ``data:2`` training takes the XLA serial
  grower; the JAX mesh wave grower itself is held against the port's
  grower on the same inputs (``test_jax_mesh_wave_grower_twin``), and
  the JAX package pins its mesh wave grower to its one-device wave grower
  (tests/test_parallel.py::test_wave_data_parallel_matches_single_device);
- in every mode both ranks write the same model, and its trees equal the
  JAX package's node for node (splits, thresholds, children, leaf
  counts); leaf values and raw scores within 1e-4 (each package adds its
  f32 partial sums in its own order, as in tests/test_torch_train.py; in
  int16 an ulp of a score re-draws a row's stochastic rounding in the
  next tree, tests/test_torch_train_quant.py);
- the int16 data-parallel trees equal the one-process port trees bit for
  bit, the 2xbf16 ones within 1e-6 in raw score (per-rank f32 partials
  summed after K1's epilogue reassociate the adds);
- the collectives each mode runs are counted on both ranks alike;
- ``hist_wave``'s exact int sums: the accumulator decode against an
  emulation of the kernel's packed adds, carries included.
"""
import json

import numpy as np
import pytest

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.tools.dist_check import launch

BASE = {"objective": "binary", "num_leaves": 15, "min_data_in_leaf": 20,
        "max_bin": 63, "learning_rate": 0.1, "verbose": -1}
ROUNDS = 3


@pytest.fixture(autouse=True)
def _one_cpu_thread():
    """One intra-op thread a test: a parallel test run shares the machine
    among its workers, and torch's CPU thread pool then spends most of a
    small op waiting for oversubscribed threads.  Restored after each
    test."""
    import torch
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _data(n=1001, f=6, seed=2):
    """Well separated for both packages (tests/test_torch_train.py's
    recipe, no NaNs); 1,001 rows so that the padded last row block is
    exercised.  Seed 1 has a near-tied split in tree 0 (gains 4.594875 /
    4.594885) that the JAX package's own ``data:2`` mesh breaks the other
    way from its ``data:1`` run (f32 partial sums reassociated)."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f))
    X[:, 3] = np.round(X[:, 3])
    logit = X[:, 0] - 0.8 * X[:, 1] + X[:, 2] * X[:, 4] + 0.5 * X[:, 3]
    y = (logit + rng.logistic(size=n) > 0).astype(np.float64)
    return X, y


def _modes(forced):
    d = dict(BASE, tree_learner="data")
    return [
        # (name, params, the JAX side runs its wave grower)
        ("data", d, True),
        ("data_int16", dict(d, tpu_hist_dtype="int16"), True),
        ("data_serial", dict(d, forcedsplits_filename=forced), False),
        ("feature", dict(BASE, tree_learner="feature"), False),
        ("voting", dict(BASE, tree_learner="voting", top_k=2), False),
        ("data_goss", dict(d, boosting="goss"), True),
        ("data_bagging", dict(d, bagging_fraction=0.7, bagging_freq=1),
         True),
    ]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("tparallel")
    X, y = _data()
    np.savez(d / "rows.npz", X=X, y=y)
    forced = str(d / "forced.json")
    with open(forced, "w") as fh:
        json.dump({"feature": 0, "threshold": 0.0}, fh)
    modes = _modes(forced)
    spec = {"data": str(d / "rows.npz"), "device": "cpu",
            "modes": [{"name": n, "params": p, "rounds": ROUNDS}
                      for n, p, _ in modes]}
    with open(d / "spec.json", "w") as fh:
        json.dump(spec, fh)
    res = launch(str(d / "spec.json"), 2, str(d), timeout=600)
    return X, y, {n: (p, w) for n, p, w in modes}, res


def _trees(text):
    return lt.Booster(model_str=text, device="cpu")._gbdt.models


def _assert_same_trees(got, want, leaf_atol):
    assert len(got) == len(want)
    for pt, rt in zip(got, want):
        assert pt.num_leaves == rt.num_leaves
        nn = rt.num_leaves - 1
        np.testing.assert_array_equal(pt.split_feature[:nn],
                                      rt.split_feature[:nn])
        np.testing.assert_array_equal(pt.threshold[:nn], rt.threshold[:nn])
        np.testing.assert_array_equal(pt.decision_type[:nn],
                                      rt.decision_type[:nn])
        np.testing.assert_array_equal(pt.left_child[:nn], rt.left_child[:nn])
        np.testing.assert_array_equal(pt.right_child[:nn],
                                      rt.right_child[:nn])
        np.testing.assert_array_equal(pt.leaf_count[:nn + 1],
                                      rt.leaf_count[:nn + 1])
        np.testing.assert_allclose(pt.leaf_value[:nn + 1],
                                   rt.leaf_value[:nn + 1], rtol=0,
                                   atol=leaf_atol)


def _jax_train(params, X, y, wave):
    """The JAX package's model: its ``data:2`` mesh (serial-grower
    learners), or its wave grower through the Pallas interpreter."""
    jax = pytest.importorskip("jax")
    assert len(jax.devices()) >= 2
    import lightgbm_tpu as jlgb
    mp = pytest.MonkeyPatch()
    if wave:
        mp.setenv("LGBM_TPU_FORCE_WAVE", "interpret")
        p = dict(params, tree_learner="serial")
    else:
        p = dict(params, tpu_mesh_shape="data:2")
    try:
        return jlgb.train(p, jlgb.Dataset(X, label=y, params=p), ROUNDS)
    finally:
        mp.undo()


MODES = ["data", "data_int16", "data_serial", "feature", "voting",
         "data_goss", "data_bagging"]


@pytest.mark.parametrize("name", MODES)
def test_two_ranks_match_the_jax_package(runs, name):
    X, y, modes, res = runs
    params, wave = modes[name]
    r0, r1 = (r["modes"][name] for r in res)
    # both ranks grew the same model on their own halves of the rows
    assert r0["model"] == r1["model"]
    assert r0["ranks"] == r1["ranks"] == 2
    assert r0["uses_wave"] == wave
    assert r0["collectives"] == r1["collectives"]
    ref = _jax_train(params, X, y, wave)
    _assert_same_trees(_trees(r0["model"]), ref._gbdt.models, 1e-4)
    np.testing.assert_allclose(np.asarray(r0["raw"]),
                               ref.predict(X, raw_score=True), rtol=0,
                               atol=1e-4)


@pytest.mark.parametrize("mode", ["2xbf16", "int16"])
def test_jax_mesh_wave_grower_twin(mode):
    """The JAX mesh wave grower (``make_data_parallel_wave_grower`` on a
    2-device mesh, Pallas interpreter) and the port's data-parallel wave
    grower (world size 1: reductions as identities, K1 unfused, the exact
    int sums) grow the same tree on the same bins and gradients."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    import torch
    from jax.sharding import Mesh

    import lightgbm_tpu as jlgb
    from lightgbm_tpu.core.meta import SplitConfig as JSplit
    from lightgbm_tpu.core.meta import build_device_meta as jmeta
    from lightgbm_tpu.parallel.mesh import make_data_parallel_wave_grower
    from lightgbm_tpu_torch.core.meta import (SplitConfig,
                                              build_device_meta)
    from lightgbm_tpu_torch.parallel.mesh import (
        build_mesh, make_data_parallel_wave_grower as port_grower)
    X, y = _data(n=800, seed=4)
    p = dict(BASE)
    jds = jlgb.Dataset(X, label=y, params=p)
    jds.construct()
    jh = jds._handle
    jcfg = jlgb.Config.from_params(p)
    meta, B = jmeta(jh, jcfg)
    rng = np.random.default_rng(5)
    g = rng.normal(size=len(y)).astype(np.float32)
    h = rng.uniform(0.1, 0.3, size=len(y)).astype(np.float32)
    mask = np.ones(len(y), np.float32)
    fmask = np.ones(jh.num_features, bool)
    kw = dict(wave_capacity=8, highest=mode, gain_gate=0.5, quant_seed=3)
    mesh = Mesh(np.array(jax.devices()[:2]), ("data",))
    jt, jleaf = make_data_parallel_wave_grower(
        meta, JSplit.from_config(jcfg), B, mesh, interpret=True, **kw)(
        jnp.asarray(np.ascontiguousarray(jh.X_bin.T)), jnp.asarray(g),
        jnp.asarray(h), jnp.asarray(mask), jnp.asarray(fmask))
    pds = lt.Dataset(X, label=y, params=p).construct()._handle
    pcfg = lt.Config.from_params(p)
    pmeta, pB = build_device_meta(pds, pcfg, "cpu")
    assert pB == B
    grow = port_grower(pmeta, SplitConfig.from_config(pcfg), B,
                       build_mesh("", "cpu"), **kw)
    pt, pleaf, _ = grow(torch.as_tensor(np.ascontiguousarray(pds.X_bin.T)),
                        torch.as_tensor(g), torch.as_tensor(h),
                        torch.as_tensor(mask), torch.as_tensor(fmask))
    nn = int(jt.num_leaves) - 1
    assert int(pt.num_leaves) == nn + 1
    for f in ("split_feature", "threshold_bin", "left_child",
              "right_child"):
        np.testing.assert_array_equal(np.asarray(getattr(pt, f))[:nn],
                                      np.asarray(getattr(jt, f))[:nn])
    np.testing.assert_array_equal(np.asarray(pt.leaf_count)[:nn + 1],
                                  np.asarray(jt.leaf_count)[:nn + 1])
    # unshrunk leaf outputs (|v| up to ~4): the split scans' f32 prefix
    # sums run in each package's own order
    np.testing.assert_allclose(np.asarray(pt.leaf_value)[:nn + 1],
                               np.asarray(jt.leaf_value)[:nn + 1], rtol=0,
                               atol=1e-4)
    np.testing.assert_array_equal(pleaf.numpy(), np.asarray(jleaf))


def test_collectives_by_learner(runs):
    _, _, _, res = runs
    m = res[0]["modes"]
    for name in ("data", "data_serial", "data_goss", "data_bagging"):
        c = m[name]["collectives"]
        # histograms and root sums summed; one leaf-id gather a tree
        assert c["psum"]["calls"] > 0 and c["pmax"]["calls"] == 0, name
        assert c["all_gather"]["calls"] == ROUNDS, name
    # int16 takes the global |g|, |h| maxima once a tree
    assert m["data_int16"]["collectives"]["pmax"]["calls"] == ROUNDS
    # feature parallel exchanges best splits, never histograms
    c = m["feature"]["collectives"]
    assert c["psum"]["calls"] == 0 and c["all_gather"]["calls"] > ROUNDS
    # voting sums votes and gated histograms, with explicit siblings
    assert m["voting"]["collectives"]["psum"]["calls"] > \
        m["data_serial"]["collectives"]["psum"]["calls"]


@pytest.mark.parametrize("name,atol", [("data_int16", 0.0), ("data", 1e-6),
                                       ("feature", 0.0),
                                       ("data_serial", 1e-6)])
def test_two_ranks_match_one_process(runs, name, atol):
    """The same learner at world size 1 (the collectives as identities)."""
    X, y, modes, res = runs
    params, _ = modes[name]
    one = lt.train(params, lt.Dataset(X, label=y, params=params), ROUNDS,
                   device="cpu")
    got = np.asarray(res[0]["modes"][name]["raw"])
    want = one.predict(X, raw_score=True)
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    if atol == 0.0:
        head = res[0]["modes"][name]["model"].split("\nparameters:")[0]
        assert head == one.model_to_string().split("\nparameters:")[0]


def test_world_one_equals_the_serial_learners(tmp_path):
    """World size 1 runs the parallel code paths: ``data`` on the wave
    grower is ``serial``'s wave grower, and ``feature`` and ``data`` on
    the serial grower are the serial grower, bit for bit.  (``voting``
    histograms each sibling instead of subtracting it, so its f32 sums
    differ in the last bits; it is held against the JAX mesh above.)"""
    X, y = _data(n=600, seed=2)

    def model(**kw):
        p = dict(BASE, **kw)
        b = lt.train(p, lt.Dataset(X, label=y, params=p), ROUNDS,
                     device="cpu")
        assert b._gbdt._mesh is None or b._gbdt._mesh.size == 1
        return b.model_to_string().split("\nparameters:")[0]
    assert model(tree_learner="data") == model()
    forced = str(tmp_path / "forced.json")
    with open(forced, "w") as fh:
        json.dump({"feature": 0, "threshold": 0.0}, fh)
    serial = model(tree_learner="data", forcedsplits_filename=forced)
    assert model(tree_learner="feature") == serial


def test_engine_grower_pads_and_gathers_at_world_one():
    """``shard_rows`` pads the row block; ``pad_rows``/``row_block`` give
    the block ``P("data")`` gives a device."""
    import torch

    from lightgbm_tpu_torch.parallel.mesh import (Mesh, engine_pad_bins,
                                                  pad_rows, row_block,
                                                  shard_rows)
    m = Mesh(3, 2, None, torch.device("cpu"))
    assert pad_rows(m, 10) == 12 and row_block(m, 10) == (8, 12)
    (blk,) = shard_rows(m, torch.arange(10))
    assert blk.tolist() == [8, 9, 0, 0]
    (fm,) = shard_rows(m, torch.arange(20).reshape(2, 10), axis=1)
    assert fm.tolist() == [[8, 9, 0, 0], [18, 19, 0, 0]]
    assert engine_pad_bins(np.ones((2, 10), np.uint8), 3, True).shape == \
        (2, 12)
    assert engine_pad_bins(np.ones((10, 2), np.uint8), 3, False).shape == \
        (12, 2)


def _emulate_packed(rng, cells, adds):
    """The kernel's packed (g, h, count) adds (csrc/hist_wave.cu
    ``add_packed``: one 64-bit add into W, the wrapping fields' carries
    into the correction words) on Python ints, with the true sums."""
    M = (1 << 64) - 1

    def sext(x, b):
        x &= (1 << b) - 1
        return x - (1 << b) if x >> (b - 1) else x

    def unpack(w):
        d0 = sext(w, 21)
        w = ((w - d0) & M) >> 21
        d1 = sext(w, 21)
        w = ((w - d1) & M) >> 21
        return d0, d1, sext(w, 22)
    acc = [[0, 0, 0, 0] for _ in range(cells)]
    truth = np.zeros((cells, 3), np.int64)
    for _ in range(adds):
        c = int(rng.integers(cells))
        v = (int(rng.integers(-32768, 32768)),
             int(rng.integers(-32768, 32768)), 1)
        old = acc[c][0]
        acc[c][0] = (old + v[0] + (v[1] << 21) + (v[2] << 42)) & M
        d0, d1, d2 = unpack(old)
        c1 = (d0 + v[0] + (1 << 20)) >> 21
        c2 = (d1 + v[1] + c1 + (1 << 20)) >> 21
        c3 = (d2 + v[2] + c2 + (1 << 21)) >> 22
        for k, e in enumerate((c1 << 21, (c2 << 21) - c1, (c3 << 22) - c2)):
            acc[c][1 + k] = (acc[c][1 + k] + e) & M
        truth[c] += v
    words = [[x - (1 << 64) if x >> 63 else x for x in cell] for cell in acc]
    return np.asarray(words, np.int64).reshape(-1), truth


@pytest.mark.parametrize("packed", [True, False])
def test_decode_packed_matches_the_kernels_adds(packed):
    import torch

    from lightgbm_tpu_torch.ops.hist_wave import C_MAX, decode_packed
    F, B, S = 2, 3, 2
    acc, truth = _emulate_packed(np.random.default_rng(0), F * B * S,
                                 20000)
    assert np.abs(truth[:, :2]).max() > (1 << 21)      # carries taken
    out = decode_packed(torch.from_numpy(acc), F, B, S, packed)
    t = torch.from_numpy(truth.reshape(F, B, S, 3))
    if packed:
        gh, ct = out
        assert gh.shape == ct.shape == (F, B, C_MAX)
        assert torch.equal(gh[..., :2 * S].reshape(F, B, S, 2), t[..., :2])
        assert torch.equal(ct[..., :S], t[..., 2])
        assert not gh[..., 2 * S:].any() and not ct[..., S:].any()
    else:
        assert torch.equal(out[..., :3 * S].reshape(F, B, S, 3), t)


def test_exact_plain_sums_round_to_the_f32_output():
    """``exact=True`` on the plain version: the int64 sums whose one
    rounding is the f32 output."""
    import torch

    from lightgbm_tpu_torch.ops.hist_wave import hist_wave
    rng = np.random.default_rng(3)
    N, F, B = 4000, 3, 16
    bins = torch.as_tensor(rng.integers(0, B, size=(F, N)).astype(np.uint8))
    gv = torch.as_tensor(rng.integers(-32767, 32768, N).astype(np.float32))
    hv = torch.as_tensor(rng.integers(0, 32768, N).astype(np.float32))
    cv = torch.ones(N)
    leaf = torch.as_tensor(rng.integers(0, 3, N).astype(np.int32))
    slots = torch.full((128,), -1, dtype=torch.int32)
    slots[:4] = torch.tensor([0, 0, 1, 1], dtype=torch.int32)
    f32 = hist_wave(bins, gv, hv, cv, leaf, slots, B, highest="int16")
    ex = hist_wave(bins, gv, hv, cv, leaf, slots, B, highest="int16",
                   exact=True)
    assert ex[0].dtype == torch.int64
    for a, b in zip(f32, ex):
        assert torch.equal(a, b.float())
    with pytest.raises(ValueError):
        hist_wave(bins, gv, hv, cv, leaf, slots, B, highest="2xbf16",
                  exact=True)


@pytest.mark.cuda
def test_exact_kernel_sums_on_card():
    """The card's decoded accumulator rounds to the kernel's own output."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the packed accumulator is the "
                    "kernel's (the CPU case is test_exact_plain_sums_"
                    "round_to_the_f32_output)")
    from lightgbm_tpu_torch.ops.hist_wave import hist_wave
    rng = np.random.default_rng(4)
    N, F, B = 200_000, 4, 16      # ~2,500 rows a cell: sums past 2^24
    dev = "cuda"
    bins = torch.as_tensor(rng.integers(0, B, size=(F, N)).astype(
        np.uint8)).to(dev)
    gv = torch.as_tensor(rng.integers(-32767, 32768, N).astype(
        np.float32)).to(dev)
    hv = torch.as_tensor(rng.integers(0, 32768, N).astype(np.float32)).to(dev)
    cv = torch.ones(N, device=dev)
    leaf = torch.as_tensor(rng.integers(0, 5, N).astype(np.int32)).to(dev)
    for packed, lanes in ((True, 2), (False, 3)):
        slots = torch.full((128,), -1, dtype=torch.int32)
        slots[:4 * lanes] = torch.as_tensor(np.repeat(np.arange(4), lanes),
                                            dtype=torch.int32)
        slots = slots.to(dev)
        f32 = hist_wave(bins, gv, hv, cv, leaf, slots, B, highest="int16",
                        packed=packed, num_slots=4)
        ex = hist_wave(bins, gv, hv, cv, leaf, slots, B, highest="int16",
                       packed=packed, num_slots=4, exact=True)
        f32 = f32 if packed else (f32,)
        ex = ex if packed else (ex,)
        for a, b in zip(f32, ex):
            assert torch.equal(a, b.float())
        assert ex[0].abs().max() > (1 << 24)     # g/h beyond f32's integers
