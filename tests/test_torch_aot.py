"""The serving store and the per-bucket CUDA graphs
(``lightgbm_tpu_torch/serve/aot.py``), twins of tests/test_arena.py's AOT
cases on the CPU, on a JAX-trained model file both packages load:

- a cold session loaded from a warmed store answers every bucket bit-equal
  to the live session (and within 1e-6 of the JAX session), its request #1
  within twice the steady p99; the arena's store round trip likewise;
- a corrupt, truncated or foreign entry, or the ``serve_aot_load`` fault,
  gives one ``aot_fallback`` and the same answers;
- ``$LGBM_TPU_SERVE_AOT_DIR`` wins over ``tpu_serve_aot_dir`` and
  ``tpu_serve_aot=false`` disarms both; the ``tpu_serve_aot_*`` series
  render under the JAX package's names;
- on the card (``cuda``): each bucket's graph replay equals the eager walk
  bit for bit, and requests after warm-up capture nothing.
"""
import os
import pickle
import time

import numpy as np
import pytest
import torch

from lightgbm_tpu_torch import obs
from lightgbm_tpu_torch.robust import faults
from lightgbm_tpu_torch.serve import ForestArena, PredictorSession
from lightgbm_tpu_torch.serve import aot as paot
from lightgbm_tpu_torch.serve.metrics import (parse_prometheus,
                                              render_prometheus)

SIZES = (1, 2, 4, 8, 16, 32, 64)


@pytest.fixture(autouse=True)
def _one_cpu_thread():
    """One intra-op thread a test: a parallel test run shares the machine
    among its workers, and torch's CPU thread pool then spends most of a
    small op waiting for oversubscribed threads.  Restored after each
    test."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _disarm():
    faults.disarm()
    yield
    faults.disarm()


def _nan_matrix(rng, n, f):
    X = rng.normal(size=(n, f))
    X[rng.random((n, f)) < 0.08] = np.nan
    return X


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    """(model file, probe rows) of tests/test_arena.py's NaN-heavy binary
    tenant, trained by the JAX package, and a second tenant."""
    pytest.importorskip("jax")
    import lightgbm_tpu as jlgb
    rng = np.random.default_rng(10)
    X = _nan_matrix(rng, 600, 6)
    y = (np.nan_to_num(X[:, 0]) + np.nan_to_num(X[:, 1]) > 0).astype(float)
    p = {"objective": "binary", "verbose": -1, "num_leaves": 15,
         "min_data_in_leaf": 5}
    d = tmp_path_factory.mktemp("taot")
    path = str(d / "nan_bin.txt")
    jlgb.train(p, jlgb.Dataset(X, label=y, params=p), 10).save_model(path)
    Xd = rng.normal(size=(600, 4))
    yd = (Xd[:, 0] - 0.5 * Xd[:, 2] > 0).astype(float)
    path2 = str(d / "dense.txt")
    jlgb.train(dict(p, num_leaves=7), jlgb.Dataset(Xd, label=yd, params=p),
               12).save_model(path2)
    probe = np.random.default_rng(11)
    return path, _nan_matrix(probe, 160, 6), path2, probe.normal(size=(160, 4))


def _session(path, store=None, max_batch=64, **cfg):
    config = {"verbose": -1, **cfg}
    if store is not None:
        config["tpu_serve_aot_dir"] = str(store)
    return PredictorSession(path, config=config, max_batch=max_batch,
                            max_wait_ms=1.0, device="cpu")


def test_aot_roundtrip_cold_session_bit_equal(model, tmp_path):
    path, Xt = model[:2]
    warm = _session(path, tmp_path)
    assert warm.stats()["aot"]["status"] == "miss"
    assert warm.stats()["aot"]["saved"] == 1
    warm.warmup()
    want = {n: warm.predict(Xt[:n]) for n in SIZES}
    warm.close()

    cold = _session(path, tmp_path)
    st = cold.stats()["aot"]
    assert st["status"] == "hit" and st["loaded"] == 1
    assert st["saved"] == 0 and st["fallbacks"] == 0
    t0 = time.perf_counter()
    first = cold.predict(Xt[:16])
    req1_ms = (time.perf_counter() - t0) * 1e3
    got = {n: cold.predict(Xt[:n]) for n in SIZES}
    assert np.array_equal(first, want[16])
    assert all(np.array_equal(want[n], got[n]) for n in SIZES)
    # the CPU walks eagerly: no graph, none captured
    assert cold.stats()["graph_captures"] == 0
    assert cold.stats()["graph_buckets"] == []
    lat = []
    for _ in range(30):
        t0 = time.perf_counter()
        cold.predict(Xt[:16])
        lat.append((time.perf_counter() - t0) * 1e3)
    p99 = float(np.percentile(lat, 99))
    assert req1_ms <= max(2.0 * p99, 25.0), (req1_ms, p99)
    # the stored pack is the live one: its arrays are equal
    for a, b in zip(cold.forest, _session(path).forest):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
        elif a is not None:
            np.testing.assert_array_equal(a, b)
    cold.close()

    import lightgbm_tpu as jlgb
    from lightgbm_tpu.serve import PredictorSession as JSession
    with JSession(jlgb.Booster(model_file=path), max_batch=64,
                  max_wait_ms=1.0, config={"verbose": -1}) as js:
        np.testing.assert_allclose(got[64], js.predict(Xt[:64]), rtol=0,
                                   atol=1e-6)


def _entries(store):
    return [os.path.join(str(store), f) for f in os.listdir(str(store))
            if f.endswith(".aot")]


def _rewrite(path, **fields):
    with open(path, "rb") as fh:
        blob = pickle.load(fh)
    blob.update(fields)
    with open(path, "wb") as fh:
        pickle.dump(blob, fh)


@pytest.mark.parametrize("spoil", ["truncate", "garbage", "foreign_device",
                                   "foreign_versions", "wrong_window",
                                   "fault"])
def test_aot_bad_entry_falls_back_loudly(model, tmp_path, spoil):
    """Twin of test_arena.py test_aot_corrupt_entry_falls_back_loudly: one
    ``aot_fallback`` (event, counter, stats) and the live answers."""
    path, Xt = model[:2]
    _session(path, tmp_path, max_batch=32).close()
    entries = _entries(tmp_path)
    assert len(entries) == 1
    p = entries[0]
    if spoil == "truncate":
        with open(p, "r+b") as fh:
            fh.truncate(max(1, os.path.getsize(p) // 3))
    elif spoil == "garbage":
        with open(p, "wb") as fh:
            fh.write(b"not a store entry")
    elif spoil == "foreign_device":
        _rewrite(p, device="NVIDIA H100 80GB HBM3|sm_90")
    elif spoil == "foreign_versions":
        _rewrite(p, versions="torch 0.0|cuda None")
    elif spoil == "wrong_window":
        with open(p, "rb") as fh:
            blob = pickle.load(fh)
        blob["payload"]["ladder"] = [1, 2]
        with open(p, "wb") as fh:
            pickle.dump(blob, fh)
    else:
        faults.configure("serve_aot_load:raise@n=1")
    obs.enable_flight(64)
    sess = _session(path, tmp_path, max_batch=32)
    out = sess.predict(Xt[:32])
    st = sess.stats()["aot"]
    assert st["status"] == "fallback" and st["fallbacks"] == 1
    assert st["loaded"] == 0 and st["saved"] == 1    # packed, written anew
    assert sum(e.get("event") == "aot_fallback"
               for e in obs.flight_snapshot()) >= 1
    sess.close()
    with _session(path, max_batch=32) as ref:
        assert np.array_equal(out, ref.predict(Xt[:32]))
    # the rewritten entry loads again
    with _session(path, tmp_path, max_batch=32) as again:
        assert again.stats()["aot"]["status"] == "hit"


def test_aot_keys_apart(model, tmp_path):
    """Another model, another window or another ladder is another entry."""
    path, _, path2, _ = model
    _session(path, tmp_path).close()
    _session(path2, tmp_path).close()
    _session(path, tmp_path, max_batch=32).close()
    PredictorSession(path, config={"verbose": -1,
                                   "tpu_serve_aot_dir": str(tmp_path)},
                     num_iteration=5, max_batch=64, device="cpu").close()
    assert len(_entries(tmp_path)) == 4


def test_aot_dir_env_wins_and_disarm(monkeypatch, tmp_path):
    from lightgbm_tpu_torch.config import Config
    monkeypatch.delenv("LGBM_TPU_SERVE_AOT_DIR", raising=False)
    assert paot.resolve_aot_dir(Config()) is None
    cfg = Config.from_params({"tpu_serve_aot_dir": str(tmp_path / "a")})
    assert paot.resolve_aot_dir(cfg) == str(tmp_path / "a")
    monkeypatch.setenv("LGBM_TPU_SERVE_AOT_DIR", str(tmp_path / "b"))
    assert paot.resolve_aot_dir(cfg) == str(tmp_path / "b")
    assert paot.resolve_aot_dir(Config()) == str(tmp_path / "b")
    off = Config.from_params({"tpu_serve_aot_dir": str(tmp_path / "a"),
                              "tpu_serve_aot": False})
    assert paot.resolve_aot_dir(off) is None
    # the JAX package's rules, on the same inputs
    pytest.importorskip("jax")
    from lightgbm_tpu.config import Config as JConfig
    from lightgbm_tpu.serve.aot import resolve_aot_dir as jresolve
    for params in ({"tpu_serve_aot_dir": str(tmp_path / "a")},
                   {"tpu_serve_aot_dir": str(tmp_path / "a"),
                    "tpu_serve_aot": False}, {}):
        assert paot.resolve_aot_dir(Config.from_params(params)) == \
            jresolve(JConfig.from_params(params))


def test_aot_series_render_under_the_jax_names(model, tmp_path):
    path, Xt = model[:2]
    _session(path, tmp_path).close()
    with _session(path, tmp_path) as sess:
        sess.predict(Xt[:8])
        text = render_prometheus(sess)
    got = parse_prometheus(text)
    assert got["tpu_serve_aot_entries"] == 1
    assert got["tpu_serve_aot_loaded_total"] == 1
    assert got["tpu_serve_aot_saved_total"] == 0
    assert got["tpu_serve_aot_fallbacks_total"] == 0
    assert got["tpu_serve_aot_save_errors_total"] == 0
    pytest.importorskip("jax")
    from lightgbm_tpu.serve.metrics import _aot_series as jseries
    ours = {k for k in got if k.startswith("tpu_serve_aot_")}
    out = []
    jseries(out, lambda *a: None, {"entries": 1})
    assert ours == {line.split()[0] for line in out}
    # a storeless session renders none of them
    with _session(path) as bare:
        assert "tpu_serve_aot_" not in render_prometheus(bare)


def test_arena_store_roundtrip_bit_equal(model, tmp_path):
    path, Xt, path2, Xd = model
    cfg = {"verbose": -1, "tpu_serve_aot_dir": str(tmp_path)}

    def arena():
        a = ForestArena(config=cfg, max_batch=64, max_wait_ms=1.0,
                        device="cpu")
        a.admit("nan_bin", path)
        a.admit("dense", path2)
        return a
    first = arena()
    want = (first.predict(Xt, model="nan_bin"),
            first.predict(Xd, model="dense"))
    assert first.stats()["aot"]["saved"] == 2     # one entry a generation
    first.close()
    second = arena()
    st = second.stats()["aot"]
    assert st["status"] == "hit" and st["loaded"] == 2
    assert np.array_equal(second.predict(Xt, model="nan_bin"), want[0])
    assert np.array_equal(second.predict(Xd, model="dense"), want[1])
    second.close()


def test_compile_cache_records_only(tmp_path):
    from lightgbm_tpu_torch.utils import compile_cache as cc
    assert cc.enable_compile_cache(str(tmp_path)) == str(tmp_path)
    assert cc.compile_cache_info()["dir"] == str(tmp_path)
    assert os.listdir(str(tmp_path)) == []
    cc.atomic_write_bytes(str(tmp_path / "x.aot"), b"abc")
    assert cc.store_entries(str(tmp_path)) == ["x.aot"]
    assert cc.store_entries(str(tmp_path / "missing")) == []


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_graph_replay_equals_eager_walk_on_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs have no CPU stand-in "
                    "(the CPU walk is eager, test_aot_roundtrip_cold_"
                    "session_bit_equal)")
    import lightgbm_tpu_torch as lt
    rng = np.random.default_rng(10)
    X = _nan_matrix(rng, 3000, 6)
    y = (np.nan_to_num(X[:, 0]) + np.nan_to_num(X[:, 1]) > 0).astype(float)
    p = {"objective": "binary", "verbose": -1, "num_leaves": 31,
         "min_data_in_leaf": 5}
    path = str(tmp_path / "m.txt")
    lt.train(p, lt.Dataset(X, label=y, params=p), 20,
             device="cpu").save_model(path)
    sess = PredictorSession(path, max_batch=256, max_wait_ms=1.0,
                            config={"verbose": -1}, device="cuda")
    try:
        n = sess.warmup()
        assert sess.stats()["graph_captures"] == n == 9
        for b in sess.stats()["graph_buckets"]:
            bins = sess.space.bin_matrix(
                _nan_matrix(np.random.default_rng(b), b, 6))
            eager = sess._device_fn(sess.forest, torch.from_numpy(bins).to(
                "cuda")).cpu().numpy()
            assert np.array_equal(sess._graphs.run(b, bins), eager), b
        for m in (1, 3, 100, 256):
            sess.predict(X[:m])
        assert sess.stats()["graph_captures"] == n
    finally:
        sess.close()
