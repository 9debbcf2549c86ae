"""The multi-tenant forest arena (``lightgbm_tpu_torch/serve/arena.py``,
``core/forest.py arena_predict_fn``) on the CPU, on JAX-trained model
files (the tenants of tests/test_arena.py: NaN-heavy binary, multiclass
with a categorical column, dense binary, of different widths):

- ``arena_predict_fn`` over a mixed-tenant batch equals each tenant's own
  ``forest_predict_fn`` walk bit for bit, and the JAX package's arena
  walk within 1e-6;
- one arena equals one solo ``PredictorSession`` per tenant bit for bit
  (converted, raw, sync and async), and the JAX package's arena within
  1e-6;
- mixed-tenant submits share device batches; an impossible byte budget
  evicts, and the evicted tenant is re-admitted transparently;
- no host fallback: an injected ``serve_arena_device`` fault fails the
  batch; an injected ``serve_arena_swap`` fault leaves the old trees;
- concurrent mixed-tenant HTTP traffic with a hot swap of one tenant:
  nothing lost, every answer one version's bits;
- on the card (``cuda``): the arena against solo sessions, bit-equal.
"""
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.core.forest import arena_predict_fn, forest_predict_fn
from lightgbm_tpu_torch.robust import faults
from lightgbm_tpu_torch.serve import (DeviceFailed, ForestArena,
                                      ModelRegistry, PredictorSession,
                                      PredictServer)
from lightgbm_tpu_torch.serve.packing import ServeBinSpace

TIMEOUT = 60


@pytest.fixture(autouse=True)
def _disarm():
    faults.disarm()
    yield
    faults.disarm()


def _nan_matrix(rng, n, f_num, f_cat=0, cat_lo=-1, cat_hi=15):
    X = rng.normal(size=(n, f_num))
    X[rng.random((n, f_num)) < 0.08] = np.nan
    if f_cat:
        X = np.hstack([X, rng.integers(cat_lo, cat_hi, size=(n, f_cat)
                                       ).astype(np.float64)])
    return X


def _tenant_data():
    """(name, X, y, params, rounds, categorical, probe rows) of the three
    tenants, drawn from numpy seeds."""
    rng = np.random.default_rng(10)
    Xb = _nan_matrix(rng, 600, 6)
    yb = (np.nan_to_num(Xb[:, 0]) + np.nan_to_num(Xb[:, 1]) > 0
          ).astype(np.float64)
    Xm = _nan_matrix(rng, 600, 3, f_cat=1, cat_lo=0, cat_hi=12)
    ym = ((np.nan_to_num(Xm[:, 0]) > 0).astype(int)
          + (Xm[:, 3] > 5).astype(int)).astype(np.float64)
    Xd = rng.normal(size=(600, 4))
    yd = (Xd[:, 0] - 0.5 * Xd[:, 2] > 0).astype(np.float64)
    probe = np.random.default_rng(11)
    return [
        ("nan_bin", Xb, yb, {"objective": "binary"}, 10, None,
         _nan_matrix(probe, 160, 6)),
        ("mc_cat", Xm, ym, {"objective": "multiclass", "num_class": 3}, 8,
         [3], _nan_matrix(probe, 160, 3, f_cat=1, cat_lo=-2, cat_hi=20)),
        ("dense", Xd, yd, {"objective": "binary", "num_leaves": 7}, 12,
         None, probe.normal(size=(160, 4))),
    ]


def _params(extra):
    return dict({"verbose": -1, "num_leaves": 15, "min_data_in_leaf": 5},
                **extra)


@pytest.fixture(scope="module")
def tenant_models(tmp_path_factory):
    """(name, model file, probe rows) of the three JAX-trained tenants."""
    pytest.importorskip("jax")
    import lightgbm_tpu as jlgb
    d = tmp_path_factory.mktemp("tarena")
    out = []
    for name, X, y, extra, rounds, cat, probe in _tenant_data():
        p = _params(extra)
        ds = jlgb.Dataset(X, label=y, params=p,
                          **({"categorical_feature": cat} if cat else {}))
        path = str(d / f"{name}.txt")
        jlgb.train(p, ds, num_boost_round=rounds).save_model(path)
        out.append((name, path, probe))
    return out


def _arena(**kw):
    return ForestArena(device="cpu", **{"max_batch": 64, "max_wait_ms": 1.0,
                                         **kw})


def _solo(path, device="cpu", max_batch=64):
    return PredictorSession(path, max_batch=max_batch, max_wait_ms=1.0,
                            device=device)


# ---------------------------------------------------------------------------
# the arena walk itself
# ---------------------------------------------------------------------------

def test_arena_predict_fn_bit_equal_to_per_model_walks(tenant_models):
    """A mixed-tenant batch through ``arena_predict_fn`` gives each row
    exactly its own model's ``forest_predict_fn`` walk (each model in its
    own bin space), and the JAX package's arena walk within 1e-6."""
    import jax.numpy as jnp
    import lightgbm_tpu as jlgb
    from lightgbm_tpu.core.forest import arena_predict_fn as jarena_fn
    from lightgbm_tpu.serve.packing import ServeBinSpace as JSpace
    (n1, p1, X1), _, (n3, p3, X3) = tenant_models
    g1 = lt.Booster(model_file=p1, device="cpu")._gbdt
    g3 = lt.Booster(model_file=p3, device="cpu")._gbdt
    trees = list(g1.models) + list(g3.models)
    mids = np.r_[np.zeros(len(g1.models)), np.ones(len(g3.models))]
    F = max(g1.num_features, g3.num_features)
    space = ServeBinSpace(trees, F, "cpu")
    forest = space.pack(trees, np.zeros(len(trees), np.int32),
                        model_ids=mids.astype(np.int32))
    assert forest.model_id.tolist() == mids.astype(int).tolist()
    # rows of both tenants interleaved, plus pad rows of no tenant (-1)
    n = 80
    Xw = np.zeros((2 * n + 5, F))
    row_model = np.full(len(Xw), -1, np.int32)
    Xw[:n, :X1.shape[1]], row_model[:n] = X1[:n], 0
    Xw[n:2 * n, :X3.shape[1]], row_model[n:2 * n] = X3[:n], 1
    perm = np.random.default_rng(0).permutation(len(Xw))
    Xw, row_model = Xw[perm], row_model[perm]
    got = arena_predict_fn(space.meta, 1)(
        forest, torch.from_numpy(space.bin_matrix(Xw)),
        torch.from_numpy(row_model)).numpy()
    for g, mid in ((g1, 0), (g3, 1)):
        rows = np.nonzero(row_model == mid)[0]
        own = ServeBinSpace(g.models, g.num_features, "cpu")
        solo = forest_predict_fn(own.meta, 1)(
            own.pack(g.models, np.zeros(len(g.models), np.int32)),
            torch.from_numpy(own.bin_matrix(
                Xw[rows, :g.num_features]))).numpy()
        assert np.array_equal(got[rows], solo), mid
    assert not got[row_model < 0].any()        # pad rows score zero
    # the JAX package's arena walk on the same pack
    j1 = jlgb.Booster(model_file=p1)._gbdt
    j3 = jlgb.Booster(model_file=p3)._gbdt
    jtrees = list(j1.models) + list(j3.models)
    jspace = JSpace(jtrees, F)
    jforest = jspace.pack(jtrees, np.zeros(len(jtrees), np.int32),
                          model_ids=mids.astype(np.int32))
    want = np.asarray(jarena_fn(jspace.meta, 1)(
        jforest, jnp.asarray(jspace.bin_matrix(Xw)), jnp.asarray(row_model)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# the arena engine
# ---------------------------------------------------------------------------

def test_arena_bit_identical_to_solo_sessions(tenant_models):
    arena = _arena()
    try:
        for name, path, _ in tenant_models:
            arena.admit(name, path)
        for name, path, Xt in tenant_models:
            with _solo(path) as solo:
                assert np.array_equal(arena.predict(Xt, model=name),
                                      solo.predict(Xt)), name
                assert np.array_equal(
                    arena.predict(Xt, model=name, raw_score=True),
                    solo.predict(Xt, raw_score=True)), name
                t = arena.submit(Xt[:48], model=name)
                assert np.array_equal(arena.result(t, timeout=TIMEOUT),
                                      solo.predict(Xt[:48])), name
        st = arena.stats()
        assert st["tenants"] == 3 and st["resident"] == 3
        assert st["packed_bytes"] > 0 and st["failed"] == 0
    finally:
        arena.close()


def test_arena_matches_jax_arena(tenant_models):
    from lightgbm_tpu.serve import ForestArena as JArena
    arena, jarena = _arena(), JArena(max_batch=64, max_wait_ms=1.0)
    try:
        for name, path, _ in tenant_models:
            arena.admit(name, path)
            jarena.admit(name, path)
        for name, _, Xt in tenant_models:
            np.testing.assert_allclose(arena.predict(Xt, model=name),
                                       jarena.predict(Xt, model=name),
                                       rtol=0, atol=1e-6)
        st, jst = arena.stats(), jarena.stats()
        for key in ("tenants", "resident", "generation", "repacks"):
            assert st[key] == jst[key], key
    finally:
        arena.close()
        jarena.close()


def test_arena_cross_model_coalescing(tenant_models):
    arena = _arena(max_batch=128, max_wait_ms=5.0)
    refs = {name: _solo(path, max_batch=128)
            for name, path, _ in tenant_models}
    try:
        for name, path, _ in tenant_models:
            arena.admit(name, path)
        tickets = []
        for r in range(10):
            for name, _, Xt in tenant_models:
                chunk = Xt[r * 3:r * 3 + 3]
                tickets.append((name, chunk, arena.submit(chunk,
                                                          model=name)))
        for name, chunk, t in tickets:
            assert np.array_equal(arena.result(t, timeout=TIMEOUT),
                                  refs[name].predict(chunk)), name
        st = arena.stats()
        # 30 tiny submits shared device batches through the model-id lane
        assert st["cross_model_batches"] >= 1
        assert st["batches"] < len(tickets)
    finally:
        for s in refs.values():
            s.close()
        arena.close()


def test_arena_eviction_and_transparent_readmission(tenant_models):
    (n1, p1, X1), (n2, p2, X2), _ = tenant_models
    arena = _arena(budget_bytes=1)
    try:
        arena.admit(n1, p1)
        arena.admit(n2, p2)          # a 1-byte budget: LRU n1 evicted
        st = arena.stats()
        assert st["evictions"] >= 1 and st["resident"] == 1
        assert arena.has(n1)         # still known, just not resident
        out = arena.predict(X1, model=n1)   # transparent re-admission
        assert arena.stats()["readmissions"] >= 1
        with _solo(p1) as solo:
            assert np.array_equal(out, solo.predict(X1))
        # queued requests of both tenants under the budget: each tenant
        # re-admitted in turn, every answer its solo session's bits
        t1 = arena.submit(X1[:5], model=n1)
        t2 = arena.submit(X2[:5], model=n2)
        got1 = arena.result(t1, timeout=TIMEOUT)
        got2 = arena.result(t2, timeout=TIMEOUT)
        with _solo(p1) as s1, _solo(p2) as s2:
            assert np.array_equal(got1, s1.predict(X1[:5]))
            assert np.array_equal(got2, s2.predict(X2[:5]))
        assert arena.tenants()[0]["name"] == n2   # rows sorted by name
    finally:
        arena.close()


def test_arena_device_and_swap_faults(tenant_models):
    """A failed arena launch fails its batch (nothing from the host); an
    injected swap fault leaves the old trees serving."""
    (n1, p1, X1), _, _ = tenant_models
    arena = _arena()
    try:
        arena.admit(n1, p1)
        faults.configure("serve_arena_device:raise@n=1")
        t = arena.submit(X1[:4], model=n1)
        with pytest.raises(DeviceFailed, match="injected fault"):
            arena.result(t, timeout=TIMEOUT)
        assert arena.stats()["failed"] == 1
        faults.configure("serve_arena_swap:raise@n=1")
        with pytest.raises(RuntimeError, match="injected fault"):
            arena.swap(n1, p1)
        faults.disarm()
        with _solo(p1) as solo:
            assert np.array_equal(arena.predict(X1, model=n1),
                                  solo.predict(X1))
        assert arena.tenants()[0]["version"] == 1
    finally:
        arena.close()


# ---------------------------------------------------------------------------
# HTTP: concurrent mixed-tenant traffic and a hot swap of one tenant
# ---------------------------------------------------------------------------

def _post(url, body):
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_arena_http_mixed_tenants_hot_swap(tenant_models, tmp_path):
    import lightgbm_tpu as jlgb
    (n1, p1, X1), (n2, p2, X2), _ = tenant_models
    # the swap target: a retrained variant of tenant t1 on its columns
    rng = np.random.default_rng(12)
    Xr = _nan_matrix(rng, 500, 6)
    yr = (np.nan_to_num(Xr[:, 1]) > 0).astype(np.float64)
    p = _params({"objective": "binary", "num_leaves": 7})
    v2 = str(tmp_path / "t1_v2.txt")
    jlgb.train(p, jlgb.Dataset(Xr, label=yr, params=p),
               num_boost_round=9).save_model(v2)

    reg = ModelRegistry(n_replicas=1, max_batch=64, max_wait_ms=1.0,
                        device="cpu")
    reg.add_model("main", p2)
    arena = _arena()
    arena.admit("t1", p1)
    arena.admit("t2", p2)
    reg.attach_arena(arena)
    probe1, probe2 = X1[:8], X2[:8]
    with _solo(p1) as s:
        ref1_old = s.predict(probe1)
    with _solo(v2) as s:
        ref1_new = s.predict(probe1)
    with _solo(p2) as s:
        ref2 = s.predict(probe2)

    server = PredictServer(reg).start()
    u = server.url
    errors, off_refs = [], []
    stop = threading.Event()
    lock = threading.Lock()

    def client(tenant, probe, refs):
        while not stop.is_set():
            s, body = _post(u + "/predict",
                            {"rows": probe.tolist(), "model": tenant})
            with lock:
                if s != 200 or body.get("arena") is not True:
                    errors.append((tenant, s, body))
                    continue
                got = np.asarray(body["predictions"])
                # one version's bits, never a blend
                if not any(np.array_equal(got, r) for r in refs):
                    off_refs.append(tenant)

    threads = [
        threading.Thread(target=client, args=("t1", probe1,
                                              [ref1_old, ref1_new]),
                         daemon=True),
        threading.Thread(target=client, args=("t2", probe2, [ref2]),
                         daemon=True),
        threading.Thread(target=client, args=("t2", probe2, [ref2]),
                         daemon=True),
    ]
    try:
        for t in threads:
            t.start()
        s, body = _post(u + "/models/t1/swap", {"model_file": v2})
        assert s == 200 and body.get("to_version") == 2, (s, body)
        stop.set()
        for t in threads:
            t.join(TIMEOUT)
        assert not errors, errors[:3]
        assert not off_refs, off_refs[:3]
        s, body = _post(u + "/predict", {"rows": probe1.tolist(),
                                         "model": "t1"})
        assert s == 200
        assert np.array_equal(np.asarray(body["predictions"]), ref1_new)
        s, body = _post(u + "/predict", {"rows": probe2.tolist(),
                                         "model": "t2"})
        assert np.array_equal(np.asarray(body["predictions"]), ref2)
        with urllib.request.urlopen(u + "/models", timeout=TIMEOUT) as r:
            listing = json.loads(r.read())
        assert [t["name"] for t in listing["arena"]["tenants"]] == [
            "t1", "t2"]
        with urllib.request.urlopen(u + "/metrics", timeout=TIMEOUT) as r:
            assert "tpu_serve_arena_resident 2" in r.read().decode()
    finally:
        stop.set()
        server.stop(close_session=True)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_arena_bit_identical_to_solo_sessions_on_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the arena's card walk has no CPU "
                    "stand-in (the CPU case is "
                    "test_arena_bit_identical_to_solo_sessions)")
    arena = ForestArena(max_batch=64, max_wait_ms=1.0, device="cuda")
    tenants = []
    try:
        for name, X, y, extra, rounds, cat, probe in _tenant_data():
            p = _params(extra)
            ds = lt.Dataset(X, label=y, params=p,
                            **({"categorical_feature": cat} if cat else {}))
            path = str(tmp_path / f"{name}.txt")
            lt.train(p, ds, rounds, device="cpu").save_model(path)
            arena.admit(name, path)
            tenants.append((name, path, probe))
        for name, path, Xt in tenants:
            with _solo(path, device="cuda") as solo:
                assert np.array_equal(arena.predict(Xt, model=name),
                                      solo.predict(Xt)), name
                t = arena.submit(Xt[:48], model=name)
                assert np.array_equal(arena.result(t, timeout=TIMEOUT),
                                      solo.predict(Xt[:48])), name
    finally:
        arena.close()
