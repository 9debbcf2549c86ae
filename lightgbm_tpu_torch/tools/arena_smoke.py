"""The serving store and the arena on the port (counterpart of
tools/arena_smoke.py).

- **store round trip**: a warmed session writes its pack to the serving
  store; a second session in the same process loads it and serves the
  whole bucket sweep bit-identically.  No CUDA graph is captured on the
  request path after warm-up (``serve/graph_captures``): the port's
  counterpart of the JAX "compile-count delta 0".
- **arena parity**: binary-with-NaN, multiclass and categorical tenants
  packed into one ``ForestArena`` answer bit-identically to dedicated
  sessions, in raw and converted scores.
- **cross-model batches**: interleaved small submits for several tenants
  share device batches.
- **eviction and re-admission**: a byte budget that fits nothing evicts
  the least recently used tenant; its next request re-admits it with the
  same answers.

The tenants are trained on ``--device`` (K1 on the card) and served
there.

    python -m lightgbm_tpu_torch.tools.arena_smoke --json
    python -m lightgbm_tpu_torch.tools.arena_smoke --device cpu --json
"""
from __future__ import annotations

import sys
import tempfile

import numpy as np

from ._verdict import (Verdict, device_parser, emit, k1_launches,
                       resolve_device)

# JAX check name -> (port check name or None, why; the ROADMAP.md line)
DEPARTURES = {
    "aot.roundtrip_zero_compiles": (
        "aot.roundtrip_zero_graph_captures",
        "a CUDA graph cannot be written to disk; the store holds the pack, "
        "each process captures one graph a bucket at warm-up, and "
        "serve/graph_captures on the request path is the counterpart of "
        "the JAX compile-count delta (ROADMAP.md 3.10, item 9)"),
}

SWEEP = (1, 2, 4, 8, 16, 32, 64)


def _train(device, params, X, y, rounds=6, cat=None):
    import lightgbm_tpu_torch as lgb
    p = dict({"verbose": -1, "num_leaves": 7, "min_data_in_leaf": 5,
              "device_type": device}, **params)
    ds = lgb.Dataset(X, label=y, params=p,
                     **({"categorical_feature": cat} if cat else {}))
    return lgb.train(p, ds, num_boost_round=rounds)


def build_fixtures(device: str):
    """Three tenants over the binning surface: NaN-heavy binary,
    multiclass and categorical."""
    rng = np.random.default_rng(7)
    Xb = rng.normal(size=(400, 5))
    Xb[rng.random(Xb.shape) < 0.08] = np.nan
    yb = (np.nan_to_num(Xb[:, 0]) > 0).astype(np.float64)
    b_bin = _train(device, {"objective": "binary"}, Xb, yb)
    Xm = rng.normal(size=(400, 4))
    ym = np.digitize(Xm[:, 0], [-0.5, 0.5]).astype(np.float64)
    b_mc = _train(device, {"objective": "multiclass", "num_class": 3},
                  Xm, ym)
    Xc = np.hstack([rng.normal(size=(400, 3)),
                    rng.integers(0, 12, size=(400, 1)).astype(np.float64)])
    yc = ((Xc[:, 0] + 0.3 * (Xc[:, 3] % 4)) > 0).astype(np.float64)
    b_cat = _train(device, {"objective": "binary"}, Xc, yc, cat=[3])
    return (b_bin, Xb), (b_mc, Xm), (b_cat, Xc)


def aot_roundtrip(v, fixtures, device):
    """Write -> load -> serve, with no graph captured on the request
    path."""
    from lightgbm_tpu_torch import obs
    from lightgbm_tpu_torch.serve import PredictorSession
    (b_bin, Xb) = fixtures[0]
    with tempfile.TemporaryDirectory(prefix="arena_smoke_aot_") as d:
        cfg = {"verbose": -1, "tpu_serve_aot_dir": d, "device_type": device}
        warm = PredictorSession(b_bin, max_batch=64, max_wait_ms=1.0,
                                config=cfg)
        warm.warmup()
        want = {n: warm.predict(Xb[:n]) for n in SWEEP}
        saved = (warm.stats().get("aot") or {}).get("saved", 0)
        warm.close()
        v.check("aot.exported", saved >= 1, f"saved={saved}")

        cold = PredictorSession(b_bin, max_batch=64, max_wait_ms=1.0,
                                config=cfg)
        cold.warmup()
        c0 = obs.counter_value("serve/graph_captures")
        got = {n: cold.predict(Xb[:n]) for n in SWEEP}
        delta = obs.counter_value("serve/graph_captures") - c0
        st = cold.stats()
        cold.close()
        aot = st.get("aot") or {}
        v.check("aot.roundtrip_zero_graph_captures",
                delta == 0 and aot.get("status") == "hit"
                and len(st.get("buckets") or []) >= len(SWEEP),
                f"{delta} captures, store {aot.get('status')}, "
                f"buckets={st.get('buckets')}")
        v.check("aot.roundtrip_bit_identical",
                all(np.array_equal(want[n], got[n]) for n in want))


def arena_parity(v, fixtures, device):
    from lightgbm_tpu_torch.serve import ForestArena, PredictorSession
    arena = ForestArena(max_batch=64, max_wait_ms=1.0, device=device)
    names = ("bin", "mc", "cat")
    try:
        for name, (bst, _) in zip(names, fixtures):
            arena.admit(name, bst)
        for name, (bst, X) in zip(names, fixtures):
            probe = X[:48]
            with PredictorSession(bst, max_batch=64, max_wait_ms=1.0,
                                  device=device) as solo:
                v.check(f"arena.parity_{name}",
                        np.array_equal(arena.predict(probe, model=name),
                                       solo.predict(probe))
                        and np.array_equal(
                            arena.predict(probe, model=name,
                                          raw_score=True),
                            solo.predict(probe, raw_score=True)))
        # interleaved async submits for all three tenants inside one
        # batching window share dispatches
        tickets = []
        for r in range(8):
            for name, (_, X) in zip(names, fixtures):
                tickets.append(arena.submit(X[r * 2:r * 2 + 2], model=name))
        for t in tickets:
            arena.result(t, timeout=60.0)
        st = arena.stats()
        v.check("arena.cross_model_coalesced",
                st["cross_model_batches"] >= 1
                and st["batches"] < len(tickets), st)
    finally:
        arena.close()


def eviction_readmission(v, fixtures, device):
    from lightgbm_tpu_torch.serve import ForestArena, PredictorSession
    (b_bin, Xb), (b_mc, _), _ = fixtures
    arena = ForestArena(budget_bytes=1, max_batch=64, max_wait_ms=1.0,
                        device=device)
    try:
        arena.admit("a", b_bin)
        arena.admit("b", b_mc)      # a 1-byte budget: the LRU 'a' goes
        st = arena.stats()
        v.check("arena.budget_evicts",
                st["evictions"] >= 1 and st["resident"] == 1, st)
        out = arena.predict(Xb[:32], model="a")   # re-admits 'a'
        st2 = arena.stats()
        with PredictorSession(b_bin, max_batch=64, max_wait_ms=1.0,
                              device=device) as solo:
            v.check("arena.readmit_bit_identical",
                    st2["readmissions"] >= 1
                    and np.array_equal(out, solo.predict(Xb[:32])), st2)
    finally:
        arena.close()


def run_smoke(device: str, quiet: bool = False) -> dict:
    v = Verdict("arena_smoke", quiet=quiet)
    k0 = k1_launches()
    fixtures = build_fixtures(device)
    k_train = k1_launches() - k0
    aot_roundtrip(v, fixtures, device)
    arena_parity(v, fixtures, device)
    eviction_readmission(v, fixtures, device)
    return v.record(device=device, k1_launches=k_train)


def main(argv=None) -> int:
    ap = device_parser("The serving store and the arena on the port")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if device is None:
        return 2
    return emit(run_smoke(device), args.json)


if __name__ == "__main__":
    sys.exit(main())
