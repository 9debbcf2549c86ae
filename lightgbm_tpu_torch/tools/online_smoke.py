"""The online loop end to end on the port (counterpart of
tools/online_smoke.py): a base model served by the registry fleet over
HTTP, labeled drifting rows streamed through ``OnlineLoop``.

- **ingest -> refit -> swap**: the loop makes at least two refreshed
  versions, each pushed through ``POST /models/{name}/swap`` and each
  passing the canary gate;
- **no request lost**: concurrent ``POST /predict`` traffic runs through
  every swap; every answer is finite and names one model version;
- **the refreshed model moves**: its predictions differ from the base
  model's;
- **a poisoned refit changes nothing**: a candidate with NaN leaves is
  rejected by the canary gate's finite check (409), and the old version
  keeps serving.

The base model trains on ``--device`` (K1 on the card), the refits run
there, and the fleet serves there.  Nothing is written into the
repository: ``--out DIR`` adds an ``ONLINE_rN.json`` there.

    python -m lightgbm_tpu_torch.tools.online_smoke --json
    python -m lightgbm_tpu_torch.tools.online_smoke --device cpu --json
"""
from __future__ import annotations

import json
import os
import sys
import tempfile
import threading
import time
import urllib.error

import numpy as np

from ._verdict import (Verdict, device_parser, emit, get, k1_launches,
                       post, resolve_device, write_round)
from .fault_matrix import poison

# JAX check name -> (port check name or None, why); none differ
DEPARTURES: dict = {}


def _chunk(rng, n, drift):
    """Labeled rows whose boundary moves with ``drift``, so a refit over
    a fresh window must move the leaf values."""
    X = rng.normal(size=(n, 6))
    y = (X[:, 0] + drift * X[:, 1] - 0.3 * X[:, 2] > drift * 0.5)
    return X, y.astype(np.float64)


def run_smoke(device: str, quiet: bool = False) -> dict:
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.online import OnlineLoop
    from lightgbm_tpu_torch.serve import ModelRegistry, PredictServer

    v = Verdict("online", quiet=quiet)
    art = tempfile.mkdtemp(prefix="online_smoke_")
    rng = np.random.default_rng(12)
    k0 = k1_launches()

    P = {"objective": "binary", "num_leaves": 7, "min_data_in_leaf": 5,
         "verbose": -1, "tpu_serve_replicas": 1, "tpu_serve_max_batch": 128,
         "tpu_serve_rollback_watch_s": 0.0, "tpu_online_mode": "refit",
         "tpu_online_window": 1200, "tpu_online_refit_every": 600,
         "tpu_online_decay": 0.5, "device_type": device}
    cfg = Config.from_params(P)

    # ---- base model + fleet ----------------------------------------------
    X0, y0 = _chunk(rng, 800, drift=0.0)
    bst = lgb.train(P, lgb.Dataset(X0, label=y0, params=P),
                    num_boost_round=6, verbose_eval=False)
    base_path = os.path.join(art, "base.txt")
    bst.save_model(base_path)

    reg = ModelRegistry(config=cfg)
    reg.add_model("default", base_path)
    server = PredictServer(reg).start()
    url = server.url
    refresh_s, st = [], {"versions": 0, "rejected": 0, "rows_ingested": 0}
    try:
        v.check("base_deployed", get(url + "/models")[0] == 200)
        probe = X0[:16]
        base_pred = np.asarray(bst.predict(probe))

        # ---- concurrent traffic through every swap -----------------------
        results, stop = [], threading.Event()

        def traffic():
            while not stop.is_set():
                try:
                    code, body, _ = post(url + "/predict",
                                         {"rows": probe.tolist()},
                                         timeout=60)
                    results.append((code, body))
                except Exception as exc:  # noqa: BLE001
                    results.append((0, {"error": repr(exc)}))
                time.sleep(0.02)

        t = threading.Thread(target=traffic, daemon=True)
        t.start()

        # ---- the loop: a drifting stream -> >= 2 refreshed versions ------
        def push(model_path):
            code, body, _ = post(f"{url}/models/default/swap",
                                 {"model_file": model_path}, timeout=300)
            if code != 200 or not body.get("ok"):
                raise RuntimeError(f"swap bounced: {body}")
            return body

        loop = OnlineLoop(base_path, config=cfg, push=push,
                          workdir=os.path.join(art, "versions"),
                          params=dict(P))
        os.makedirs(loop.workdir, exist_ok=True)
        for drift in (0.6, 1.2, 1.8):
            Xc, yc = _chunk(rng, 600, drift=drift)
            loop.ingest(Xc, yc)
            rep = loop.tick()
            if rep and rep.get("ok"):
                refresh_s.append(rep["ms"] / 1e3)
        stop.set()
        t.join(timeout=10)

        st = loop.stats()
        v.check("refreshed_at_least_2", st["versions"] >= 2, st)
        _, models = get(url + "/models")
        live = next((m for m in models["models"]
                     if m["name"] == "default"), {})
        v.check("registry_live_advanced",
                (live.get("live_version") or 0) >= 3, live)
        bad = [r for r in results if r[0] != 200]
        v.check("zero_request_loss", len(bad) == 0 and len(results) > 0,
                f"{len(bad)}/{len(results)} failed: {bad[:2]}")
        vals = [np.asarray(b.get("predictions")) for c, b in results
                if c == 200]
        v.check("predictions_finite",
                all(np.isfinite(x).all() for x in vals))
        versions_seen = {b.get("version") for c, b in results if c == 200}
        v.check("versions_attributed", None not in versions_seen
                and len(versions_seen) >= 2, versions_seen)
        moved = (float(np.max(np.abs(np.asarray(vals[-1]) - base_pred)))
                 if vals else 0.0)
        v.check("fresh_model_moved", moved > 1e-6, f"max delta {moved}")

        # ---- a poisoned refit: the canary gate rejects it ----------------
        with open(loop.base) as fh:
            txt = fh.read()
        poisoned = os.path.join(art, "poisoned.txt")
        with open(poisoned, "w") as fh:
            fh.write(poison(txt))
        live_before = get(url + "/models")[1]["models"][0]["live_version"]
        try:
            code, _, _ = post(f"{url}/models/default/swap",
                              {"model_file": poisoned}, timeout=300)
            v.check("poisoned_rejected_409", False, f"swap answered {code}")
            v.fail_missing("poisoned_canary_finite_false")
        except urllib.error.HTTPError as exc:
            body = json.loads(exc.read())
            v.check("poisoned_rejected_409", exc.code == 409, body)
            rep = (body.get("report") or {}).get("checks") or {}
            v.check("poisoned_canary_finite_false",
                    rep.get("finite") is False or rep.get("gate") is False,
                    body)
        live_after = get(url + "/models")[1]["models"][0]["live_version"]
        v.check("old_version_still_serving", live_after == live_before,
                f"{live_before} -> {live_after}")
        code, body, _ = post(url + "/predict", {"rows": probe.tolist()})
        v.check("serving_after_poison", code == 200
                and np.isfinite(body["predictions"]).all())
    finally:
        server.stop(close_session=True)

    return v.record(
        device=device,
        online_refresh_s=(round(sum(refresh_s) / len(refresh_s), 3)
                          if refresh_s else None),
        online_swap_ok=st["versions"],
        online_swap_rejected=st["rejected"] + 1,  # and the poisoned push
        rows_ingested=st["rows_ingested"],
        k1_launches=k1_launches() - k0, artifacts_dir=art)


def main(argv=None) -> int:
    ap = device_parser("The online loop end to end on the port")
    ap.add_argument("--out", default="",
                    help="also write ONLINE_rN.json into this directory")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if device is None:
        return 2
    record = run_smoke(device)
    if args.out:
        write_round(record, args.out, "ONLINE")
    return emit(record, args.json)


if __name__ == "__main__":
    sys.exit(main())
