"""The profile-against-live drift report and the drift smoke on the port
(counterpart of tools/drift_report.py).

Report mode reads a model's ``.quality.json`` sidecar (``obs/drift.py``)
and prints the reference profile; with ``--stream`` (a JSONL file of
``{"x": [...]}`` rows, the online loop's stream format, labels ignored)
it replays the rows through a ``DriftSketch`` and prints per-feature PSI
and KS and the breaches of ``--psi-warn``.  Report mode reads files only
and runs on the host.

    python -m lightgbm_tpu_torch.tools.drift_report model.txt
    python -m lightgbm_tpu_torch.tools.drift_report model.txt \\
        --stream live.jsonl

``--smoke`` trains a small binary model on ``--device`` (K1 on the card;
the sidecar is written at save), serves it through a ``ModelRegistry``
there, and checks the plane:

- **clean traffic stays quiet**: an i.i.d. replay scores PSI below the
  warning threshold, no breach;
- **shifted traffic is flagged**: a seeded covariate shift passes
  ``tpu_drift_psi_warn`` within one forced check and latches the breach;
- **merge = oracle**: two sketches fed disjoint halves merge to the
  single sketch's counts exactly;
- **quality windows**: a label-flipped window drops the windowed AUC past
  ``tpu_quality_drop_warn``, and the breach reaches the registry's
  ``models()`` listing.

Nothing is written into the repository: ``--out DIR`` adds a
``DRIFT_rN.json`` there.

    python -m lightgbm_tpu_torch.tools.drift_report --smoke --json
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import tempfile

import numpy as np

from ._verdict import (Verdict, emit, k1_launches, resolve_device,
                       write_round)

# JAX check name -> (port check name or None, why); none differ
DEPARTURES: dict = {}


# ---------------------------------------------------------------------------
# report mode
# ---------------------------------------------------------------------------

def load_stream_rows(path: str) -> np.ndarray:
    """Rows of a JSONL stream (``{"x": [...]}``; ``"features"`` too);
    malformed lines are skipped, as ``online/loop.py`` skips them."""
    rows, bad = [], 0
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
                rows.append([float(x) for x in
                             rec.get("x", rec.get("features"))])
            except (ValueError, TypeError, AttributeError):
                bad += 1
    if bad:
        print(f"# skipped {bad} malformed stream line(s)")
    return np.asarray(rows, np.float64) if rows else np.zeros((0, 0))


def report(model_path: str, stream: str, psi_warn: float) -> int:
    from lightgbm_tpu_torch.obs.drift import (DriftSketch, QualityProfile,
                                              coarsen, ks, profile_path,
                                              psi)
    side = profile_path(model_path)
    if not os.path.isfile(side):
        print(f"# no profile sidecar at {side}: train with "
              f"tpu_quality_profile=true and save_model()")
        return 1
    prof = QualityProfile.load(side)
    meta = prof.meta
    print(f"# profile {side}")
    print(f"#   reference rows {meta.get('rows')}, "
          f"{meta.get('num_features')} feature(s), "
          f"train_auc {meta.get('train_auc')}")
    numeric = prof.numeric_records()
    if not stream:
        print(f"#   {len(numeric)} numerical feature record(s), "
              f"{len(prof.features) - len(numeric)} categorical "
              f"(not scored for drift)")
        for rec in numeric:
            c = np.asarray(rec["counts"], np.float64)
            top = int(np.argmax(c)) if c.size else -1
            print(f"    {rec['name']:<24} bins={rec['num_bin']:<4} "
                  f"mode_bin={top} nan_bin={rec['nan_bin']}")
        return 0
    X = load_stream_rows(stream)
    if not X.size:
        print("# the stream is empty: nothing to score")
        return 1
    sk = DriftSketch(prof)
    sk.observe_features(X)
    snap = sk.snapshot()
    print(f"# live stream {stream}: {snap['feat_rows']} row(s)")
    print(f"  {'feature':<24}{'psi':>10}{'ks':>10}  verdict")
    breaches = []
    for rec, live in zip(sk.records, snap["feat_counts"]):
        rc, lc = coarsen(rec["counts"], live)
        p, k = psi(rc, lc), ks(rc, lc)
        verdict = ("BREACH" if p > psi_warn
                   else "shift" if p > 0.1 else "ok")
        if p > psi_warn:
            breaches.append(rec["name"])
        print(f"  {rec['name']:<24}{p:>10.4f}{k:>10.4f}  {verdict}")
    if breaches:
        print(f"# {len(breaches)} feature(s) past psi_warn={psi_warn}: "
              + ", ".join(breaches))
    else:
        print(f"# no feature past psi_warn={psi_warn}")
    return 0


# ---------------------------------------------------------------------------
# smoke mode
# ---------------------------------------------------------------------------

def run_smoke(device: str, quiet: bool = False) -> dict:
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.obs.drift import (DriftSketch, QualityProfile,
                                              profile_path)
    from lightgbm_tpu_torch.serve import ModelRegistry
    from lightgbm_tpu_torch.serve.quality import QualityTracker

    v = Verdict("drift", quiet=quiet)
    art = tempfile.mkdtemp(prefix="drift_smoke_")
    rng = np.random.default_rng(16)
    # every cadence knob pinned, the flight dumps in the artifact dir
    pinned = {"LGBM_TPU_DRIFT_SAMPLE_RATE": "1.0",
              "LGBM_TPU_DRIFT_MIN_ROWS": "64", "LGBM_TPU_FLIGHT_DIR": art}
    saved = {k: os.environ.get(k) for k in pinned}
    os.environ.update(pinned)
    k0 = k1_launches()
    mon, psi_iid, psi_shifted, auc_delta = None, None, None, None
    reg = None
    try:
        P = {"objective": "binary", "num_leaves": 7, "min_data_in_leaf": 5,
             "verbose": -1, "tpu_serve_replicas": 1,
             "tpu_serve_max_batch": 256, "tpu_serve_rollback_watch_s": 0.0,
             "tpu_quality_window": 256, "tpu_quality_drop_warn": 0.05,
             "device_type": device}
        cfg = Config.from_params(P)
        Xt = rng.normal(size=(1200, 6))
        yt = (Xt[:, 0] + 0.6 * Xt[:, 1] - 0.3 * Xt[:, 2]
              > 0).astype(np.float64)
        bst = lgb.train(P, lgb.Dataset(Xt, label=yt, params=P),
                        num_boost_round=8, verbose_eval=False)
        model_path = os.path.join(art, "model.txt")
        bst.save_model(model_path)
        side = profile_path(model_path)
        v.check("profile_sidecar_written", os.path.isfile(side), side)
        prof = QualityProfile.load(side)
        v.check("profile_has_reference",
                prof.meta.get("rows") == 1200
                and len(prof.numeric_records()) == 6
                and prof.meta.get("train_auc") is not None, prof.meta)

        reg = ModelRegistry(config=cfg)
        reg.add_model("default", model_path)
        router = reg.resolve(None).router
        mon = getattr(router, "drift", None)
        v.check("monitor_armed", mon is not None)
        if mon is None:
            return v.record(device=device, artifacts_dir=art)

        # ---- clean traffic stays quiet -----------------------------------
        for _ in range(4):
            router.predict(rng.normal(size=(128, 6)))
        iid = mon.maybe_check(force=True)
        v.check("clean_traffic_quiet",
                iid is not None and iid["psi_max"] <= mon.psi_warn
                and not mon.breach,
                iid and {k: iid[k] for k in ("psi_max", "pred_psi")})
        psi_iid = iid["psi_max"] if iid else None

        # ---- a seeded covariate shift is flagged -------------------------
        for _ in range(4):
            router.predict(rng.normal(size=(128, 6)) * 2.5 + 1.5)
        shifted = mon.maybe_check(force=True)
        v.check("shifted_traffic_flagged",
                shifted is not None and shifted["psi_max"] > mon.psi_warn,
                shifted and {k: shifted[k] for k in ("psi_max",
                                                     "pred_psi")})
        v.check("breach_latched", mon.breach is not None
                and "feature_psi" in (mon.breach or {}).get("kinds", ()),
                mon.breach)
        psi_shifted = shifted["psi_max"] if shifted else None

        # ---- the merge across replicas equals the single sketch ----------
        Xm = rng.normal(size=(512, 6)) * 1.7 - 0.4
        oracle, a, b = (DriftSketch(prof), DriftSketch(prof),
                        DriftSketch(prof))
        oracle.observe_features(Xm)
        oracle.observe_preds(np.arange(512, dtype=np.float64) / 512)
        a.observe_features(Xm[:200])
        a.observe_preds(np.arange(200, dtype=np.float64) / 512)
        b.observe_features(Xm[200:])
        b.observe_preds(np.arange(200, 512, dtype=np.float64) / 512)
        a.merge(b)
        sa, so = a.snapshot(), oracle.snapshot()
        v.check("sketch_merge_bit_exact",
                sa["feat_rows"] == so["feat_rows"]
                and sa["pred_rows"] == so["pred_rows"]
                and all(np.array_equal(x, z) for x, z in
                        zip(sa["feat_counts"], so["feat_counts"]))
                and np.array_equal(sa["pred_counts"], so["pred_counts"]))

        # ---- quality window: flipped labels -> breach -> registry --------
        tracker = QualityTracker(
            lambda X: router.predict(X, raw_score=True), prof, config=cfg,
            registry=reg, model_name="default")
        Xq = rng.normal(size=(256, 6))
        yq = (Xq[:, 0] + 0.6 * Xq[:, 1] - 0.3 * Xq[:, 2] > 0)
        tracker.add(Xq, 1.0 - yq.astype(np.float64))   # flipped labels
        v.check("quality_breach_detected", tracker.breaches >= 1,
                tracker.stats())
        listing = {m["name"]: m for m in reg.models()}
        qb = listing.get("default", {}).get("quality_breach")
        v.check("registry_annotated", qb is not None
                and qb.get("auc_delta") is not None, qb)
        auc_delta = (qb or {}).get("auc_delta")
        dumps = glob.glob(os.path.join(art, "FLIGHT_r*.json"))
        v.check("breach_flight_dump", len(dumps) >= 1, art)
    finally:
        if reg is not None:
            reg.close()
        for k, val in saved.items():
            if val is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = val
    return v.record(device=device, drift_psi_max=psi_shifted,
                    drift_psi_iid=psi_iid, quality_auc_delta=auc_delta,
                    drift_breaches=mon.breach_count if mon else None,
                    k1_launches=k1_launches() - k0, artifacts_dir=art)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="The drift report / the drift smoke on the port")
    ap.add_argument("model", nargs="?", default="",
                    help="model file (its .quality.json sidecar is read)")
    ap.add_argument("--stream", default="",
                    help='JSONL file of {"x": [...]} rows to score '
                         "against the profile")
    ap.add_argument("--psi-warn", type=float, default=0.25,
                    help="breach threshold of the report (default 0.25)")
    ap.add_argument("--smoke", action="store_true",
                    help="run the end-to-end drift smoke")
    ap.add_argument("--json", action="store_true",
                    help="(smoke) print the verdict as one JSON line")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="(smoke) where to train and serve (default cuda)")
    ap.add_argument("--out", default="",
                    help="(smoke) also write DRIFT_rN.json into this "
                         "directory")
    args = ap.parse_args(argv)
    if not args.smoke:
        if not args.model:
            ap.error("a model path is required (or --smoke)")
        return report(args.model, args.stream, args.psi_warn)
    device = resolve_device(args.device)
    if device is None:
        return 2
    record = run_smoke(device)
    if args.out:
        write_round(record, args.out, "DRIFT")
    return emit(record, args.json)


if __name__ == "__main__":
    sys.exit(main())
