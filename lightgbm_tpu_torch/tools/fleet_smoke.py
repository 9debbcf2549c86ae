"""The elastic-fleet smoke on the port (counterpart of
tools/fleet_smoke.py): real 3-process training fleets over the host TCP
transport, each held against the never-failed single-process CLI run.

- **plain / bagging / ranking bit-exact**: a 3-rank fleet grows the
  trees of the single process on a plain regression fixture, a bagging
  binary fixture and a lambdarank fixture with a ``.query`` sidecar
  (query-aligned row shards);
- **healthy path is quiet**: the plain run's event trail has no death,
  resize or stall stamp;
- **kill-one-rank recovery**: a rank killed mid-iteration
  (``fleet_die``) is detected, the survivors roll back to the last
  common checkpoint and resume, the healed joiner folds in, and the model
  still equals the never-failed run's.

Each rank trains on ``--device`` (K1 on the card); the record carries
the ranks' K1 launches (``rank<N>.stats.json``).  The rest of the fleet's
faults are ``fault_matrix --legs fleet``.

    python -m lightgbm_tpu_torch.tools.fleet_smoke --json
    python -m lightgbm_tpu_torch.tools.fleet_smoke --device cpu --json
"""
from __future__ import annotations

import glob
import json
import os
import sys
import tempfile

import numpy as np

from ._verdict import (Verdict, device_parser, emit, resolve_device,
                       tree_text)
from .fault_matrix import CliOracle, fleet_events, launch

# JAX check name -> (port check name or None, why); none differ
DEPARTURES: dict = {}

RANKS = 3


def write_fixtures(art: str) -> dict:
    """Plain regression, bagging binary, and lambdarank with a ``.query``
    sidecar (the query-aligned shard path)."""
    rng = np.random.default_rng(3)
    X = rng.normal(size=(120, 5))
    y = X[:, 0] * 2.0 + np.sin(X[:, 1]) + rng.normal(scale=0.1, size=120)
    plain = os.path.join(art, "plain.tsv")
    np.savetxt(plain, np.column_stack([y, X]), delimiter="\t", fmt="%.8f")
    yb = (X[:, 0] + 0.4 * X[:, 1] > 0).astype(np.float64)
    bag = os.path.join(art, "bag.tsv")
    np.savetxt(bag, np.column_stack([yb, X]), delimiter="\t", fmt="%.8f")
    qsizes = rng.integers(5, 12, size=14)
    n = int(qsizes.sum())
    Xr = rng.normal(size=(n, 5))
    yr = rng.integers(0, 4, size=n).astype(np.float64)
    rank = os.path.join(art, "rank.tsv")
    np.savetxt(rank, np.column_stack([yr, Xr]), delimiter="\t", fmt="%.8f")
    np.savetxt(rank + ".query", qsizes, fmt="%d")
    return {"plain": plain, "bag": bag, "rank": rank}


def rank_k1_launches(fleet_dir: str) -> int:
    """K1 launches summed over the ranks' ``rank<N>.stats.json``."""
    n = 0
    for path in glob.glob(os.path.join(fleet_dir, "rank*.stats.json")):
        with open(path) as fh:
            n += int(json.load(fh).get("k1_launches") or 0)
    return n


def run_smoke(device: str, quiet: bool = False) -> dict:
    v = Verdict("fleet", quiet=quiet)
    art = tempfile.mkdtemp(prefix="fleet_smoke_")
    data = write_fixtures(art)
    recoveries, k1 = 0, 0

    def fleet_params(tag, data_path, **extra):
        p = {"task": "train", "objective": "regression",
             "data": data_path, "label_column": "0",
             "num_iterations": "10", "num_leaves": "7",
             "min_data_in_leaf": "5", "learning_rate": "0.1",
             "tpu_ingest": "true", "verbosity": "-1",
             "tpu_fleet": str(RANKS), "tpu_fleet_heartbeat_s": "15",
             "tpu_fleet_transport": "host", "device_type": device,
             "tpu_fleet_dir": os.path.join(art, f"fd_{tag}"),
             "output_model": os.path.join(art, f"{tag}.txt")}
        p.update({k: str(val) for k, val in extra.items()})
        return p

    def bitmatch_leg(tag, p, per_rank_env=None):
        nonlocal k1
        oracle = CliOracle(p, os.path.join(art, f"oracle_{tag}.txt"))
        res = launch(p, per_rank_env=per_rank_env)
        k1 += rank_k1_launches(p["tpu_fleet_dir"])
        with open(p["output_model"]) as fh:
            got = tree_text(fh.read())
        return res, res["rc"] == 0 and got == oracle.trees()

    # ---- plain regression: bit-exact and a quiet event trail ------------
    p = fleet_params("plain", data["plain"])
    try:
        res, exact = bitmatch_leg("plain", p)
        v.check("fleet.plain.bit_exact", res["ok"] and exact, res)
        noisy = [e for e in fleet_events(p["tpu_fleet_dir"])
                 if e["name"] in ("member_dead", "resize", "fleet_stall")]
        v.check("fleet.plain.healthy_path_quiet", not noisy, noisy)
    except Exception as exc:  # noqa: BLE001
        v.check("fleet.plain.bit_exact", False, repr(exc))
        v.fail_missing("fleet.plain.healthy_path_quiet")

    # ---- bagging: the seeded row subsampling replays identically --------
    p = fleet_params("bag", data["bag"], objective="binary",
                     bagging_fraction="0.8", bagging_freq="2", seed="7")
    try:
        res, exact = bitmatch_leg("bag", p)
        v.check("fleet.bagging.bit_exact", res["ok"] and exact, res)
    except Exception as exc:  # noqa: BLE001
        v.check("fleet.bagging.bit_exact", False, repr(exc))

    # ---- lambdarank: .query sidecar -> query-aligned shards -------------
    p = fleet_params("rank", data["rank"], objective="lambdarank")
    try:
        res, exact = bitmatch_leg("rank", p)
        v.check("fleet.ranking.bit_exact", res["ok"] and exact, res)
    except Exception as exc:  # noqa: BLE001
        v.check("fleet.ranking.bit_exact", False, repr(exc))

    # ---- kill one rank mid-iteration: detect, roll back, heal, finish ---
    p = fleet_params("kill", data["plain"], num_iterations="12",
                     tpu_fleet_heartbeat_s="3", tpu_checkpoint_freq="4")
    try:
        res, exact = bitmatch_leg("kill", p, per_rank_env={
            1: {"LGBM_TPU_FAULTS": "fleet_die:raise@iter=6"}})
        ev = [e["name"] for e in fleet_events(p["tpu_fleet_dir"])]
        recoveries = res["heals"]
        v.check("fleet.kill.recovers_and_completes",
                res["ok"] and res["rcs"].get(1) == 137
                and "member_dead" in ev and "resize" in ev, res)
        v.check("fleet.kill.bit_exact_vs_never_failed", exact)
    except Exception as exc:  # noqa: BLE001
        v.check("fleet.kill.recovers_and_completes", False, repr(exc))
        v.fail_missing("fleet.kill.bit_exact_vs_never_failed")

    return v.record(device=device, fleet_ranks=RANKS,
                    fleet_recoveries=int(recoveries), k1_launches=k1,
                    artifacts_dir=art)


def main(argv=None) -> int:
    ap = device_parser("The 3-process elastic-fleet smoke on the port")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if device is None:
        return 2
    return emit(run_smoke(device), args.json)


if __name__ == "__main__":
    sys.exit(main())
