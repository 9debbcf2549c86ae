"""Time the main path (seconds per boosting iteration) of several copies
of the package on one card, in turns.

Each directory argument holds a ``lightgbm_tpu_torch`` package (``.`` is
this checkout), for instance the parent commit's copy unpacked with
``git archive``.  The copies run in turns v1 .. vn vn .. v1, each turn a
fresh process: the headline data of ``chip_smoke.py`` (1,000,000 x 28,
HIGGS-shaped, seed 0), binned once, then ``train`` of 5 rounds at 255
leaves (the main path's parameters) ``--reps`` times; a turn prints the
median of ``GBDT.iter_seconds`` after the first iteration of each
training and the trees' digest (the model text before its parameters).
Every number beside the card's name and power limit.

    git archive <parent> lightgbm_tpu_torch | tar -x -C ab_parent
    python3 lightgbm_tpu_torch/tools/ab_main_path.py ab_parent .
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.realpath(os.path.join(os.path.dirname(__file__), "..", ".."))

_TURN = """
import hashlib, json, sys
import numpy as np
sys.path.insert(0, {pkg!r})
sys.path.insert(1, {root!r})
import lightgbm_tpu_torch as lt
from chip_smoke import higgs_like
assert lt.__file__.startswith({pkg!r}), lt.__file__
X, y = higgs_like(1_000_000)
params = {{"objective": "binary", "num_leaves": 255, "learning_rate": 0.1,
           "max_bin": 255, "min_data_in_leaf": 100, "verbose": -1}}
ds = lt.Dataset(X, label=y, params=params, free_raw_data=False).construct()
out = []
for _ in range({reps}):
    bst = lt.train(params, ds, num_boost_round=5, device="cuda")
    text = bst.model_to_string().split("\\nparameters:")[0]
    out.append({{"s_per_iter": float(np.median(bst._gbdt.iter_seconds[1:])),
                 "iter_seconds": bst._gbdt.iter_seconds,
                 "trees": hashlib.sha256(text.encode()).hexdigest()[:16]}})
print("AB " + json.dumps(out))
"""


def turn(pkg: str, reps: int) -> list:
    res = subprocess.run(
        [sys.executable, "-c", _TURN.format(pkg=os.path.realpath(pkg),
                                            root=ROOT, reps=reps)],
        capture_output=True, text=True, cwd=os.path.realpath(pkg))
    if res.returncode != 0:
        raise RuntimeError(f"{pkg}: {res.stderr[-3000:]}")
    line = [ln for ln in res.stdout.splitlines() if ln.startswith("AB ")]
    return json.loads(line[-1][3:])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("copies", nargs="+")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    order = list(args.copies) + list(reversed(args.copies))
    for pkg in order:
        runs = turn(pkg, args.reps)
        print(json.dumps({"copy": pkg, "s_per_iter":
                          [round(r["s_per_iter"], 6) for r in runs],
                          "trees": sorted({r["trees"] for r in runs}),
                          "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
