r"""Readings that the comparison's limits are set from, at a cell's own
size, several seeds in one process (never part of a benchmark run):

    python3 gbdt_bench/calibrate.py --workload higgs.train --seeds 5,6,7 \
        --variants sound:20,bf16:1,half_rows:1,altered_leaf:1

A variant is ``sound`` (the cell as it runs), a histogram precision of
the program's own (``bf16``, the control: one step below the
configuration's 2xbf16; ``highest``, float32, a witness) or a fault or
a departure of ``faults.py``, each with its window in seconds.  One JSON line
per run: the variant, the seed, ``correct`` and each number compared.
"""
import argparse
import json
import sys
import time
from pathlib import Path

sys.path[0] = str(Path(__file__).resolve().parent.parent)

PRECISIONS = ("bf16", "highest")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--variants", default="sound:20,bf16:1")
    args = ap.parse_args(argv)
    import torch
    from gbdt_bench import faults
    from gbdt_bench.harness import load_spec, run_cell
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    spec = load_spec(args.workload)
    for item in args.variants.split(","):
        variant, seconds = item.split(":")
        for seed in (int(s) for s in args.seeds.split(",")):
            kw = {}
            if variant in PRECISIONS:
                kw["params"] = {"tpu_hist_dtype": variant}
            elif variant in faults.DEPARTURES:
                kw["params"] = faults.DEPARTURES[variant]
            elif variant != "sound":
                kw["fault"] = faults.FAULTS[variant]
            t0 = time.perf_counter()
            detail = []
            result, checks = run_cell(args.workload, seed, float(seconds),
                                      False, device="cuda", spec=spec,
                                      detail=detail, **kw)
            print(json.dumps({
                "calibration": args.workload, "variant": variant,
                "seed": seed, "correct": result["correct"],
                "numbers": {k: v for k, (v, _) in checks.items()},
                "metrics": {k: m["value"]
                            for k, m in result["metrics"].items()},
                "worst_leaves": detail,
                "wall_s": time.perf_counter() - t0}), flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
