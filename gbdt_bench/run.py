r"""The benchmark of ``lightgbm_tpu_torch``: one run of one cell.

    python3 gbdt_bench/run.py --workload higgs.train --seed 7 \
        --seconds 30 --trace 0

Run from the root of a checkout on a machine with the cards the cell asks
for.  It makes the cell's rows from the seed, bins them, warms the booster
up, runs ``Booster.update()`` for ``--seconds``, then (``--trace 1``) a few
iterations under ``torch.profiler``, holds what the program produced
against the plain reference and prints one JSON line last on standard
output.  Without CUDA, or with fewer cards than the cell asks for, it
exits 2 and prints no result.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# the script's own folder would shadow top-level modules named like its
# files; the checkout's root holds both packages
sys.path[0] = str(ROOT)
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "nv_compute_cache")):
    os.environ[var] = str(ROOT / "build" / sub)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from gbdt_bench.harness import load_spec, run_cell
    spec = load_spec(args.workload)
    chips = int(spec["cell"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA card(s): is_available "
              f"{torch.cuda.is_available()}, device_count "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result, checks = run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), device="cuda",
                              t_start=T_START, spec=spec)
    for name, (value, limit) in checks.items():
        print(f"check {name}: {value!r} (limit {limit!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
