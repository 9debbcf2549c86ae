"""Time K1's float path from several copies of the package on the same
inputs, each checked against the plain version.

Each argument names a directory holding a ``lightgbm_tpu_torch`` package
(``.`` is this checkout), for instance a copy whose ``csrc/hist_wave.cu``
carries one experimental edit; each copy builds its own kernels into its
own ``build/``.  For each wave shape below, the copies run in turns v1 ..
vn vn .. v1 (two medians of 25 CUDA-event timings each, wrapper
included, as ``chip_smoke.py`` times a kernel) and print their times, the
largest g/h difference from the plain version and whether the counts are
equal.  The shapes are the 2xbf16 fused ones at 1,000,000 x 28 x 256:
the main check cases (63 packed / 42 triple slots, uniform and skewed
bins) and the small-slot waves the shared-memory form takes (one or two
slots with every row, half of them or a third of them in a slot).

    python3 lightgbm_tpu_torch/tools/k1_variants.py build/old .
"""
from __future__ import annotations

import importlib
import os
import sys

ROOT = os.path.realpath(os.path.join(os.path.dirname(__file__), "..", ".."))
# (name, rows, slots, packed, skewed bins, share of rows in a slot or None
# for wave_inputs' own leaf ids, about half)
CASES = [("main63", 1_000_000, 63, True, False, None),
         ("triple42", 1_000_000, 42, False, False, None),
         ("skew63", 1_000_000, 63, True, True, None),
         ("skew1", 1_000_000, 1, True, True, None),
         ("root1", 1_000_000, 1, True, False, 1.0),
         ("half1", 1_000_000, 1, True, False, None),
         ("half2", 1_000_000, 2, True, False, None),
         ("third2", 1_000_000, 2, True, False, 0.33)]


def load(dirs):
    """hist_wave from each package copy, built."""
    mods = {}
    for v in dirs:
        for m in [k for k in sys.modules if k.startswith("lightgbm_tpu_torch")]:
            del sys.modules[m]
        path = os.path.realpath(v)
        sys.path.insert(0, path)
        mod = importlib.import_module("lightgbm_tpu_torch.ops.hist_wave")
        sys.path.pop(0)
        if not os.path.realpath(mod.__file__).startswith(path):
            raise RuntimeError(f"{v}: imported {mod.__file__}")
        mod._build.load()
        mods[v] = mod
    return mods


def main(argv) -> int:
    import torch
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    mods = load(argv)
    order = list(mods) + list(mods)[::-1]
    for name, N, S, packed, skew, live in CASES:
        bins, gv, hv, cv, leaf, slot, parent = cs.wave_inputs(
            N, 28, 256, S, True, "2xbf16", packed, 7, None, skew)
        if live is not None:
            pend = slot[0::2][:S]
            other = leaf.max() + 1 + torch.arange(S, device=leaf.device,
                                                  dtype=leaf.dtype)
            pick = torch.randint(0, S, (N,), device=leaf.device)
            keep = torch.rand(N, device=leaf.device) < live
            leaf = torch.where(keep, pend[pick].to(leaf.dtype),
                               other[pick]).contiguous()
        args = (bins, gv, hv, cv, leaf, slot, 256)
        kw = dict(highest="2xbf16", packed=packed, parent=parent)
        want = cs.flat(mods[order[0]].hist_wave_plain(*args, **kw))
        res = {}
        for v in order:
            def run(hw=mods[v]):
                return hw.hist_wave(*args, **kw, num_slots=S)
            got = cs.flat(run())
            err = max(float((a - b).abs().max()) for a, b in zip(got, want))
            counts_equal = (torch.equal(got[1], want[1]) if packed else
                            torch.equal(got[0][..., 2::3], want[0][..., 2::3]))
            res.setdefault(v, []).append(round(cs.cuda_ms(run), 4))
            res[v + " err, counts equal"] = (round(err, 5), counts_equal)
        print(name, res, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
