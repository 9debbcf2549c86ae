"""Time K1 (float and int modes) and K2 from several copies of the package
on the same inputs, each checked against the plain version.

Each directory argument holds a ``lightgbm_tpu_torch`` package (``.`` is
this checkout), for instance the parent commit's copy or one whose
``csrc/*.cu`` carries one experimental edit; each copy builds its own
kernels into its own ``build/``.  For each case below, the copies run in
turns v1 .. vn vn .. v1 (two medians of 25 CUDA-event timings each,
wrapper included, as ``chip_smoke.py`` times a kernel) and print their
times and how far each is from the plain version.  ``--only`` picks the
groups (default all):

* ``float``: K1 2xbf16 fused at 1,000,000 x 28 x 256: the main check
  cases (63 packed / 42 triple slots, uniform and skewed bins) and the
  small-slot waves the shared-memory form takes (one or two slots with
  every row, half of them or a third of them in a slot); largest g/h
  difference and whether the counts are equal;
* ``int``: K1 int16 fused at the same shape: 63 packed / 42 triple slots,
  skewed bins at 63 and at 1 slot, the root wave, and S = 2 / 3 on either
  side of the shared-memory form's limit; int8 at 63 slots; equal or not;
* ``k2``: K2 at 1,000,000 x 28 x 256 x C=128, bins uniform and with 90%
  of every feature's rows in one bin; largest difference.

    python3 lightgbm_tpu_torch/tools/k1_variants.py build/ab/old .
    python3 lightgbm_tpu_torch/tools/k1_variants.py --only int,k2 build/ab/old .
"""
from __future__ import annotations

import importlib
import os
import sys

ROOT = os.path.realpath(os.path.join(os.path.dirname(__file__), "..", ".."))
# (name, mode, rows, slots, packed, skewed bins, share of rows in a slot or
# None for wave_inputs' own leaf ids, about half)
FLOAT_CASES = [("main63", "2xbf16", 1_000_000, 63, True, False, None),
               ("triple42", "2xbf16", 1_000_000, 42, False, False, None),
               ("skew63", "2xbf16", 1_000_000, 63, True, True, None),
               ("skew1", "2xbf16", 1_000_000, 1, True, True, None),
               ("root1", "2xbf16", 1_000_000, 1, True, False, 1.0),
               ("half1", "2xbf16", 1_000_000, 1, True, False, None),
               ("half2", "2xbf16", 1_000_000, 2, True, False, None),
               ("third2", "2xbf16", 1_000_000, 2, True, False, 0.33)]
INT_CASES = [("int16 main63", "int16", 1_000_000, 63, True, False, None),
             ("int16 triple42", "int16", 1_000_000, 42, False, False, None),
             ("int16 skew63", "int16", 1_000_000, 63, True, True, None),
             ("int16 skew1", "int16", 1_000_000, 1, True, True, None),
             ("int16 root1", "int16", 1_000_000, 1, True, False, 1.0),
             ("int16 half2", "int16", 1_000_000, 2, True, False, None),
             ("int16 half3", "int16", 1_000_000, 3, True, False, None),
             ("int8 main63", "int8", 1_000_000, 63, True, False, None)]
# (name, rows, features, bins, channels, skewed bins)
K2_CASES = [("k2 C=128", 1_000_000, 28, 256, 128, False),
            ("k2 C=128 skew", 1_000_000, 28, 256, 128, True)]
GROUPS = ("float", "int", "k2")


def load(dirs):
    """(hist_wave, hist_channels) from each package copy, built."""
    mods = {}
    for v in dirs:
        for m in [k for k in sys.modules if k.startswith("lightgbm_tpu_torch")]:
            del sys.modules[m]
        path = os.path.realpath(v)
        sys.path.insert(0, path)
        hw = importlib.import_module("lightgbm_tpu_torch.ops.hist_wave")
        hc = importlib.import_module("lightgbm_tpu_torch.ops.hist_channels")
        sys.path.pop(0)
        for mod in (hw, hc):
            if not os.path.realpath(mod.__file__).startswith(path):
                raise RuntimeError(f"{v}: imported {mod.__file__}")
        hw._build.load()
        mods[v] = (hw, hc)
    return mods


def k1_case(cs, mods, order, case):
    """One K1 case: times and agreement with the plain version by copy."""
    import torch
    name, mode, N, S, packed, skew, live = case
    bins, gv, hv, cv, leaf, slot, parent = cs.wave_inputs(
        N, 28, 256, S, True, mode, packed, 7, None, skew)
    if live is not None:
        pend = slot[0::2 if packed else 3][:S]
        other = leaf.max() + 1 + torch.arange(S, device=leaf.device,
                                              dtype=leaf.dtype)
        pick = torch.randint(0, S, (N,), device=leaf.device)
        keep = torch.rand(N, device=leaf.device) < live
        leaf = torch.where(keep, pend[pick].to(leaf.dtype),
                           other[pick]).contiguous()
    args = (bins, gv, hv, cv, leaf, slot, 256)
    kw = dict(highest=mode, packed=packed, parent=parent)
    want = cs.flat(mods[order[0]][0].hist_wave_plain(*args, **kw))
    res = {}
    for v in order:
        def run(hw=mods[v][0]):
            return hw.hist_wave(*args, **kw, num_slots=S)
        got = cs.flat(run())
        if mode in ("int16", "int8"):
            agree = all(torch.equal(a, b) for a, b in zip(got, want))
            res[v + " equal"] = agree
        else:
            err = max(float((a - b).abs().max()) for a, b in zip(got, want))
            counts_equal = (torch.equal(got[1], want[1]) if packed else
                            torch.equal(got[0][..., 2::3], want[0][..., 2::3]))
            res[v + " err, counts equal"] = (round(err, 5), counts_equal)
        res.setdefault(v, []).append(round(cs.cuda_ms(run), 4))
    print(name, res, flush=True)


def k2_case(cs, mods, order, case):
    """One K2 case: times and largest difference from the plain version."""
    import torch
    name, N, F, B, C, skew = case
    g = torch.Generator(device="cuda").manual_seed(11)
    bins = torch.randint(0, B, (F, N), generator=g, device="cuda",
                         dtype=torch.int32)
    if skew:
        hot = torch.rand((F, N), generator=g, device="cuda") < 0.9
        hot_bin = torch.arange(F, device="cuda", dtype=torch.int32)[:, None]
        bins = torch.where(hot, hot_bin * 37 % B, bins)
    bins = bins.to(torch.uint8)
    gh = torch.randn((N, C), generator=g, device="cuda")
    want = mods[order[0]][1].hist_channels_plain(bins, gh, B)
    res = {}
    for v in order:
        def run(hc=mods[v][1]):
            return hc.hist_channels(bins, gh, B)
        res[v + " err"] = round(float((run() - want).abs().max()), 5)
        res.setdefault(v, []).append(round(cs.cuda_ms(run), 4))
    print(name, res, flush=True)


def main(argv) -> int:
    groups = GROUPS
    if argv[:1] == ["--only"]:
        groups, argv = tuple(argv[1].split(",")), argv[2:]
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    mods = load(argv)
    order = list(mods) + list(mods)[::-1]
    print(cs.card_line(), flush=True)
    for case in (FLOAT_CASES if "float" in groups else []) + \
            (INT_CASES if "int" in groups else []):
        k1_case(cs, mods, order, case)
    for case in K2_CASES if "k2" in groups else []:
        k2_case(cs, mods, order, case)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
