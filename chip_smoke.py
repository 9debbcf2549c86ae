"""Drive the PyTorch port (lightgbm_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits nonzero:

1. set-up: the card's name and power limit, and the build of every kernel
   from ``lightgbm_tpu_torch/csrc`` into ``build/`` (one nvcc per source,
   all started together; timed); the SASS census of atomic, reduction and
   warp-match instructions by kernel;
2. kernels vs plain: each kernel against its plain PyTorch version on the
   same inputs, times by CUDA events (median of 25), bounds from these
   inputs:
   - K1 (``ops/hist_wave.hist_wave``) packed and fused in 2xbf16 and in
     int16 at the main path's shape (1,000,000 rows x 28 features x 256
     bins, 63 leaves), and 2xbf16 unfused at a ragged shape (3,001 x 5 x
     64, 7 leaves); int8 on the ragged shape; the triple layout (42
     leaves) in 2xbf16 and int16, fused and unfused; a ragged int16 case
     and a 2xbf16 one whose leaf ids lie past the kernel's 4,096-entry slot
     table.  Bins are drawn over all of [0, B).  Then 2xbf16 fused at the
     main shape on skewed bins (half the features take 2 bins, the rest
     put 90% of their rows in one): packed at 63 leaves and at 1 (a root
     wave), triple at 42.  Float modes: counts exact and g/h within the
     f32 bound below; int modes: ``torch.equal``;
   - K2 (``ops/hist_channels.hist_channels``) at 1,000,000 x 28 x 256 with
     C=128 and at 3,001 x 5 x 64 with C=256, within the f32 bound;
3. small-input reference: 3 rounds on 20,000 rows trained on the card and
   on the CPU (plain kernels) must agree, in 2xbf16 and in int16 with
   bagging;
4. main path: ``lightgbm_tpu_torch.train`` on the 1,000,000 x 28
   HIGGS-shaped data (the headline configuration of bench.py, generated
   from seed 0), 5 rounds, 255 leaves; K1 must have launched at least
   once per wave; train logloss must fall every round and AUC exceed 0.7;
   one more iteration under torch.profiler gives the device's busy time by
   kernel and its idle share;
5. quantized main path (bench.py's BENCH_QUANT=int16 leg): the same data
   and Dataset, ``tpu_hist_dtype=int16``, 5 rounds; K1 at least once per
   wave, logloss falling every round, final train AUC within 1e-3 of
   phase 4's; one profiled iteration;
6. the triple layout's path: the wave grower with ``packed=False`` (42
   leaves a wave) grows one int16 tree on phase 5's next inputs, identical
   to the packed grower's at the same capacity; and K2's path:
   ``hist_channels_fm`` builds the root histogram of the same inputs,
   whose per-feature sums must be the totals;
7. int8 with ``bagging_fraction=0.8, bagging_freq=1``, 5 rounds: K1 at
   least once per wave, final train AUC within 1e-2 of phase 4's;
8. predict 10,000 rows and write the model text of phase 4's booster.

Every path (each training phase, the triple grower, K2's path) sets all
launch counts to 0 just before it and reads them just after; K1 counts
its launches in all and by layout.  Prints a ``{"kernels": [...]}`` line
(``launches`` from each kernel's path, ``training_path_launches`` over the
three training phases, ``check_launches`` from phase 2, ``skewed`` the
skewed-bin cases' times and errors) and, last, the device line
``{"ok": true, "device": {...}}``.  Imports no jax and nothing of
lightgbm_tpu.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
F32_OPS_PER_S = 67e12            # same sheet, f32 outside the tensor cores
REPS = 25
# f32 sums of the same values in another order: per cell the difference
# is bounded by a few ulps of the sum of magnitudes in that cell
REL_TOL = 1e-5
# ... for a cell of up to this many rows.  The rounding of an f32 sum of n
# terms grows as sqrt(n) (the plain version's own included), so a cell of
# n rows more is held to sqrt(n / ROWS_AT_REL_TOL) times REL_TOL: ~11
# standard deviations of the difference of two summation orders at any n
ROWS_AT_REL_TOL = 1000
DEV = "cuda"
MAIN_ROWS = 1_000_000            # the headline configuration's rows


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else "nvidia-smi unavailable"


def higgs_like(rows: int, seed: int = 0):
    """bench.py's synthetic HIGGS-shaped binary data (28 features)."""
    rng = np.random.default_rng(seed)
    n_informative = 8
    X = rng.normal(size=(rows, 28)).astype(np.float32)
    w = rng.normal(size=n_informative)
    logit = X[:, :n_informative] @ w + 0.5 * X[:, 0] * X[:, 1]
    y = (logit + rng.logistic(size=rows) > 0).astype(np.float64)
    return X.astype(np.float64), y


def cuda_ms(fn, reps: int = REPS) -> float:
    """Median milliseconds of ``fn`` by CUDA events, after one warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def kernel_name(symbol: str) -> str:
    """The unqualified name of a mangled kernel symbol
    (``_ZN12_GLOBAL__N_120hist_wave_float_rowsE...`` ->
    ``hist_wave_float_rows``); other strings pass through."""
    if not symbol.startswith("_Z"):
        return symbol
    i = 3 if symbol.startswith("_ZN") else 2
    name = symbol
    while i < len(symbol) and symbol[i].isdigit():
        j = i
        while symbol[j].isdigit():
            j += 1
        n = int(symbol[i:j])
        name, i = symbol[j:j + n], j + n
    return name


def sass_census(lib) -> dict:
    """Per kernel of the built library, the count of each atomic,
    reduction and warp-match opcode in its SASS (``cuobjdump`` from the
    CUDA toolkit): shared-memory atomics (ATOMS.*), global atomics and
    reductions (ATOMG.*, ATOM.*, RED.*, REDG.*) and MATCH.*.  Shows
    whether an add compiled to one instruction or to a compare-and-swap
    loop, and which instruction a global reduction became."""
    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "cuobjdump")
    try:
        out = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                             text=True, timeout=120).stdout
    except OSError as err:
        return {"cuobjdump": f"unavailable ({err})"}
    census, fn = {}, "?"
    for line in out.splitlines():
        if "Function :" in line:
            fn = kernel_name(line.split("Function :")[1].strip())
            continue
        for tok in line.split():
            if tok.startswith(("ATOMS.", "ATOMG.", "ATOM.", "RED.", "REDG.",
                               "MATCH.")):
                ops = census.setdefault(fn, {})
                ops[tok] = ops.get(tok, 0) + 1
    return census


def sass_atomics(census: dict) -> dict:
    """Count of each shared-memory atomic opcode (ATOMS.*) over every
    kernel of ``sass_census``'s result."""
    if "cuobjdump" in census:
        return census
    counts = {}
    for ops in census.values():
        for op, n in ops.items():
            if op.startswith("ATOMS."):
                counts[op] = counts.get(op, 0) + n
    return counts


def bound(n_bytes: float, n_ops: float) -> dict:
    """The least time the card could take: bytes over the memory rate or
    operations over the f32 rate, whichever is larger."""
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / F32_OPS_PER_S * 1e3
    return dict(bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                bytes=int(n_bytes), ops=int(n_ops))


def flat(x):
    """The tensors of a kernel result, in order."""
    import torch
    if isinstance(x, torch.Tensor):
        return [x]
    return [t for part in x for t in flat(part)]


def wave_inputs(N, F, B, leaves, fused, mode, packed, seed, leaf_hi=None,
                skew=False):
    """Random K1 inputs as the wave grower forms them: bins over [0, B),
    g/h/count vectors (stochastic-rounded integers under a bag mask in the
    int modes), leaf ids over 2*leaves ids drawn from [0, leaf_hi) of which
    the first half are pending, the layout's slot map and, fused, a parent
    histogram in that layout.  ``skew``: the first half of the features
    take two bins (0 and B-1), the rest put 90% of their rows in one bin
    and spread the others over [0, B)."""
    import torch
    from lightgbm_tpu_torch.ops.quant import QUANT_MODES, QUANT_QMAX
    g = torch.Generator(device=DEV).manual_seed(seed)
    dev = DEV
    bins = torch.randint(0, B, (F, N), generator=g, device=dev,
                         dtype=torch.int32)
    if skew:
        half = F // 2
        bins[:half] = torch.randint(0, 2, (half, N), generator=g, device=dev,
                                    dtype=torch.int32) * (B - 1)
        hot = torch.rand((F - half, N), generator=g, device=dev) < 0.9
        hot_bin = torch.arange(half, F, device=dev,
                               dtype=torch.int32)[:, None] * 37 % B
        bins[half:] = torch.where(hot, hot_bin, bins[half:])
    bins = bins.to(torch.uint8)
    if mode in QUANT_MODES:
        q = int(QUANT_QMAX[mode])
        cv = (torch.rand(N, generator=g, device=dev) < 0.9).float()
        gv = torch.randint(-q, q + 1, (N,), generator=g, device=dev).float() * cv
        hv = torch.randint(0, q + 1, (N,), generator=g, device=dev).float() * cv
    else:
        cv = torch.ones(N, device=dev)
        gv = torch.randn(N, generator=g, device=dev)
        hv = torch.rand(N, generator=g, device=dev) * 0.25
    ids = torch.randperm(leaf_hi or 2 * leaves, generator=g,
                         device=dev)[:2 * leaves]
    leaf = ids[torch.randint(0, 2 * leaves, (N,), generator=g, device=dev)]
    leaf = leaf.int()
    lanes = 2 if packed else 3
    slot = torch.full((128,), -1, dtype=torch.int32, device=dev)
    slot[:lanes * leaves] = ids[:leaves].repeat_interleave(lanes).int()
    parent = None
    if fused:
        pg = torch.randn((F, B, 128), generator=g, device=dev) * 100
        pc = torch.randint(0, 1000, (F, B, 128), generator=g,
                           device=dev).float()
        if mode in QUANT_MODES:
            pg = pg.round()
        parent = (pg, pc) if packed else pg
    return bins, gv, hv, cv, leaf, slot, parent


def check_kernel(hw, N, F, B, leaves, fused, mode, seed, packed=True,
                 leaf_hi=None, skew=False):
    """K1 against its plain version on one shape; returns the numbers of
    the kernels line."""
    import torch
    from lightgbm_tpu_torch.ops.quant import QUANT_MODES
    quant = mode in QUANT_MODES
    bins, gv, hv, cv, leaf, slot, parent = wave_inputs(
        N, F, B, leaves, fused, mode, packed, seed, leaf_hi, skew)
    args = (bins, gv, hv, cv, leaf, slot, B)
    kw = dict(highest=mode, packed=packed, parent=parent)
    got = flat(hw.hist_wave(*args, **kw, num_slots=leaves))
    want = flat(hw.hist_wave_plain(*args, **kw))
    torch.cuda.synchronize()
    tag = (f"K1 {mode} {'packed' if packed else 'triple'} "
           f"{'fused' if fused else 'unfused'} N={N} F={F} B={B}"
           f"{f' S={leaves} skewed bins' if skew else ''}")
    max_err = 0.0
    if quant:
        for g_t, w_t in zip(got, want):
            if not torch.equal(g_t, w_t):
                raise AssertionError(f"{tag}: kernel != plain version")
    else:
        mag = flat(hw.hist_wave_plain(bins, gv.abs(), hv.abs(), cv, leaf,
                                      slot, B, highest=mode, packed=packed))
        # rows in each lane's cell (every row weighs 1 here): its count lane
        lane = torch.arange(128, device=DEV)
        rows = want[1][..., lane // 2] if packed else \
            want[0][..., (lane // 3 * 3 + 2).clamp(max=127)]
        scale = (rows / ROWS_AT_REL_TOL).sqrt().clamp(min=1.0)
        for i, (g_t, w_t) in enumerate(zip(got, want)):
            counts = ([(g_t, w_t)] if packed and i % 2 == 1 else
                      [] if packed else [(g_t[..., 2::3], w_t[..., 2::3])])
            for g_c, w_c in counts:
                if not torch.equal(g_c, w_c):
                    raise AssertionError(f"{tag}: counts differ")
            err = (g_t - w_t).abs()
            lim = REL_TOL * mag[i % len(mag)] * scale + 1e-6
            if fused:
                lim = lim + REL_TOL * w_t.abs()
            if not bool((err <= lim).all()):
                raise AssertionError(f"{tag}: g/h differ beyond the f32 "
                                     f"bound: max err {float(err.max())}")
            max_err = max(max_err, float(err.max()))

    saved = (hw.hist_wave.launches, dict(hw.hist_wave.layout_launches))
    ms = cuda_ms(lambda: hw.hist_wave(*args, **kw, num_slots=leaves))
    plain_ms = cuda_ms(lambda: hw.hist_wave_plain(*args, **kw))
    # timing launches do not count
    hw.hist_wave.launches = saved[0]
    hw.hist_wave.layout_launches.update(saved[1])

    # library yardstick: one index_add_ over the flattened (f, b, slot)
    # index of the rows in a pending slot, values as K1 accumulates them
    lanes = 2 if packed else 3
    pend = slot[0:lanes * leaves:lanes].long()
    r, s = torch.nonzero(leaf.long()[:, None] == pend[None, :],
                         as_tuple=True)
    flat_idx = ((torch.arange(F, device=DEV)[:, None] * B
                 + bins[:, r].long()) * leaves + s[None, :]).reshape(-1)
    if quant:
        src = torch.stack([gv[r], hv[r], cv[r]], 1).long()
    else:
        src = torch.stack([hw.round_values(gv[r], mode),
                           hw.round_values(hv[r], mode), cv[r]], 1)
    src = src[None].expand(F, -1, -1).reshape(-1, 3).contiguous()
    out = torch.zeros((F * B * leaves, 3), dtype=src.dtype, device=DEV)
    library_ms = cuda_ms(lambda: out.index_add_(0, flat_idx, src))

    hist_bytes = F * B * 128 * 4
    n_hist = (2 if packed else 1) * (3 if fused else 1)
    n_bytes = F * N + (8 if quant else 16) * N + 128 * 4 + n_hist * hist_bytes
    # adds these inputs need: g, h and count for every (feature, row in a
    # pending slot), and the sibling subtraction per histogram cell
    n_ops = 3 * F * int(r.numel()) + (n_hist // 3 * F * B * 128
                                      if fused else 0)
    res = dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
               library_ms=library_ms, **bound(n_bytes, n_ops))
    return tag, res


def check_channels(hc, N, F, B, C, seed):
    """K2 against its plain version on one shape; the library yardstick is
    one ``index_add_`` over the flattened (feature, bin) index with its
    expanded [F*N, C] source built outside the timed region."""
    import torch
    g = torch.Generator(device=DEV).manual_seed(seed)
    bins = torch.randint(0, B, (F, N), generator=g, device=DEV,
                         dtype=torch.int32).to(torch.uint8)
    gh = torch.randn((N, C), generator=g, device=DEV)
    got = hc.hist_channels(bins, gh, B)
    want = hc.hist_channels_plain(bins, gh, B)
    mag = hc.hist_channels_plain(bins, gh.abs(), B)
    torch.cuda.synchronize()
    tag = f"K2 N={N} F={F} B={B} C={C}"
    err = (got - want).abs()
    if not bool((err <= REL_TOL * mag + 1e-6).all()):
        raise AssertionError(f"{tag}: beyond the f32 bound: max err "
                             f"{float(err.max())}")
    launches0 = hc.hist_channels.launches
    ms = cuda_ms(lambda: hc.hist_channels(bins, gh, B))
    plain_ms = cuda_ms(lambda: hc.hist_channels_plain(bins, gh, B))
    hc.hist_channels.launches = launches0
    del mag, want
    flat_idx = (torch.arange(F, device=DEV)[:, None] * B
                + bins.long()).reshape(-1)
    src = gh[None].expand(F, -1, -1).reshape(F * N, C)
    out = torch.zeros((F * B, C), device=DEV)
    library_ms = cuda_ms(lambda: out.index_add_(0, flat_idx, src))
    del src, flat_idx, out
    torch.cuda.empty_cache()
    n_bytes = F * N + 4 * N * C + 4 * F * B * C
    n_ops = F * N * C                       # every bin here is < B
    res = dict(max_abs_err=float(err.max()), ms=ms, plain_ms=plain_ms,
               library_ms=library_ms, **bound(n_bytes, n_ops))
    return tag, res


def small_reference(lt):
    """3 rounds on 20,000 rows: the card (kernels) against the CPU (plain
    versions), in 2xbf16 and in int16 with bagging."""
    X, y = higgs_like(20_000, seed=1)
    base = {"objective": "binary", "num_leaves": 31, "max_bin": 255,
            "min_data_in_leaf": 100, "verbose": -1,
            "metric": ["binary_logloss", "auc"]}
    for extra in ({}, {"tpu_hist_dtype": "int16", "bagging_fraction": 0.8,
                       "bagging_freq": 1}):
        params = {**base, **extra}
        res = {}
        for dev in (DEV, "cpu"):
            ev = {}
            ds = lt.Dataset(X, label=y)
            bst = lt.train(params, ds, 3, valid_sets=[ds],
                           valid_names=["train"], evals_result=ev, device=dev)
            res[dev] = (bst, ev["train"])
        same = sum(
            np.array_equal(a.split_feature, b.split_feature)
            and np.array_equal(a.threshold, b.threshold)
            for a, b in zip(res[DEV][0]._gbdt.models,
                            res["cpu"][0]._gbdt.models))
        d_loss = abs(res[DEV][1]["binary_logloss"][-1]
                     - res["cpu"][1]["binary_logloss"][-1])
        d_auc = abs(res[DEV][1]["auc"][-1] - res["cpu"][1]["auc"][-1])
        print(f"small reference {extra or '2xbf16'}: {same}/3 trees "
              f"identical card vs CPU, |d logloss| {d_loss:.3g}, |d auc| "
              f"{d_auc:.3g}", flush=True)
        if d_loss > 1e-3 or d_auc > 1e-3:
            raise AssertionError("card and CPU training disagree on the "
                                 "small input")


def profile_iteration(bst, iter_ms, kind, card):
    """One more boosting iteration under torch.profiler: where the
    iteration's time goes on the card (the phase's counts are read before
    this).  The profiler slows the host side many times over, so the idle
    share is taken against ``iter_ms``, the median unprofiled iteration.
    Returns (device busy ms, K1 ms, idle share)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        bst.update()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "device_time_total",
                         getattr(ev, "cuda_time_total", 0.0))
        if dev_us > 0 and ev.key and not ev.key.startswith(
                ("ProfilerStep", "cudaDeviceSynchronize")):
            rows.append((dev_us, ev.count, ev.key))
    kernels = [r for r in rows if not r[2].startswith("aten::")]
    busy = sum(r[0] for r in kernels) / 1e3
    k1 = sum(r[0] for r in kernels if "hist_wave" in r[2]) / 1e3
    idle = max(0.0, 1 - busy / iter_ms)
    print(f"profiled iteration: device kernels {busy:.3f} ms (K1 "
          f"{k1:.3f} ms); unprofiled iteration {iter_ms:.3f} ms -> device "
          f"idle share {idle:.3f} (wall with the profiler on {wall_ms:.1f} "
          f"ms) [{kind}, {card}]", flush=True)
    for dev_us, count, key in sorted(kernels, reverse=True)[:8]:
        print(f"  {dev_us / 1e3:9.3f} ms  x{count:<5d} {key[:90]}", flush=True)
    return busy, k1, idle


def reset_counts(hw, hc):
    """Every kernel's launch count to 0."""
    hw.hist_wave.launches = 0
    hw.hist_wave.layout_launches.update(packed=0, triple=0)
    hc.hist_channels.launches = 0


def read_counts(hw, hc) -> dict:
    """Every kernel's launch count: K1 in all, K1 by layout, K2."""
    return {"k1": hw.hist_wave.launches,
            "k1_packed": hw.hist_wave.layout_launches["packed"],
            "k1_triple": hw.hist_wave.layout_launches["triple"],
            "k2": hc.hist_channels.launches}


def train_phase(lt, hw, hc, name, params, ds, kind, card, rounds=5):
    """One training phase on the card with every launch count set to 0
    just before and read just after; checks one packed K1 launch or more
    per wave.  Returns (booster, counts, logloss, AUC, median ms/iter)."""
    import torch
    torch.cuda.reset_peak_memory_stats()
    reset_counts(hw, hc)
    ev = {}
    bst = lt.train(params, ds, num_boost_round=rounds, valid_sets=[ds],
                   valid_names=["train"], evals_result=ev, device=DEV)
    counts = read_counts(hw, hc)
    launches = counts["k1_packed"]
    gb = bst._gbdt
    waves = [w for w, _ in gb.wave_stats]
    rows = [r for _, r in gb.wave_stats]
    if len(gb.models) != rounds:
        raise AssertionError(f"{name}: trained {len(gb.models)} trees, "
                             f"expected {rounds}")
    if launches < sum(waves) or launches == 0:
        raise AssertionError(f"{name}: K1 launched {launches} times for "
                             f"{sum(waves)} waves")
    loss, auc = ev["train"]["binary_logloss"], ev["train"]["auc"]
    per_iter = gb.iter_seconds[1:]
    print(f"{name}: leaves/tree {[t.num_leaves for t in gb.models]}, "
          f"waves/tree {waves}, rows histogrammed/tree {rows}, "
          f"launches {counts} [{kind}, {card}]", flush=True)
    print(f"{name}: s/iter after the first {per_iter} (median "
          f"{float(np.median(per_iter)):.4f}), first {gb.iter_seconds[0]:.4f};"
          f" peak device memory {torch.cuda.max_memory_allocated()} bytes "
          f"[{kind}, {card}]", flush=True)
    print(f"{name}: train logloss {loss}, auc {auc}", flush=True)
    return bst, counts, loss, auc, float(np.median(per_iter)) * 1e3


def grower_inputs(gb):
    """The next iteration's wave-grower inputs of a trained booster: bins,
    gradients and hessians at its current score, bag mask, feature mask."""
    g, h = gb.objective.get_gradients(gb._train_score)
    return gb._bins_fm, g, h, gb._bag_mask, gb._feature_mask()


def triple_path(hw, hc, gb, kind, card):
    """The wave grower in the triple layout (42 leaves a wave; the JAX
    package's layout for mixed-width data) against the packed one at the
    same capacity, one int16 tree each at the main path's width on the
    same inputs.  Integer sums are exact in both layouts, so the trees and
    row partitions must be identical.  The counts are set to 0 just before
    each tree and read just after.  Returns the triple tree's counts."""
    import torch
    from lightgbm_tpu_torch.core.wave_grower import build_wave_grow_fn
    cfg = gb.config
    args = grower_inputs(gb)
    res = {}
    for packed in (True, False):
        grow = build_wave_grow_fn(
            gb.meta, gb.split_cfg, gb.B,
            wave_capacity=hw.wave_capacity_max(False), highest="int16",
            gain_gate=float(cfg.tpu_wave_gain_gate),
            fused_sibling=bool(cfg.tpu_fused_sibling), packed=packed,
            quant_seed=int(cfg.seed))
        torch.cuda.synchronize()
        reset_counts(hw, hc)
        t0 = time.perf_counter()
        arrs, leaf_id, (waves, _) = grow(*args)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        res[packed] = (arrs, leaf_id, waves, read_counts(hw, hc), sec)
    (pa, pl, pw, pc, ps), (ta, tl, tw, tc, ts) = res[True], res[False]
    print(f"triple grower path: {int(ta.num_leaves)} leaves in {tw} waves, "
          f"{ts:.4f} s; packed twin {int(pa.num_leaves)} leaves in {pw} "
          f"waves, {ps:.4f} s; launches triple {tc}, packed {pc} [{kind}, "
          f"{card}]", flush=True)
    if tc["k1_triple"] < tw or tc["k1_triple"] == 0 or tc["k1_packed"]:
        raise AssertionError(f"triple grower: K1 launches {tc} for {tw} "
                             "waves")
    for k in pa._fields:
        a, b = getattr(pa, k), getattr(ta, k)
        if not (torch.equal(a, b) or (a.is_floating_point() and torch.allclose(
                a, b, rtol=0, atol=0, equal_nan=True))):
            raise AssertionError(f"triple and packed int16 trees differ in "
                                 f"{k}")
    if not torch.equal(pl, tl):
        raise AssertionError("triple and packed row partitions differ")
    return tc


def channels_path(hw, hc, gb, kind, card):
    """K2 through its single-leaf form ``hist_channels_fm`` (the JAX
    package's ``hist_pallas_fm``) on the main path's bins and gradients:
    the root histogram, whose per-feature sums are the whole-data totals.
    The counts are set to 0 just before and read just after."""
    import torch
    bins_fm, g, h, mask, _ = grower_inputs(gb)
    torch.cuda.synchronize()
    reset_counts(hw, hc)
    hist = hc.hist_channels_fm(bins_fm, g, h, mask, gb.B)
    torch.cuda.synchronize()
    counts = read_counts(hw, hc)
    if counts["k2"] != 1 or counts["k1"]:
        raise AssertionError(f"K2 path: launches {counts}")
    per_f = hist.double().sum(1)                            # [F, 3]
    gm, hm = (g * mask).double(), (h * mask).double()
    total = torch.stack([gm.sum(), hm.sum(), mask.double().sum()])
    lim = REL_TOL * torch.stack([gm.abs().sum(), hm.abs().sum(),
                                 torch.zeros((), device=DEV,
                                             dtype=torch.float64)]) + 1e-6
    err = (per_f - total).abs()
    print(f"K2 path (root histogram {tuple(hist.shape)}): max |per-feature "
          f"sum - total| {err.max(0).values.tolist()}, launches {counts} "
          f"[{kind}, {card}]", flush=True)
    if not bool((err <= lim).all()):
        raise AssertionError("K2 root histogram does not sum to the totals")
    return counts


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.ops import build
    from lightgbm_tpu_torch.ops import hist_channels as hc
    from lightgbm_tpu_torch.ops import hist_wave as hw

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; {kind}; "
          f"{card}", flush=True)

    # ---- 1. build ------------------------------------------------------
    t0 = time.perf_counter()
    lib = build.build()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s -> {lib.name}",
          flush=True)
    print(lib.with_suffix(".log").read_text().strip(), flush=True)
    census = sass_census(lib)
    print(f"shared-memory atomics in the SASS: {sass_atomics(census)}",
          flush=True)
    print(f"atomics, reductions and warp matches by kernel in the SASS: "
          f"{json.dumps(census)}", flush=True)

    # ---- 2. kernels vs plain ---------------------------------------------
    M = (MAIN_ROWS, 28, 256)
    R = (3001, 5, 64)
    k1_cases = [
        ("k1", M, 63, True, "2xbf16", True, None),
        ("k1_ragged", R, 7, False, "2xbf16", True, None),
        ("k1_int16", M, 63, True, "int16", True, None),
        ("k1_int8_ragged", R, 7, False, "int8", True, None),
        ("k1_triple", M, 42, True, "2xbf16", False, None),
        ("k1_triple_unfused", M, 42, False, "2xbf16", False, None),
        ("k1_triple_int16", M, 42, True, "int16", False, None),
        ("k1_triple_int16_unfused", R, 11, False, "int16", False, None),
        ("k1_high_ids_int16", (50_001, 7, 256), 63, True, "int16", True,
         30_000),
        ("k1_high_ids_2xbf16", (50_001, 7, 256), 40, False, "2xbf16", False,
         30_000),
        # low-cardinality features: many rows reduce into few cells
        ("k1_skew", M, 63, True, "2xbf16", True, None, True),
        ("k1_triple_skew", M, 42, True, "2xbf16", False, None, True),
        ("k1_skew_one_slot", M, 1, True, "2xbf16", True, None, True),
    ]
    res = {}
    for i, (key, (N, F, B), leaves, fused, mode, packed, hi, *skew) in \
            enumerate(k1_cases):
        n0 = hw.hist_wave.launches
        tag, res[key] = check_kernel(hw, N, F, B, leaves, fused, mode, i,
                                     packed=packed, leaf_hi=hi,
                                     skew=bool(skew))
        res[key].update(tag=tag, check_launches=hw.hist_wave.launches - n0)
    for i, (key, (N, F, B), C) in enumerate((("k2", M, 128),
                                             ("k2_ragged", R, 256))):
        n0 = hc.hist_channels.launches
        tag, res[key] = check_channels(hc, N, F, B, C, 100 + i)
        res[key].update(tag=tag,
                        check_launches=hc.hist_channels.launches - n0)
    for k in res.values():
        print(f"{k['tag']}: max_abs_err {k['max_abs_err']:.3g}, kernel "
              f"{k['ms']:.4f} ms, plain {k['plain_ms']:.4f} ms, index_add_ "
              f"{k['library_ms']:.4f} ms, bound {k['bound_ms']:.4f} ms by "
              f"{k['bound_by']} ({k['bytes']} bytes, {k['ops']} adds) "
              f"[{kind}, {card}]", flush=True)

    # ---- 3. small-input reference ---------------------------------------
    small_reference(lt)

    # ---- 4. main path ----------------------------------------------------
    X, y = higgs_like(MAIN_ROWS)
    params = {"objective": "binary", "metric": ["binary_logloss", "auc"],
              "num_leaves": 255, "learning_rate": 0.1, "max_bin": 255,
              "min_data_in_leaf": 100, "verbose": -1}
    t0 = time.perf_counter()
    ds = lt.Dataset(X, label=y)
    ds.construct()
    print(f"binning {MAIN_ROWS:,} x 28: {time.perf_counter() - t0:.1f} s "
          "(host)", flush=True)
    bst, counts, loss, auc, iter_ms = train_phase(
        lt, hw, hc, "main path", params, ds, kind, card)
    if not all(b < a for a, b in zip(loss, loss[1:])):
        raise AssertionError(f"train logloss did not fall: {loss}")
    if auc[-1] <= 0.7:
        raise AssertionError(f"train AUC {auc[-1]} <= 0.7")
    _, k1_f_ms, _ = profile_iteration(bst, iter_ms, kind, card)

    # ---- 5. quantized main path (int16) ----------------------------------
    bst16, counts16, loss16, auc16, iter16_ms = train_phase(
        lt, hw, hc, "int16 path", {**params, "tpu_hist_dtype": "int16"}, ds,
        kind, card)
    if not all(b < a for a, b in zip(loss16, loss16[1:])):
        raise AssertionError(f"int16 train logloss did not fall: {loss16}")
    if abs(auc16[-1] - auc[-1]) > 1e-3:
        raise AssertionError(f"int16 train AUC {auc16[-1]} is not within "
                             f"1e-3 of 2xbf16's {auc[-1]}")
    _, k1_q_ms, _ = profile_iteration(bst16, iter16_ms, kind, card)
    print(f"K1 per profiled iteration: int16 {k1_q_ms:.3f} ms vs 2xbf16 "
          f"{k1_f_ms:.3f} ms; s/iter int16 {iter16_ms / 1e3:.4f} vs 2xbf16 "
          f"{iter_ms / 1e3:.4f} [{kind}, {card}]", flush=True)

    # ---- 6. the triple layout's grower path and K2's path -----------------
    counts_triple = triple_path(hw, hc, bst16._gbdt, kind, card)
    counts_k2 = channels_path(hw, hc, bst16._gbdt, kind, card)
    del bst16

    # ---- 7. int8 with bagging --------------------------------------------
    _, counts8, _, auc8, _ = train_phase(
        lt, hw, hc, "int8 bagging path",
        {**params, "tpu_hist_dtype": "int8", "bagging_fraction": 0.8,
         "bagging_freq": 1}, ds, kind, card)
    if abs(auc8[-1] - auc[-1]) > 1e-2:
        raise AssertionError(f"int8 bagged train AUC {auc8[-1]} is not "
                             f"within 1e-2 of 2xbf16's {auc[-1]}")

    # ---- 8. predict and model text ----------------------------------------
    pred = bst.predict(X[:10_000])
    text = bst.model_to_string()
    if pred.shape != (10_000,) or not np.all(np.isfinite(pred)) \
            or not np.all((pred > 0) & (pred < 1)):
        raise AssertionError("predictions are not finite probabilities")
    if "Tree=4" not in text or "nan" in text.split("end of trees")[0]:
        raise AssertionError("model text is incomplete or not finite")
    print(f"predict 10,000 rows ok (mean {float(pred.mean()):.4f}); model "
          f"text {len(text)} chars", flush=True)

    # launches: each kernel's count in its own path's run (the trainer's
    # phases for K1 packed, the triple grower path, K2's path);
    # training_path_launches: the count summed over the three trainer
    # phases; check_launches: the kernel-vs-plain phase's launches
    def entry(name, key, source, replaces, n, errs, **extra):
        k = res[key]
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": n,
                "max_abs_err": max(res[e]["max_abs_err"] for e in errs),
                "ms": k["ms"], "plain_ms": k["plain_ms"],
                "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
                "library_ms": k["library_ms"],
                "check_launches": sum(res[e]["check_launches"] for e in errs),
                **extra}

    def on_trainer(key):
        return sum(c[key] for c in (counts, counts16, counts8))

    def skewed(*keys):
        # the skewed-bin cases' numbers, by case
        return {k: {n: res[k][n] for n in ("ms", "plain_ms", "library_ms",
                                           "bound_ms", "max_abs_err")}
                for k in keys}
    k1_src = "lightgbm_tpu_torch/csrc/hist_wave.cu"
    k1_at = "lightgbm_tpu/ops/pallas_hist.py:584"
    kernels = [
        entry("hist_wave (K1)", "k1", k1_src, k1_at, counts["k1_packed"],
              ["k1", "k1_ragged", "k1_high_ids_2xbf16", "k1_skew",
               "k1_skew_one_slot"],
              skewed=skewed("k1_skew", "k1_skew_one_slot")),
        entry("hist_wave int16 (K1 e)", "k1_int16", k1_src, k1_at,
              counts16["k1_packed"], ["k1_int16", "k1_int8_ragged",
                                      "k1_high_ids_int16",
                                      "k1_triple_int16"]),
        entry("hist_wave triple (K1 c)", "k1_triple", k1_src, k1_at,
              counts_triple["k1_triple"], ["k1_triple", "k1_triple_unfused",
                                           "k1_triple_int16_unfused",
                                           "k1_triple_skew"],
              training_path_launches=on_trainer("k1_triple"),
              skewed=skewed("k1_triple_skew")),
        entry("hist_channels (K2)", "k2",
              "lightgbm_tpu_torch/csrc/hist_channels.cu",
              "lightgbm_tpu/ops/pallas_hist.py:199", counts_k2["k2"],
              ["k2", "k2_ragged"], training_path_launches=on_trainer("k2")),
    ]
    for k in kernels:
        if not all(math.isfinite(k[key]) for key in
                   ("max_abs_err", "ms", "plain_ms", "bound_ms",
                    "library_ms")):
            raise AssertionError(f"non-finite kernel numbers: {k}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
