"""One run of one cell: set-up, the measured window, the traced
iterations, the comparison with the reference, and the result line.

Everything a cell needs is found by name: ``BENCHMARK.json`` names the
cell's configuration (a file under ``configs/``), its traffic mix
(``traffic/<name>.json``) and its per-layer metrics (one reader each,
``metrics/<name>.py``); ``limits/<cell>.json`` names the numbers of the
comparison that the cell holds to a limit, with each limit;
``data/<kind>.py`` makes the configuration's rows from the
seed.  Adding a cell, a mix, a configuration or a metric adds files and
entries and edits none.
"""
from __future__ import annotations

import gc
import importlib
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "lightgbm_tpu")
RANGE = "bench/"


def load_spec(workload: str) -> dict:
    """The cell's entry, its configuration, its traffic mix, its limits
    and its per-layer metrics (as ``BENCHMARK.json`` lists them)."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; known: "
                         f"{sorted(cells)}")
    cell = cells[workload]
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = json.loads((ROOT / conf["file"]).read_text())
    traffic = json.loads(
        (BENCH_DIR / "traffic" / f"{cell['traffic']}.json").read_text())
    limits = json.loads(
        (BENCH_DIR / "limits" / f"{workload}.json").read_text())
    return {"cell": cell, "config": config, "traffic": traffic,
            "limits": limits, "per_layer": bench["per_layer"]}


def card_line() -> str:
    """The card's name and power limit (``nvidia-smi``)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired) as err:
        return f"nvidia-smi unavailable ({err})"
    lines = out.stdout.strip().splitlines()
    return lines[0] if out.returncode == 0 and lines else \
        "nvidia-smi unavailable"


def say(msg: str) -> None:
    print(msg, flush=True)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _ranged(name: str, fn):
    def call(*args, **kw):
        with torch.profiler.record_function(RANGE + name):
            return fn(*args, **kw)
    return call


def _instrument(bst) -> None:
    """The harness's own host ranges around the calls into each layer of
    the booster (traced iterations only)."""
    gb = bst._gbdt
    gb.objective.get_gradients = _ranged("gradients",
                                         gb.objective.get_gradients)
    for attr, name in (("_sample", "sample"), ("_grow", "grow"),
                       ("_add_tree", "add_tree")):
        setattr(gb, attr, _ranged(name, getattr(gb, attr)))


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _traced(bst, iters: int, device):
    """``iters`` more iterations under ``torch.profiler`` (host and
    device activity); returns (Trace, wall seconds, trace file bytes)."""
    from torch.profiler import ProfilerActivity, profile
    from gbdt_bench.tracing import Trace
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    _instrument(bst)
    _sync(device)
    with tempfile.TemporaryDirectory(prefix="gbdt_bench_trace_") as tmp:
        t0 = time.perf_counter()
        with profile(activities=acts) as prof:
            with torch.profiler.record_function(RANGE + "traced"):
                for _ in range(iters):
                    with torch.profiler.record_function(RANGE + "update"):
                        bst.update()
                _sync(device)
        wall = time.perf_counter() - t0
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        trace = Trace.load(path)
        size = os.path.getsize(path)
    return trace, wall, size


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: float = None, spec=None,
             rows: int = None, params: dict = None, fault=None,
             detail=None):
    """One run; returns (result line, the comparison's numbers with their
    limits).  ``rows``, ``params``, ``fault`` and ``detail`` are for the
    tests and the calibration: a smaller row count, parameters for the
    program alone (the control's lower precision, a planted departure),
    a planted fault (``faults.py``), a list that takes where each checked
    tree's value gap comes from.  The reference is always given the
    parameters the configuration and the traffic state."""
    import lightgbm_tpu_torch as lt
    from gbdt_bench.reference import check, model_text
    t_start = time.perf_counter() if t_start is None else t_start
    spec = spec or load_spec(workload)
    dev = torch.device(device)
    config, traffic = spec["config"], spec["traffic"]
    data_spec = dict(config["data"])
    if rows is not None:
        data_spec["rows"] = rows
    stated = {**config["params"], **traffic["params"]}
    prm = {**stated, **(params or {})}
    card = card_line() if dev.type == "cuda" else "cpu"
    say(f"cell {workload} seed {seed} on {card}; params {prm}")
    if dev.type == "cuda":
        # the kernel library, built on a checkout's first run only
        from lightgbm_tpu_torch.ops import build as kernels
        t0 = time.perf_counter()
        lib = kernels.build()
        say(f"kernel library {lib.name}: ready in "
            f"{time.perf_counter() - t0:.3f} s (a first run of a checkout "
            f"builds it here)")

    t0 = time.perf_counter()
    data = importlib.import_module(
        f"gbdt_bench.data.{data_spec['kind']}").make(data_spec, seed, dev)
    X, label, group = data["X"], data["label"], data["group"]
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ds = lt.Dataset(X, label=label, group=group, params=prm).construct()
    bin_s = time.perf_counter() - t0
    N, F = X.shape
    say(f"data {N:,} x {F} made in {gen_s:.3f} s, binned in {bin_s:.3f} s")
    bounds = [np.asarray(m.bin_upper_bound, np.float64)
              for m in ds._handle.bin_mappers]

    t0 = time.perf_counter()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    bst = lt.Booster(prm, ds, device=dev)
    gb = bst._gbdt
    if fault is not None:
        fault(bst)
    goss = {} if prm.get("boosting") == "goss" else None
    checked = list(traffic["checked_iters"])
    for it in range(int(traffic["warmup_iters"])):
        score_before = (gb._train_score.detach().cpu().clone()
                        if goss is not None and it in checked else None)
        bst.update()
        if score_before is not None:
            goss[it] = (score_before, gb._bag_mask.detach().cpu().clone())
    _sync(dev)
    warm_s = time.perf_counter() - t0
    say(f"booster and {traffic['warmup_iters']} warm-up iterations in "
        f"{warm_s:.3f} s")

    # the measured window
    t_window = time.perf_counter()
    setup_s = t_window - t_start
    done = stopped = 0
    trees_before = len(gb.models)
    while True:
        if bst.update():
            stopped += 1
        done += 1
        t_end = time.perf_counter()
        if t_end - t_window >= seconds:
            break
    window_s = t_end - t_window
    window_trees_n = len(gb.models) - trees_before
    window_tree = (trees_before + window_trees_n - 1
                   if window_trees_n else None)
    if goss is not None and window_tree is not None:
        goss[window_tree] = (None, gb._bag_mask.detach().cpu().clone())
    window_waves = list(gb.wave_stats[-window_trees_n:]) \
        if window_trees_n else []
    peak = (int(torch.cuda.max_memory_allocated(dev))
            if dev.type == "cuda" else 0)
    rate = N * done / window_s
    per_iter = np.asarray(gb.iter_seconds[-done:] or [np.nan])
    say(f"window: {done} iterations in {window_s:.4f} s "
        f"({window_s / done:.5f} s/iter; the program's per-iteration clock: "
        f"min {per_iter.min():.4f}, median {np.median(per_iter):.4f}, max "
        f"{per_iter.max():.4f}), {rate:.6g} row-iterations/s; set-up "
        f"{setup_s:.3f} s; peak device memory {peak} bytes")

    traced = None
    traced_iters = int(traffic["traced_iters"]) if trace else 0
    if trace:
        traced, traced_wall, size = _traced(bst, traced_iters, dev)
        say(f"traced: {traced_iters} iterations in {traced_wall:.3f} s "
            f"with the profiler on; trace file {size} bytes")
    iterations = int(traffic["warmup_iters"]) + done + traced_iters

    bad = forbidden_modules()
    if bad:
        raise SystemExit(f"modules of the JAX package loaded: {bad}")

    text = bst.model_to_string()
    final_score = gb._train_score.detach().cpu().clone()
    del bst, gb, ds
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    trees = model_text.parse_trees(text)

    t0 = time.perf_counter()
    Xd = torch.as_tensor(X, device=dev)
    numbers = check.compare(
        trees, iterations, Xd, torch.as_tensor(label, device=dev).double(),
        group, stated, checked, final_score, bounds, goss, detail,
        window_tree)
    del Xd
    ref_s = time.perf_counter() - t0
    limits = spec["limits"]
    checks = {k: [v, float(limits[k])] for k, v in numbers.items()
              if k in limits}
    correct = all(v <= lim for v, lim in checks.values())
    say(f"reference comparison in {ref_s:.3f} s: correct {correct}")

    dev_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                "kind": (torch.cuda.get_device_name(dev)
                         if dev.type == "cuda" else "cpu"),
                "count": 1, "memory_peak_bytes": peak}
    if not trace:
        metrics = {"train_row_iters_per_s": {"value": rate,
                                             "unit": "row-iters/s"},
                   "setup_s": {"value": setup_s, "unit": "s"}}
        result = {"correct": correct, "attempted": done, "failed": stopped,
                  "metrics": metrics, "device": dev_info}
    else:
        window_trees = trees[trees_before:trees_before + window_trees_n]
        ctx = SimpleNamespace(
            bin_s=bin_s, rows=N, features=F,
            max_bin=int(prm.get("max_bin", 255)),
            pair_slots=(float(np.sum(np.asarray(group, np.float64) ** 2))
                        if group is not None else 0.0),
            window_s=window_s, window_iters=done, iter_s=window_s / done,
            window_trees=window_trees, window_wave_stats=window_waves,
            traced_trees=trees[len(trees) - traced_iters:],
            traced_iters=traced_iters, trace=traced,
            device_type=dev.type)
        metrics = {}
        for m in spec["per_layer"]:
            reader = importlib.import_module(f"gbdt_bench.metrics.{m['name']}")
            value = reader.read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        window = traced.ranges(RANGE + "traced")
        span = window[0] if window else (0.0, 0.0)
        dev_info["busy_s"] = traced.busy_us() / 1e6
        dev_info["window_s"] = (span[1] - span[0]) / 1e6
        result = {"correct": correct, "attempted": done, "failed": stopped,
                  "metrics": metrics, "device": dev_info,
                  "breakdown": {"device_ops": traced.top_ops(),
                                "idle_gaps": traced.idle_gaps(span)}}
    result["checks"] = checks
    return result, checks
