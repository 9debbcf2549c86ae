"""The profiler window's smoke on the port (counterpart of
tools/xprof_smoke.py): a short training with the window armed
(``LGBM_TPU_XPROF``), the telemetry sink and the train board on.

- **trace_captured**: the ``torch.profiler`` window wrote a Chrome trace,
  parsed without error;
- **kernels_attributed**: at least 3 distinct ``lgbm/*`` units with
  measured time (hand kernels by CUDA symbol on the card, ``lgbm/*``
  ranges);
- **model_joined**: at least one attributed unit carries its cost
  function's bound (``roofline_frac``);
- **events_validate**: the ``kernel_measured`` and ``compile`` events
  pass ``obs/report.py validate_events``;
- **digest_renders**: ``report.render`` of the sink's events shows the
  measured-roofline table, and the compile plane's line when the run
  built a kernel or captured a graph;
- **board_compile_metrics**: the board's ``/metrics`` carries the
  compile series (kernel builds, their seconds; cache and retrace series
  at 0);
- **overhead_ok**: a window's ``step()`` outside its iterations stays
  under 5% of the training wall.

Training runs on ``--device`` (K1 on the card).

    python -m lightgbm_tpu_torch.tools.xprof_smoke --json
    python -m lightgbm_tpu_torch.tools.xprof_smoke --device cpu --json
"""
from __future__ import annotations

import importlib
import os
import sys
import tempfile
import time

from ._verdict import (Verdict, device_parser, emit, fetch, k1_launches,
                       resolve_device)

# JAX check name -> (port check name or None, why; the ROADMAP.md line)
DEPARTURES = {
    "compile_observed": (
        None,
        "the port compiles no XLA program; its kernels are built once per "
        "source digest into build/ and reused by later processes, so a run "
        "sees a build only after a source changed (ROADMAP.md 3.10, item "
        "8B, compile reporting and the board)"),
    "cache_counted": (
        None,
        "the port has no persistent compile cache: the board's cache series "
        "stay 0 (ROADMAP.md 3.10, item 8B, compile reporting and the "
        "board)"),
}

ROUNDS = 6
WINDOW_ITERS = 2


def run_smoke(device: str, quiet: bool = False) -> dict:
    import numpy as np

    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch import obs
    from lightgbm_tpu_torch.obs import board, xprof
    report_mod = importlib.import_module("lightgbm_tpu_torch.obs.report")

    v = Verdict("xprof", quiet=quiet)
    work = tempfile.mkdtemp(prefix="lgbm_xprof_smoke_")
    telem = os.path.join(work, "telem")
    # the variables win over outer settings: the smoke cannot be disarmed
    pinned = {"LGBM_TPU_XPROF": str(WINDOW_ITERS),
              "LGBM_TPU_TRAIN_METRICS": "0"}
    saved = {k: os.environ.get(k) for k in pinned}
    os.environ.update(pinned)
    obs.reset()
    obs.enable(telem)

    rng = np.random.default_rng(7)
    X = rng.normal(size=(500, 10))
    y = (X[:, 0] + 0.4 * X[:, 1] - 0.2 * X[:, 2] > 0).astype(np.float64)
    params = {"objective": "binary", "num_leaves": 7,
              "min_data_in_leaf": 5, "verbose": -1,
              "tpu_train_metrics_port": 0, "device_type": device}
    ds = lgb.Dataset(X, label=y, params=params)
    state = {"metrics": None}

    # one scrape of /metrics mid-run: the board stops with the run
    def scrape(env):
        if state["metrics"] is None and env.iteration >= 2:
            b = board.current()
            if b is not None and b.port:
                try:
                    state["metrics"] = fetch(b.url + "/metrics").decode()
                except Exception:  # noqa: BLE001
                    pass

    k0 = k1_launches()
    try:
        t0 = time.perf_counter()
        lgb.train(params, ds, num_boost_round=ROUNDS, callbacks=[scrape])
        wall = time.perf_counter() - t0
        digest = obs.digest()
        obs.event("summary", **digest)
    finally:
        obs.disable()
        for k, val in saved.items():
            if val is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = val
    k_train = k1_launches() - k0
    xp = digest.get("xprof") or {}
    comp = digest.get("compile") or {}

    v.check("trace_captured", xp.get("trace_files", 0) > 0
            and xp.get("trace_parsed", 0) > 0 and not xp.get("errors"), xp)
    lgbm_units = {k: u for k, u in (xp.get("kernels") or {}).items()
                  if k.startswith("lgbm/") and u.get("measured_ms", 0) > 0}
    v.check("kernels_attributed", len(lgbm_units) >= 3, sorted(lgbm_units))
    v.check("model_joined", any(u.get("roofline_frac") is not None
                                for u in lgbm_units.values()),
            lgbm_units)

    events = report_mod.load_events(telem)
    emitted = [e for e in events
               if e.get("event") in ("kernel_measured", "compile")]
    problems = report_mod.validate_events(
        events, kinds=("kernel_measured", "compile"))
    v.check("events_validate", bool(emitted) and not problems, problems[:3])
    rendered = report_mod.render(report_mod.summarize(events))
    v.check("digest_renders", "measured roofline" in rendered
            and ("compile plane" in rendered) == bool(comp),
            rendered[-400:])
    mtext = state["metrics"] or ""
    v.check("board_compile_metrics", all(
        name in mtext for name in ("tpu_train_compile_cache_hits_total",
                                   "tpu_train_compile_cache_misses_total",
                                   "tpu_train_retraces_total",
                                   "tpu_train_compile_seconds_total")))

    # the disarmed branch: a window pushed past the run's end, so every
    # step() takes it
    win = xprof.WindowedCapture(os.path.join(work, "never"), iters=1,
                                skip=10 ** 9)
    t1 = time.perf_counter()
    bst2 = lgb.Booster(params={**params, "tpu_train_metrics_port": -1},
                       train_set=ds)
    for _ in range(ROUNDS):
        bst2.update()
        win.step()
    wall2 = time.perf_counter() - t1
    v.check("overhead_ok", win.hook_s < 0.05 * wall2,
            f"hook {win.hook_s:.6f} s of {wall2:.3f} s")
    obs.reset()
    return v.record(device=device, rounds=ROUNDS,
                    window_iters=WINDOW_ITERS, train_wall_s=round(wall, 3),
                    hook_s=round(win.hook_s, 6),
                    window_ms=xp.get("window_ms"),
                    kernels=sorted(lgbm_units),
                    kernel_measured_events=sum(
                        1 for e in emitted
                        if e.get("event") == "kernel_measured"),
                    kernel_builds=comp.get("kernel_builds", 0),
                    graph_captures=comp.get("graph_captures", {}),
                    validate_problems=problems[:5], k1_launches=k_train)


def main(argv=None) -> int:
    ap = device_parser("The profiler window's smoke on the port")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if device is None:
        return 2
    return emit(run_smoke(device), args.json)


if __name__ == "__main__":
    sys.exit(main())
