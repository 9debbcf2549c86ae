"""The train board's smoke on the port (counterpart of
tools/board_smoke.py): a short training with the board armed
(``tpu_train_metrics_port=0``, a free port) while a poller scrapes
``GET /metrics`` and ``GET /progress``.

- **board_started / board_stopped**: training arms the board and stops
  it at its end;
- **prometheus_parses**: the exposition parses through the serving
  plane's reader (``serve.metrics.parse_prometheus``) and carries the
  training series;
- **progress_fields**: ``/progress`` answers its whole JSON contract;
- **iteration_advances**: successive scrapes see the iteration move;
- **eta_converging**: every sampled ETA is finite, and it shrinks as the
  run ends;
- **flight_endpoint**: ``/debug/flight`` serves the ring;
- **overhead_ok**: the training thread's seconds in the board's hook stay
  under 5% of the training wall.

Training runs on ``--device`` (K1 on the card).

    python -m lightgbm_tpu_torch.tools.board_smoke --json
    python -m lightgbm_tpu_torch.tools.board_smoke --device cpu --json
"""
from __future__ import annotations

import json
import math
import os
import sys
import threading
import time

from ._verdict import (Verdict, device_parser, emit, fetch, k1_launches,
                       resolve_device)

# JAX check name -> (port check name or None, why); none differ
DEPARTURES: dict = {}

ROUNDS = 20
POLL_S = 0.02
PROGRESS_KEYS = ("iteration", "total_rounds", "start_round", "eta_s",
                 "ema_iter_s", "row_iters_per_s", "recent", "checkpoint",
                 "uptime_s")


def run_smoke(device: str, quiet: bool = False) -> dict:
    import numpy as np

    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch import obs
    from lightgbm_tpu_torch.obs import board
    from lightgbm_tpu_torch.serve.metrics import parse_prometheus

    v = Verdict("board", quiet=quiet)
    # the variable wins over the parameter: pinned, so an outer
    # LGBM_TPU_TRAIN_METRICS=off cannot make the smoke a no-op
    old_env = os.environ.get("LGBM_TPU_TRAIN_METRICS")
    os.environ["LGBM_TPU_TRAIN_METRICS"] = "0"
    rng = np.random.default_rng(7)
    X = rng.normal(size=(4000, 12))
    y = (X[:, 0] + 0.4 * X[:, 1] - 0.2 * X[:, 2] > 0).astype(np.float64)
    params = {"objective": "binary", "num_leaves": 15,
              "min_data_in_leaf": 5, "verbose": -1,
              "tpu_train_metrics_port": 0, "device_type": device}
    ds = lgb.Dataset(X, label=y, params=params)

    samples = []          # (t, iteration, eta_s) per successful scrape
    state = {"board": None, "metrics": None, "progress": None,
             "flight": None, "errors": 0, "stop": False}

    def poll():
        while not state["stop"]:
            b = board.current()
            if b is None or not b.port:
                time.sleep(POLL_S)
                continue
            state["board"] = b
            try:
                mtext = fetch(b.url + "/metrics").decode()
                pr = json.loads(fetch(b.url + "/progress"))
                state["metrics"] = mtext
                state["progress"] = pr
                if state["flight"] is None:
                    state["flight"] = json.loads(
                        fetch(b.url + "/debug/flight"))
                if pr.get("iteration") is not None:
                    samples.append((time.time(), int(pr["iteration"]),
                                    pr.get("eta_s")))
            except Exception:  # noqa: BLE001 — counted
                state["errors"] += 1
            time.sleep(POLL_S)

    k0 = k1_launches()
    poller = threading.Thread(target=poll, daemon=True)
    poller.start()
    t0 = time.perf_counter()
    try:
        lgb.train(params, ds, num_boost_round=ROUNDS)
    finally:
        wall = time.perf_counter() - t0
        state["stop"] = True
        poller.join(timeout=5)
        if old_env is None:
            os.environ.pop("LGBM_TPU_TRAIN_METRICS", None)
        else:
            os.environ["LGBM_TPU_TRAIN_METRICS"] = old_env

    v.check("board_started", state["metrics"] is not None)
    v.check("board_stopped", not board.active())
    parsed = {}
    if state["metrics"]:
        try:
            parsed = parse_prometheus(state["metrics"])
        except Exception:  # noqa: BLE001
            parsed = {}
    v.check("prometheus_parses", all(
        k in parsed for k in ("tpu_train_iteration", "tpu_train_eta_seconds",
                              "tpu_train_row_iters_per_s",
                              "tpu_train_total_rounds")), sorted(parsed))
    pr = state["progress"] or {}
    v.check("progress_fields", all(k in pr for k in PROGRESS_KEYS), pr)
    iters = [s[1] for s in samples]
    v.check("iteration_advances", bool(iters) and max(iters) > min(iters),
            iters[:5])
    etas = [s[2] for s in samples if s[2] is not None]
    finite = bool(etas) and all(
        isinstance(e, (int, float)) and math.isfinite(e) and e >= 0
        for e in etas)
    # a smoothed estimate: net convergence (the last well below the
    # peak), not a strictly falling series
    v.check("eta_converging", finite and etas[-1] <= max(etas) + 1e-9
            and etas[-1] < 0.5 * max(etas) + 1e-9, etas[-5:])
    fl = state["flight"] or {}
    v.check("flight_endpoint", bool(fl.get("enabled"))
            and isinstance(fl.get("events"), list))
    b = state["board"]
    hook_s = float(getattr(b, "hook_s", 0.0)) if b is not None else -1.0
    v.check("overhead_ok", b is not None and hook_s < 0.05 * wall,
            f"hook {hook_s:.4f} s of {wall:.3f} s")
    obs.reset()
    return v.record(device=device, rounds=ROUNDS, train_wall_s=round(wall, 3),
                    hook_s=round(hook_s, 6), scrapes=len(samples),
                    scrape_errors=state["errors"],
                    port=getattr(b, "port", None) if b is not None else None,
                    eta_first=etas[0] if etas else None,
                    eta_last=etas[-1] if etas else None,
                    k1_launches=k1_launches() - k0)


def main(argv=None) -> int:
    ap = device_parser("The train board's smoke on the port")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if device is None:
        return 2
    return emit(run_smoke(device), args.json)


if __name__ == "__main__":
    sys.exit(main())
