"""One rank of a multi-rank training check: the learners across ranks
(``parallel/``) on one data set, every mode of a spec in turn, in one
process a rank.  The CPU tests (``tests/test_torch_parallel.py``,
``test_torch_distributed.py``) and ``chip_smoke.py`` phase 31 start it.

    python -m lightgbm_tpu_torch.tools.dist_check --spec spec.json \\
        --rank R --world W --init file:///tmp/store --out out_R.json

``spec.json``: ``{"data": "rows.npz", "device": "cpu" | "cuda",
"modes": [{"name": ..., "params": {...}, "rounds": N}, ...],
"refit": {"params": {...}, "rounds": N, "data_train": "rows.npz",
"data": "new.npz", "decay": 0.6}, "rank_grads": {"data": "rank.npz",
"params": {...}}, "mesh_shapes": ["data:1", ...], "bin_sample": true}``;
every key is optional.  An ``.npz`` holds ``X`` and ``y`` (and ``group``
for ranking).  Each rank writes one JSON object: per mode the model text,
the raw predictions of the training rows, the seconds of each iteration,
the collectives' calls and bytes and the hand kernels' launches; per
check its result.  Every rank joins the group with ``init_distributed``
(gloo; ``rank`` and ``world`` given), and the group is shut down at the
end.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time


def _counts():
    from ..ops import hist_channels, hist_wave
    from ..parallel.mesh import collective_counts
    return {"k1": int(hist_wave.hist_wave.launches),
            "k2": int(hist_channels.hist_channels.launches),
            "collectives": {k: dict(v) for k, v in collective_counts.items()}}


def _delta(after, before):
    return {"k1": after["k1"] - before["k1"], "k2": after["k2"] - before["k2"],
            "collectives": {k: {f: after["collectives"][k][f]
                                - before["collectives"][k][f]
                                for f in ("calls", "bytes")}
                            for k in after["collectives"]}}


def _load(path):
    import numpy as np
    z = np.load(path)
    return {k: z[k] for k in z.files}


def _train_mode(lt, data, mode, device):
    import numpy as np
    p = dict(mode["params"])
    kw = {"group": data["group"]} if "group" in data else {}
    ds = lt.Dataset(data["X"], label=data["y"], params=p, **kw)
    before = _counts()
    t0 = time.perf_counter()
    bst = lt.train(p, ds, int(mode["rounds"]), device=device,
                   keep_training_booster=True)
    if device != "cpu":
        import torch
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out = {"model": bst.model_to_string(),
           "iter_s": [float(s) for s in bst._gbdt.iter_seconds],
           "wall_s": wall, "uses_wave": bool(bst._gbdt.uses_wave),
           # a serial learner per rank (replicas) has no mesh
           "ranks": int(getattr(bst._gbdt._mesh, "size", 1)),
           "rank_sharded": bool(bst._gbdt._rank_sharded),
           **_delta(_counts(), before)}
    # the phase walls of every rank at the last exchange (obs/ranks.py;
    # empty unless telemetry or the train board ran the exchange)
    from ..obs import ranks
    out["skew"] = ranks.skew_table()
    raw = bst.predict(data["X"], raw_score=True)
    out["raw"] = np.asarray(raw, np.float64).reshape(-1).tolist()
    return bst, out


def _refit(lt, spec, device):
    """Train under the spec's (data-parallel) parameters, then refit on
    new rows on the device and with the host oracle."""
    import numpy as np
    data = _load(spec["data_train"])
    new = _load(spec["data"])
    p = dict(spec["params"])
    bst = lt.train(p, lt.Dataset(data["X"], label=data["y"], params=p),
                   int(spec["rounds"]), device=device)
    host = bst.refit(new["X"], new["y"], decay_rate=spec["decay"],
                     tpu_refit_device=False)
    dev = bst.refit(new["X"], new["y"], decay_rate=spec["decay"],
                    tpu_refit_device=True)
    worst = max(float(np.max(np.abs(a.leaf_value - b.leaf_value)))
                for a, b in zip(host._gbdt.models, dev._gbdt.models))
    return {"leaf_parity": worst, "model": dev.model_to_string(),
            "trees": int(dev.num_trees())}


def _rank_grads(lt, spec, device):
    """The query-sharded pair pass against the whole one on this rank."""
    import numpy as np
    import torch

    from ..objective import create_objective
    from ..parallel.mesh import build_mesh
    from ..parallel.rank_shard import enable_query_sharded_grads
    data = _load(spec["data"])
    cfg = lt.Config.from_params(dict(spec["params"]))
    ds = lt.Dataset(data["X"], label=data["y"], group=data["group"],
                    params=dict(spec["params"])).construct()
    obj = create_objective(cfg)
    obj.init(ds._handle.metadata, ds._handle.num_data, device)
    score = torch.as_tensor(np.random.default_rng(5).normal(
        size=ds._handle.num_data).astype(np.float32)).to(device)
    g1, h1 = obj.get_gradients(score)
    enable_query_sharded_grads(obj, build_mesh("", device))
    g2, h2 = obj.get_gradients(score)
    return {"equal": bool(torch.equal(g1, g2) and torch.equal(h1, h2)),
            "S": int(obj._shard.plan.S),
            "row_cuts": [int(x) for x in obj._shard.plan.row_cuts]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--spec", required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--init", required=True,
                    help="init_method of the process group")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    import torch
    torch.set_num_threads(1)
    import lightgbm_tpu_torch as lt
    from ..parallel import distributed
    with open(args.spec) as fh:
        spec = json.load(fh)
    device = spec.get("device", "cpu")
    if device == "cuda":
        device = f"cuda:{args.rank % max(torch.cuda.device_count(), 1)}"
        torch.cuda.set_device(torch.device(device))
    result = {"rank": args.rank, "world": args.world, "device": device}
    up = distributed.init_distributed(
        num_machines=args.world, rank=args.rank, init_method=args.init)
    result["group"] = bool(up)
    result["world_seen"] = distributed.world_size()
    try:
        if spec.get("bin_sample"):
            import numpy as np
            X = _load(spec["data"])["X"]
            mine = X[args.rank::args.world]
            pooled, total = distributed.global_bin_sample(mine, len(mine))
            want = np.concatenate([X[r::args.world]
                                   for r in range(args.world)])
            result["bin_sample"] = {
                "rows": int(total),
                "equal": bool(np.array_equal(pooled, want))}
        if spec.get("modes"):
            data = _load(spec["data"])
            result["modes"] = {}
            for mode in spec["modes"]:
                _, out = _train_mode(lt, data, mode, device)
                out["backend"] = distributed.device_backend(device)
                result["modes"][mode["name"]] = out
                print(f"rank {args.rank}: {mode['name']} "
                      f"{sum(out['iter_s']):.3f} s", flush=True)
        if spec.get("refit"):
            result["refit"] = _refit(lt, spec["refit"], device)
        if spec.get("mesh_shapes"):
            # each tpu_mesh_shape: accepted (its ranks) or refused
            from ..parallel.mesh import build_mesh
            from ..utils.log import LightGBMError
            result["mesh_shapes"] = {}
            for shape in spec["mesh_shapes"]:
                try:
                    got = build_mesh(shape, device).size
                except LightGBMError as exc:
                    got = f"refused: {exc}"
                result["mesh_shapes"][shape] = got
        if spec.get("rank_grads"):
            result["rank_grads"] = _rank_grads(lt, spec["rank_grads"],
                                               device)
        result["ok"] = True
    finally:
        distributed.shutdown()
    tmp = args.out + ".tmp"
    with open(tmp, "w") as fh:
        json.dump(result, fh)
    os.replace(tmp, args.out)
    return 0


def launch(spec_path: str, world: int, workdir: str, timeout: float = 600,
           env=None, rank_env=None):
    """Start ``world`` ranks of this module on ``spec_path`` (a file store
    in ``workdir`` as the rendezvous), wait for all, and return their
    results in rank order.  ``rank_env[r]`` adds variables to rank r's
    environment only (a fault spec that slows one rank).  Raises with
    every rank's output when one fails or times out; stops every process
    it started."""
    import subprocess
    store = os.path.join(workdir, "dist_check_store")
    if os.path.exists(store):
        os.remove(store)
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ if env is None else env)
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    for var in ("RANK", "WORLD_SIZE", "LGBM_TPU_RANK"):
        env.pop(var, None)
    outs = [os.path.join(workdir, f"dist_check_{r}.json")
            for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "lightgbm_tpu_torch.tools.dist_check",
         "--spec", spec_path, "--rank", str(r), "--world", str(world),
         "--init", f"file://{store}", "--out", outs[r]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env={**env, **((rank_env or {}).get(r) or {})})
        for r in range(world)]
    logs = [""] * world
    try:
        t_end = time.monotonic() + timeout
        for r, p in enumerate(procs):
            logs[r], _ = p.communicate(
                timeout=max(t_end - time.monotonic(), 1.0))
    except subprocess.TimeoutExpired:
        raise RuntimeError("dist_check timed out:\n" + "\n".join(
            f"--- rank {r}\n{log}" for r, log in enumerate(logs)))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode != 0 for p in procs):
        raise RuntimeError("dist_check failed:\n" + "\n".join(
            f"--- rank {r} (rc {p.returncode})\n{logs[r]}"
            for r, p in enumerate(procs)))
    res = []
    for o in outs:
        with open(o) as fh:
            res.append(json.load(fh))
    for r, log in zip(res, logs):
        r["log"] = log
    return res


if __name__ == "__main__":
    sys.exit(main())
