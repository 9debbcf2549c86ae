"""The serving chaos matrix on the port (counterpart of
tools/chaos_serve.py): each scenario injects a fault into the serving
fleet (``robust/faults.py`` points ``serve_replica_{i}``,
``serve_canary``, ``serve_device``) or drives an overload, and checks the
steady state the fleet promises.

- **replica_wedge**: one replica of two wedges; every request is still
  answered by the survivor, the breaker opens, and once the fault clears
  the half-open probe closes it.
- **swap_mid_flight**: a canary-gated hot swap under concurrent /predict
  and /explain HTTP traffic loses no request, and every answer matches
  the model version it names.
- **canary_fail**: an injected canary fault rejects the push with 409;
  the old version keeps serving.
- **rollback_trigger**: a device wedge after a swap degrades the new
  version (its batches answer ``DeviceFailed``); the post-swap check
  rolls back to the resident previous version and dumps the flight ring.
- **replica_restart**: a replica restarted mid-storm with the serving
  store armed loses no request, boots from the store, and its first
  request captures no CUDA graph.
- **shed_priority**: a saturated queue sheds low priority first, admits
  high, counts both in /metrics, and the 503 carries ``Retry-After``.
- **drift**: shifted traffic breaches the drift monitor (breach latched,
  flight ring dumped); a clean replay stays below the threshold.

The models are trained on ``--device`` (K1 on the card) and served
there; the record carries K1's launches.

    python -m lightgbm_tpu_torch.tools.chaos_serve --json
    python -m lightgbm_tpu_torch.tools.chaos_serve --device cpu --json
"""
from __future__ import annotations

import glob
import json
import os
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

import numpy as np

from ._verdict import (Verdict, device_parser, emit, k1_launches, post,
                       resolve_device)

# JAX check name -> (port check name or None, why; the ROADMAP.md line)
DEPARTURES = {
    "restart.first_request_no_compile": (
        "restart.first_request_no_graph_capture",
        "the port compiles nothing per bucket; its counterpart of the JAX "
        "compile count is serve/graph_captures, none on the request path "
        "after warm-up (ROADMAP.md 3.10, item 9)"),
}


def _p99(lat):
    from lightgbm_tpu_torch.obs.report import percentile
    return percentile(sorted(lat), 0.99)


def default_data(seed: int = 5, rows: int = 600):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(rows, 6))
    X[rng.random(X.shape) < 0.03] = np.nan
    y = (np.nan_to_num(X[:, 0]) - 0.4 * np.nan_to_num(X[:, 2]) > 0
         ).astype(np.float64)
    return X, y


def build_models(workdir: str, device: str, X, y, rounds: int = 5,
                 num_leaves: int = 7):
    """Two models whose predictions differ (an answer names exactly one of
    them), saved with their quality sidecars."""
    import lightgbm_tpu_torch as lgb
    P = {"objective": "binary", "num_leaves": num_leaves,
         "min_data_in_leaf": 5, "verbose": -1, "device_type": device}
    ds = lgb.Dataset(X, label=y, params=P)
    b1 = lgb.train(P, ds, num_boost_round=rounds)
    P2 = dict(P, num_leaves=5, learning_rate=0.2)
    b2 = lgb.train(P2, ds, num_boost_round=rounds + 3)
    m1 = os.path.join(workdir, "chaos_m1.txt")
    m2 = os.path.join(workdir, "chaos_m2.txt")
    b1.save_model(m1)
    b2.save_model(m2)
    return ((m1, b1), (m2, b2)), dict(P)


def _cfg(P, **over):
    from lightgbm_tpu_torch.config import Config
    base = dict(P, tpu_serve_max_batch=64, tpu_serve_max_wait_ms=1.0,
                tpu_serve_canary_rows=16, tpu_serve_canary_probes=4,
                tpu_serve_rollback_watch_s=0.0,  # the scenarios run it
                tpu_serve_reprobe_s=0.05)
    base.update(over)
    return Config.from_params(base)


# ---------------------------------------------------------------------------
def scenario_replica_wedge(v, models, X, P):
    """One wedged replica costs capacity, not availability."""
    from lightgbm_tpu_torch.robust import faults
    from lightgbm_tpu_torch.serve import ReplicaRouter
    (m1, b1) = models[0]
    router = ReplicaRouter(m1, n_replicas=2, config=_cfg(P))
    ref = b1.predict(X[:8])
    try:
        faults.configure("serve_replica_0:raise@n=-1")
        outs, fails = [], 0
        for _ in range(12):
            try:
                t = router.submit(X[:8])
                outs.append((t.replica.idx, router.result(t, timeout=30)))
            except Exception:  # noqa: BLE001
                fails += 1
        v.check("wedge.all_served", fails == 0 and len(outs) == 12,
                f"{fails} failures")
        v.check("wedge.correct_on_survivor",
                all(np.allclose(o, ref, atol=1e-6) for _, o in outs))
        st = router.stats()
        r0 = st["replicas"][0]["breaker"]
        v.check("wedge.breaker_opened", r0["state"] == "open"
                and st["failovers"] >= 1, f"breaker {r0}")
        v.check("wedge.capacity_degraded",
                st["routable_replicas"] == 1 and not st["degraded"], st)
        # the fault clears -> the half-open probe re-admits replica 0
        faults.disarm()
        deadline = time.time() + 10
        closed = False
        while time.time() < deadline:
            router.result(router.submit(X[:4]), timeout=30)
            if router.replicas[0].breaker.state == "closed":
                closed = True
                break
            time.sleep(0.2)
        v.check("wedge.recovered_after_clear",
                closed and router.routable_count() == 2,
                router.replicas[0].breaker.snapshot())
    finally:
        faults.disarm()
        router.close()


# ---------------------------------------------------------------------------
def scenario_swap_mid_flight(v, models, X, P):
    """A hot swap under concurrent mixed HTTP traffic: nothing lost, each
    answer matches its version, the blip's p99 recorded."""
    from lightgbm_tpu_torch.serve import ModelRegistry, PredictServer
    (m1, b1), (m2, b2) = models
    reg = ModelRegistry(config=_cfg(P), n_replicas=1)
    reg.add_model("default", m1)
    server = PredictServer(reg).start()
    url = server.url
    results, lock = [], threading.Lock()
    stop = threading.Event()
    pool = X[:32]
    expected = {1: (b1.predict(pool), b1.predict(pool, pred_contrib=True)),
                2: (b2.predict(pool), b2.predict(pool, pred_contrib=True))}

    def client(seed):
        rng = np.random.default_rng(seed)
        while not stop.is_set():
            n = int(rng.integers(1, 9))
            lo = int(rng.integers(0, pool.shape[0] - n + 1))
            explain = rng.random() < 0.3
            path = "/explain" if explain else "/predict"
            t0 = time.perf_counter()
            try:
                code, body, _ = post(url + path,
                                     {"rows": pool[lo:lo + n].tolist()})
            except urllib.error.HTTPError as exc:
                code, body = exc.code, {}
            except Exception as exc:  # noqa: BLE001
                code, body = -1, {"error": repr(exc)}
            with lock:
                results.append({
                    "t0": t0, "t": time.perf_counter(), "code": code,
                    "lat_ms": (time.perf_counter() - t0) * 1e3,
                    "version": body.get("version"), "lo": lo, "n": n,
                    "explain": explain,
                    "values": body.get("contributions" if explain
                                       else "predictions")})
            time.sleep(0.01)

    threads = [threading.Thread(target=client, args=(s,))
               for s in range(4)]
    for t in threads:
        t.start()
    time.sleep(1.2)
    t_swap0 = time.perf_counter()
    try:
        code, swap_body, _ = post(url + "/models/default/swap",
                                  {"model_file": m2}, timeout=120)
    except urllib.error.HTTPError as exc:
        code, swap_body = exc.code, json.loads(exc.read() or b"{}")
    t_swap1 = time.perf_counter()
    time.sleep(1.2)
    stop.set()
    for t in threads:
        t.join(30)
    server.stop(close_session=True)

    ok_rows = [r for r in results if r["code"] == 200]
    v.check("swap.http_ok", code == 200 and swap_body.get("ok"), swap_body)
    v.check("swap.zero_loss", len(ok_rows) == len(results)
            and len(results) >= 8,
            f"{len(results) - len(ok_rows)}/{len(results)} non-200")
    vers = {r["version"] for r in ok_rows}
    v.check("swap.both_versions_observed", vers == {1, 2}, vers)
    mismatch = 0
    for r in ok_rows:
        pref, cref = expected.get(r["version"], (None, None))
        if pref is None:
            mismatch += 1
            continue
        got = np.asarray(r["values"], dtype=np.float64)
        want = (cref[r["lo"]:r["lo"] + r["n"]] if r["explain"]
                else pref[r["lo"]:r["lo"] + r["n"]])
        if got.shape != np.asarray(want).shape or \
                not np.allclose(got, want, atol=1e-5):
            mismatch += 1
    v.check("swap.bit_consistent", mismatch == 0,
            f"{mismatch} answers did not match their version")
    # a request started after the swap call returned resolves the new
    # version; old answers after the flip are stragglers sent before it
    after = [r for r in ok_rows if r["t0"] > t_swap1 + 0.05]
    v.check("swap.new_traffic_on_new_version",
            all(r["version"] == 2 for r in after) and len(after) > 0,
            {r["version"] for r in after})
    steady = [r["lat_ms"] for r in ok_rows
              if r["t"] < t_swap0 or r["t"] > t_swap1 + 0.5]
    blip = [r["lat_ms"] for r in ok_rows
            if t_swap0 <= r["t"] <= t_swap1 + 0.5]
    steady_p99, blip_p99 = _p99(steady), _p99(blip)
    v.check("swap.blip_recorded", steady_p99 is not None)
    return {"swap_blip_p99_ms": blip_p99, "steady_p99_ms": steady_p99,
            "swap_ms": round((t_swap1 - t_swap0) * 1e3, 1),
            "requests": len(results)}


# ---------------------------------------------------------------------------
def scenario_canary_fail(v, models, X, P):
    """An injected canary fault rejects the push; the old model serves."""
    from lightgbm_tpu_torch.robust import faults
    from lightgbm_tpu_torch.serve import ModelRegistry, PredictServer
    (m1, b1), (m2, _) = models
    reg = ModelRegistry(config=_cfg(P), n_replicas=1)
    reg.add_model("default", m1)
    server = PredictServer(reg).start()
    try:
        faults.configure("serve_canary:raise@call=1")
        try:
            code, body, _ = post(server.url + "/models/default/swap",
                                 {"model_file": m2}, timeout=120)
        except urllib.error.HTTPError as exc:
            code, body = exc.code, json.loads(exc.read())
        faults.disarm()
        v.check("canary.rejected_409", code == 409
                and body.get("error") == "swap_rejected", (code, body))
        listing = reg.models()[0]
        v.check("canary.old_still_live", listing["live_version"] == 1
                and listing["swaps_rejected"] == 1, listing)
        code, body, _ = post(server.url + "/predict",
                             {"rows": X[:4].tolist()})
        v.check("canary.serving_after_reject", code == 200
                and body.get("version") == 1
                and np.allclose(body["predictions"], b1.predict(X[:4]),
                                atol=1e-6))
    finally:
        faults.disarm()
        server.stop(close_session=True)


# ---------------------------------------------------------------------------
def scenario_rollback_trigger(v, models, X, P, art_dir):
    """A device wedge after a swap -> health regression -> automatic
    rollback to the resident previous version and a flight dump."""
    from lightgbm_tpu_torch import obs
    from lightgbm_tpu_torch.robust import faults
    from lightgbm_tpu_torch.serve import (DeviceFailed, ModelRegistry,
                                          ServeOverloadError)
    (m1, b1), (m2, _) = models
    # one degraded transition trips the watch
    reg = ModelRegistry(config=_cfg(P, tpu_serve_rollback_degraded=1),
                        n_replicas=1)
    reg.add_model("default", m1)
    try:
        swap = reg.swap("default", m2)
        v.check("rollback.swap_ok", swap["ok"], swap)
        n_flights0 = len(glob.glob(os.path.join(art_dir, "FLIGHT_*.json")))
        faults.configure("serve_device:raise@n=-1")
        failed = 0
        for _ in range(4):   # the wedged version answers 503s:
            try:             # DeviceFailed, then its breaker's refusal
                reg.result(reg.submit(X[:4]), timeout=30)
            except (DeviceFailed, ServeOverloadError):
                failed += 1
        st = reg.resolve(None).router.stats()
        v.check("rollback.new_version_degraded",
                st["any_degraded"] and failed >= 1, (failed, st))
        out = reg.check_postswap("default")
        v.check("rollback.triggered", out is not None
                and str(out.get("reason", "")).startswith("auto:"), out)
        faults.disarm()
        live = reg.resolve(None)
        v.check("rollback.live_is_previous", live.version == 1,
                live.version)
        listing = reg.models()[0]
        v.check("rollback.counted", listing["rollbacks"] == 1, listing)
        n_flights1 = len(glob.glob(os.path.join(art_dir, "FLIGHT_*.json")))
        v.check("rollback.flight_dumped",
                obs.flight_enabled() and n_flights1 > n_flights0,
                f"{n_flights0} -> {n_flights1} in {art_dir}")
        v.check("rollback.serving_after_rollback",
                np.allclose(reg.result(reg.submit(X[:4]), timeout=30),
                            b1.predict(X[:4]), atol=1e-6))
    finally:
        faults.disarm()
        reg.close()


# ---------------------------------------------------------------------------
def scenario_replica_restart(v, models, X, P):
    """A replica restarted mid-storm with the serving store armed: nothing
    lost, the restart boots from the store and warms before it takes
    traffic, so its first request captures no CUDA graph."""
    from lightgbm_tpu_torch import obs
    from lightgbm_tpu_torch.serve import ReplicaRouter
    (m1, b1) = models[0]
    with tempfile.TemporaryDirectory(prefix="chaos_aot_") as aot_dir:
        router = ReplicaRouter(m1, n_replicas=2,
                               config=_cfg(P, tpu_serve_aot_dir=aot_dir))
        ref = b1.predict(X[:8])
        try:
            router.warmup()
            aot_st = (router.stats() or {}).get("aot") or {}
            v.check("restart.store_armed", aot_st.get("entries", 0) >= 1,
                    aot_st)
            stop = threading.Event()
            served, failures, lock = [], [], threading.Lock()

            def client(seed):
                rng = np.random.default_rng(seed)
                while not stop.is_set():
                    n = int(rng.integers(1, 9))
                    try:
                        out = router.result(router.submit(X[:n]),
                                            timeout=60)
                        with lock:
                            served.append((n, out))
                    except Exception as exc:  # noqa: BLE001 — counted
                        with lock:
                            failures.append(repr(exc))
                    time.sleep(0.005)

            threads = [threading.Thread(target=client, args=(s,))
                       for s in range(3)]
            for t in threads:
                t.start()
            time.sleep(0.5)
            boot = router.restart_replica(0)
            time.sleep(0.5)
            stop.set()
            for t in threads:
                t.join(30)
            v.check("restart.zero_loss", not failures and len(served) >= 8,
                    f"{len(failures)} failures / {len(served)} served: "
                    f"{failures[:3]}")
            v.check("restart.correct_answers",
                    all(np.allclose(o, ref[:n], atol=1e-6)
                        for n, o in served))
            sess = router.replicas[0].session
            status = ((sess.stats() or {}).get("aot") or {}).get("status")
            v.check("restart.boot_from_store",
                    boot["aot"] and status == "hit", (boot, status))
            # the restarted replica's first request, the storm stopped:
            # it replays the graphs its boot captured
            c0 = obs.counter_value("serve/graph_captures")
            first = sess.predict(X[:5])
            delta = obs.counter_value("serve/graph_captures") - c0
            v.check("restart.first_request_no_graph_capture",
                    delta == 0 and np.allclose(first, ref[:5], atol=1e-6),
                    f"{delta} graph captures on request #1")
            return {"restart_boot_ms": boot["boot_ms"],
                    "restart_boot_captures": boot["boot_captures"],
                    "restart_requests": len(served)}
        finally:
            router.close()


# ---------------------------------------------------------------------------
def scenario_shed_priority(v, models, X, P):
    """A saturated queue sheds low first; high is admitted; the counters
    reach /metrics; the 503 carries Retry-After."""
    from lightgbm_tpu_torch.serve import (PredictorSession, PredictServer,
                                          ServeOverloadError,
                                          parse_prometheus)
    (m1, _), _ = models
    cfg = _cfg(P, tpu_serve_max_batch=16, tpu_serve_queue_depth=64,
               tpu_serve_max_wait_ms=50.0)
    sess = PredictorSession(m1, config=cfg)
    sess.warmup()
    orig = sess._run_device

    def slow(bins, **kw):
        time.sleep(0.12)
        return orig(bins, **kw)

    sess._run_device = slow
    server = PredictServer(sess).start()
    tickets = []
    try:
        # low's cap is 32 rows, normal's 54, high's 64: 48 normal rows
        # fill the queue past low's budget and below high's
        shed_low = admitted_high = False
        for _ in range(6):
            tickets.append(sess.submit(X[:8], priority="normal"))
        try:
            sess.submit(X[:8], priority="low")
        except ServeOverloadError as exc:
            shed_low = exc.shed and exc.priority == "low"
        try:
            tickets.append(sess.submit(X[:8], priority="high"))
            admitted_high = True
        except ServeOverloadError:
            pass
        v.check("shed.low_shed_first", shed_low)
        v.check("shed.high_admitted", admitted_high)
        code, headers = None, {}
        try:
            code, _, headers = post(
                server.url + "/predict",
                {"rows": X[:8].tolist(), "priority": "low"}, timeout=30)
        except urllib.error.HTTPError as exc:
            code, headers = exc.code, dict(exc.headers)
        v.check("shed.retry_after_on_503", code == 503
                and "Retry-After" in headers, (code, list(headers)))
        for t in tickets:
            sess.result(t, timeout=60)
        pm = parse_prometheus(
            urllib.request.urlopen(server.url + "/metrics", timeout=30)
            .read().decode())
        v.check("shed.counters_in_metrics",
                pm.get('tpu_serve_shed_total{priority="low"}', 0) >= 2
                and pm.get('tpu_serve_served_total{priority="high"}', 0)
                >= 1
                and pm.get('tpu_serve_shed_total{priority="high"}', 0)
                == 0,
                {k: val for k, val in pm.items()
                 if "shed" in k or "served" in k})
    finally:
        server.stop(close_session=True)


# ---------------------------------------------------------------------------
def scenario_drift(v, models, X, P, art_dir):
    """Seeded covariate shift breaches the drift monitor (flight dump,
    breach latched); clean traffic stays quiet."""
    from lightgbm_tpu_torch.serve import ModelRegistry
    (m1, _), _ = models
    rng = np.random.default_rng(7)
    # every batch sampled, a small row floor, the cadence forced
    os.environ["LGBM_TPU_DRIFT_SAMPLE_RATE"] = "1.0"
    os.environ["LGBM_TPU_DRIFT_MIN_ROWS"] = "64"
    reg = ModelRegistry(config=_cfg(P), n_replicas=1)
    try:
        reg.add_model("default", m1)
        mon = getattr(reg.resolve(None).router, "drift", None)
        v.check("drift.monitor_armed", mon is not None,
                "no .quality.json sidecar beside the model?")
        if mon is None:
            return
        # a clean replay of training rows in slices: the default data
        # whole, else its head, as many rows (the rows are drawn i.i.d., so
        # the head is an unbiased sample, and the shifted rows below weigh
        # in the cumulative sketch as they do on the default data)
        clean = X[:600]
        for s in range(0, len(clean), 120):
            reg.result(reg.submit(clean[s:s + 120]), timeout=30)
        quiet = mon.maybe_check(force=True)
        v.check("drift.clean_quiet", quiet is not None
                and quiet["psi_max"] <= mon.psi_warn
                and mon.breach is None,
                quiet and {k: quiet[k] for k in ("psi_max", "pred_psi")})
        n0 = len(glob.glob(os.path.join(art_dir, "FLIGHT_*.json")))
        # scaled and offset marginals, same width: N(0, 1) * 2.5 + 1.5 in
        # units of each column's own mean and spread
        mu, sd = np.nanmean(clean, 0), np.nanstd(clean, 0)
        for _ in range(4):
            shifted = rng.normal(size=(128, X.shape[1])) * 2.5 + 1.5
            reg.result(reg.submit(mu + sd * shifted), timeout=30)
        flagged = mon.maybe_check(force=True)
        v.check("drift.shifted_flagged", flagged is not None
                and flagged["psi_max"] > mon.psi_warn
                and mon.breach is not None,
                flagged and {k: flagged[k] for k in ("psi_max",
                                                     "pred_psi")})
        n1 = len(glob.glob(os.path.join(art_dir, "FLIGHT_*.json")))
        v.check("drift.breach_flight_dump", n1 > n0,
                f"{n0} -> {n1} in {art_dir}")
    finally:
        os.environ.pop("LGBM_TPU_DRIFT_SAMPLE_RATE", None)
        os.environ.pop("LGBM_TPU_DRIFT_MIN_ROWS", None)
        reg.close()


SCENARIOS = ("replica_wedge", "swap_mid_flight", "canary_fail",
             "rollback_trigger", "replica_restart", "shed_priority", "drift")


def run_matrix(device: str, X=None, y=None, rounds: int = 5,
               num_leaves: int = 7, quiet: bool = False) -> dict:
    """The seven scenarios' record.  ``X``/``y`` replace the default
    600 x 6 data (3% NaN) the two models are trained on."""
    from lightgbm_tpu_torch import obs
    from lightgbm_tpu_torch.robust import faults
    v = Verdict("chaos_serve", quiet=quiet)
    art = tempfile.mkdtemp(prefix="chaos_serve_")
    old_dir = os.environ.get("LGBM_TPU_FLIGHT_DIR")
    os.environ["LGBM_TPU_FLIGHT_DIR"] = art
    ring = obs.flight_len()
    if X is None:
        X, y = default_data()
    k0 = k1_launches()
    extra = {}
    try:
        with tempfile.TemporaryDirectory(prefix="chaos_models_") as workdir:
            models, P = build_models(workdir, device, X, y, rounds,
                                     num_leaves)
            k_train = k1_launches() - k0
            for name in SCENARIOS:
                t0 = time.time()
                fn = globals()["scenario_" + name]
                args = (v, models, X, P) + (
                    (art,) if name in ("rollback_trigger", "drift") else ())
                try:
                    extra.update(fn(*args) or {})
                except Exception as exc:  # noqa: BLE001
                    v.check(f"{name}.no_crash", False, repr(exc))
                v.leg(name, t0)
    finally:
        faults.disarm()
        obs.enable_flight(ring)
        if old_dir is None:
            os.environ.pop("LGBM_TPU_FLIGHT_DIR", None)
        else:
            os.environ["LGBM_TPU_FLIGHT_DIR"] = old_dir
    return v.record(device=device, k1_launches=k_train,
                    artifacts_dir=art, **extra)


def main(argv=None) -> int:
    ap = device_parser("The serving chaos matrix on the port")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if device is None:
        return 2
    return emit(run_matrix(device), args.json)


if __name__ == "__main__":
    sys.exit(main())
