"""The fault-injection matrix on the port (counterpart of
tools/fault_matrix.py): every ``LGBM_TPU_FAULTS`` injection point against
its recovery branch, one named check each, in one command.

- a transient device failure retries, and the model is bit-identical to
  the run without the fault; so do a transient gradient failure and a
  transient collective failure;
- a fatal failure under ``abort`` raises ``DeviceWedgedError`` after a
  boundary checkpoint and a flight dump, and the resume from that
  checkpoint is bit-identical;
- ``tpu_on_device_error=fallback`` is refused (``config.py``);
- a stalled device step is stamped ``device_stall``;
- a failed serving batch degrades its plane, which answers
  ``DeviceFailed`` (HTTP 503) until the re-probe recovers it; a TreeSHAP
  failure degrades only the explain plane;
- a failed checkpoint write is survived, and the loader skips a corrupt
  newest checkpoint;
- the online loop: a refit fault and a poisoned canary leave the old
  version serving; a continuation that crashes resumes bit-exactly; an
  idle cadence is skipped and stamped;
- streamed ingestion: a transient chunk fault retries to the same
  dataset, a fatal or corrupt chunk aborts, a stalled chunk is stamped;
- the serving store: a corrupt entry falls back loudly and serves the
  same answers; arena pressure evicts a tenant, re-admitted on its next
  request with the same answers;
- the elastic fleet (``--legs fleet``): a rank killed mid-run, a killed
  coordinator, a heartbeat stall and a healed joiner.

Training on the card launches K1 (``ops/hist_wave.py``); the record
carries its launch count.

    python -m lightgbm_tpu_torch.tools.fault_matrix --json
    python -m lightgbm_tpu_torch.tools.fault_matrix --device cpu --json
    python -m lightgbm_tpu_torch.tools.fault_matrix --legs in_process
"""
from __future__ import annotations

import glob
import json
import os
import re
import subprocess
import sys
import tempfile
import time
import urllib.error

import numpy as np

from ._verdict import (Verdict, device_parser, emit, k1_launches, post,
                       resolve_device, tree_text)

# JAX check name -> (port check name or None, why; the ROADMAP.md line)
DEPARTURES = {
    "device_execute.fallback.completes": (
        "device_execute.fallback.refused",
        "the port never carries a failed device step on on the CPU; "
        "tpu_on_device_error=fallback is refused (ROADMAP.md 3.10, 'No "
        "host fallback anywhere')"),
    "serve_device.host_fallback_correct": (
        "serve_device.degraded_answers_503",
        "a failed serving batch answers DeviceFailed, HTTP 503, never a "
        "host walk (ROADMAP.md 3.10, 'No host fallback anywhere')"),
    "serve_explain.host_fallback_correct": (
        "serve_explain.degraded_answers_503",
        "a failed TreeSHAP batch answers DeviceFailed, HTTP 503, never the "
        "host oracle (ROADMAP.md 3.10, 'No host fallback anywhere')"),
}

FLEET_CHECKS = (
    "fleet.rank_killed.survivors_recover", "fleet.rank_killed.bit_exact",
    "fleet.coordinator_killed.loud_exit",
    "fleet.coordinator_killed.flight_dumped",
    "fleet.stall.stamped_not_killed", "fleet.rejoin.folds_in_mid_run",
    "fleet.rejoin.bit_exact_vs_never_failed")

# the rejoin leg's iterations (0.5 s each): the healed joiner's start-up
# must fit the rest of the run (a rank's CUDA start takes 7-15 s)
REJOIN_ITERS = {"cpu": 30, "cuda": 60}

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def default_data(seed: int = 0, rows: int = 500):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(rows, 6))
    y = (X[:, 0] - 0.3 * X[:, 2] > 0).astype(np.float64)
    return X, y


def in_process_legs(v: Verdict, device: str, art: str, X, y,
                    rounds: int = 6, num_leaves: int = 7) -> None:
    """Every leg but the fleet's, in this process."""
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch import obs
    from lightgbm_tpu_torch.robust import DeviceGuard, DeviceWedgedError
    from lightgbm_tpu_torch.robust import faults
    from lightgbm_tpu_torch.serve import DeviceFailed, PredictServer
    from lightgbm_tpu_torch.utils.log import LightGBMError

    rng = np.random.default_rng(1)
    P = {"objective": "binary", "num_leaves": num_leaves,
         "min_data_in_leaf": 5, "verbose": -1, "bagging_fraction": 0.8,
         "bagging_freq": 2, "device_type": device}
    n_serve = max(rounds - 1, 1)
    ds = lgb.Dataset(X, label=y, params=dict(P))

    def train(extra=None, n=rounds):
        p = dict(P)
        p.update(extra or {})
        b = lgb.train(p, ds, num_boost_round=n, verbose_eval=False)
        return tree_text(b.model_to_string(num_iteration=-1))

    ref = train()

    # ---- device_execute x retry ----------------------------------------
    faults.configure("device_execute:transient@iter=2")
    try:
        v.check("device_execute.retry.bit_identical",
                train({"tpu_on_device_error": "retry"}) == ref)
    except Exception as exc:  # noqa: BLE001
        v.check("device_execute.retry.bit_identical", False, repr(exc))
    faults.disarm()

    # ---- device_execute x abort (+ wedge checkpoint + resume) -----------
    ckdir = os.path.join(art, "wedge_ckpt")
    faults.configure(f"device_execute:raise@iter={min(3, rounds - 1)}")
    wedged = False
    try:
        train({"tpu_on_device_error": "abort", "tpu_checkpoint_dir": ckdir,
               "tpu_checkpoint_freq": 0})
    except DeviceWedgedError:
        wedged = True
    faults.disarm()
    v.check("device_execute.abort.raises", wedged)
    cks = glob.glob(os.path.join(ckdir, "ckpt_*"))
    v.check("device_execute.abort.wedge_checkpoint", len(cks) == 1, cks)
    v.check("device_execute.abort.flight_dumped",
            len(glob.glob(os.path.join(art, "FLIGHT_*.json"))) >= 1)
    try:
        v.check("device_execute.abort.resume_bit_identical",
                train({"tpu_checkpoint_dir": ckdir,
                       "tpu_checkpoint_freq": 0}) == ref)
    except Exception as exc:  # noqa: BLE001
        v.check("device_execute.abort.resume_bit_identical", False,
                repr(exc))

    # ---- device_execute x fallback: refused -----------------------------
    try:
        train({"tpu_on_device_error": "fallback"})
        v.check("device_execute.fallback.refused", False, "trained")
    except LightGBMError as exc:
        v.check("device_execute.fallback.refused",
                "CPU fallback of a failed device step" in str(exc), exc)

    # ---- gradients x retry ----------------------------------------------
    faults.configure("gradients:transient@iter=1")
    try:
        v.check("gradients.retry.bit_identical",
                train({"tpu_on_device_error": "retry"}) == ref)
    except Exception as exc:  # noqa: BLE001
        v.check("gradients.retry.bit_identical", False, repr(exc))
    faults.disarm()

    # ---- collective x retry (a guarded call) ----------------------------
    faults.configure("collective:transient")
    calls = []
    try:
        out = DeviceGuard(policy="retry").run(
            lambda: calls.append(1) or 42, point="collective")
        v.check("collective.retry.recovers", out == 42 and len(calls) == 1)
    except Exception as exc:  # noqa: BLE001
        v.check("collective.retry.recovers", False, repr(exc))
    faults.disarm()

    # ---- stall detection ------------------------------------------------
    obs.enable_flight(64)
    faults.configure("device_execute:sleep=0.25@iter=1")
    try:
        train({"tpu_wedge_timeout_s": 0.05})
        stalls = [e for e in obs.flight_snapshot()
                  if e.get("event") == "device_stall"]
        v.check("device_execute.stall.stamped", len(stalls) >= 1)
    except Exception as exc:  # noqa: BLE001
        v.check("device_execute.stall.stamped", False, repr(exc))
    faults.disarm()

    # ---- serve_device: degrade (503), re-probe, recover -----------------
    from lightgbm_tpu_torch.serve import PredictorSession
    bst = lgb.train(dict(P), ds, num_boost_round=n_serve,
                    verbose_eval=False)
    probe = X[:16]
    p_ref = bst.predict(probe)
    sess = PredictorSession(bst, config=dict(
        P, tpu_serve_reprobe_s=0.05, tpu_serve_max_batch=128))
    server = PredictServer(sess).start()
    try:
        faults.configure("serve_device:raise@n=-1")
        try:
            sess.predict(probe)
            refused = False
        except DeviceFailed:
            refused = True
        st1 = sess.stats()
        v.check("serve_device.degrades", bool(st1["degraded"])
                and st1["degraded_transitions"] == 1, st1)
        try:
            code = post(server.url + "/predict",
                        {"rows": probe.tolist()})[0]
        except urllib.error.HTTPError as exc:
            code = exc.code
        v.check("serve_device.degraded_answers_503",
                refused and code == 503, (refused, code))
        faults.disarm()
        time.sleep(0.11)
        out2 = sess.predict(probe)
        st2 = sess.stats()
        v.check("serve_device.reprobe_recovers",
                not st2["degraded"] and st2["recoveries"] == 1, st2)
        v.check("serve_device.device_after_recovery_correct",
                np.allclose(out2, p_ref, atol=1e-6))
    except Exception as exc:  # noqa: BLE001
        v.fail_missing("serve_device.degrades",
                       "serve_device.degraded_answers_503",
                       "serve_device.reprobe_recovers",
                       "serve_device.device_after_recovery_correct")
        print(f"# serve_device leg: {exc!r}", flush=True)
    finally:
        faults.disarm()
        server.stop(close_session=True)

    # ---- explain-plane wedge: degrade and re-probe, isolated ------------
    faults.configure("serve_explain_device:raise@n=-1")
    sess2 = PredictorSession(bst, config=dict(
        P, tpu_serve_reprobe_s=0.05, tpu_serve_max_batch=128))
    server2 = PredictServer(sess2).start()
    try:
        try:
            sess2.explain(X[:4])
            refused = False
        except DeviceFailed:
            refused = True
        stx = sess2.stats()
        v.check("serve_explain.degrade_isolated",
                bool(stx["explain_degraded"]) and not stx["degraded"], stx)
        pok = np.allclose(sess2.predict(probe), p_ref, atol=1e-6)
        v.check("serve_explain.predict_unaffected",
                pok and not sess2.stats()["degraded"])
        try:
            code = post(server2.url + "/explain",
                        {"rows": X[:4].tolist()})[0]
        except urllib.error.HTTPError as exc:
            code = exc.code
        v.check("serve_explain.degraded_answers_503",
                refused and code == 503, (refused, code))
        x_ref = bst.predict(X[:4], pred_contrib=True)
        faults.disarm()                      # let the re-probe succeed
        time.sleep(0.11)
        xout2 = sess2.explain(X[:4])
        stx2 = sess2.stats()
        v.check("serve_explain.reprobe_recovers",
                not stx2["explain_degraded"]
                and np.allclose(xout2, x_ref, atol=1e-5))
        v.check("serve_explain.no_crash", True)
    except Exception as exc:  # noqa: BLE001
        v.fail_missing("serve_explain.degrade_isolated",
                       "serve_explain.predict_unaffected",
                       "serve_explain.degraded_answers_503",
                       "serve_explain.reprobe_recovers")
        v.check("serve_explain.no_crash", False, repr(exc))
    finally:
        faults.disarm()
        server2.stop(close_session=True)

    # ---- checkpoint_write fault survived; corrupt newest skipped --------
    ckdir2 = os.path.join(art, "ckpt2")
    faults.configure("checkpoint_write:raise@call=2")
    try:
        v.check("checkpoint_write.fault_survived",
                train({"tpu_checkpoint_dir": ckdir2,
                       "tpu_checkpoint_freq": 2}) == ref)
    except Exception as exc:  # noqa: BLE001
        v.check("checkpoint_write.fault_survived", False, repr(exc))
    faults.disarm()
    cks = sorted(glob.glob(os.path.join(ckdir2, "ckpt_*")))
    if cks:
        with open(os.path.join(cks[-1], "state.npz"), "ab") as fh:
            fh.write(b"garbage")
        from lightgbm_tpu_torch.config import Config
        from lightgbm_tpu_torch.robust import CheckpointManager
        peeked = CheckpointManager(ckdir2).peek(Config.from_params(
            dict(P, tpu_checkpoint_dir=ckdir2, tpu_checkpoint_freq=2)))
        ok = ((peeked is not None and peeked[0] != cks[-1])
              if len(cks) > 1 else peeked is None)
        v.check("checkpoint.corrupt_newest_skipped", ok,
                f"picked {peeked and peeked[0]}, had {cks}")
    else:
        v.check("checkpoint.corrupt_newest_skipped", False,
                "no checkpoints written")

    # ---- online loop: refit fault / poisoned canary ---------------------
    from lightgbm_tpu_torch.config import Config as _Cfg
    from lightgbm_tpu_torch.online import OnlineLoop, train_continue
    from lightgbm_tpu_torch.serve import ModelRegistry
    from lightgbm_tpu_torch.serve.registry import SwapRejected

    base_path = os.path.join(art, "online_base.txt")
    bst.save_model(base_path)
    ocfg = _Cfg.from_params(dict(
        P, tpu_serve_replicas=1, tpu_serve_rollback_watch_s=0.0,
        tpu_online_refit_every=100, tpu_online_window=400,
        tpu_online_decay=0.5))
    reg2 = ModelRegistry(config=ocfg)
    try:
        reg2.add_model("m", base_path)
        oloop = OnlineLoop(base_path, config=ocfg,
                           push=lambda path: reg2.swap("m", path),
                           params=dict(P))
        faults.configure("online_refit:raise")
        oloop.ingest(X[:200], y[:200])
        rep = oloop.tick()
        faults.disarm()
        live = reg2.resolve("m").version
        v.check("online.refit_fault_no_swap",
                rep is not None and not rep["ok"] and oloop.versions == 0,
                rep)
        v.check("online.refit_fault_old_serving", live == 1, f"live v{live}")
        with open(base_path) as fh:
            txt = fh.read()
        poisoned = os.path.join(art, "online_poisoned.txt")
        with open(poisoned, "w") as fh:
            fh.write(poison(txt))
        try:
            reg2.swap("m", poisoned)
            v.check("online.poisoned_canary_rejects", False,
                    "swap accepted")
        except SwapRejected as exc:
            checks_map = (exc.report or {}).get("checks") or {}
            v.check("online.poisoned_canary_rejects",
                    checks_map.get("finite") is False
                    or checks_map.get("gate") is False, exc.report)
        v.check("online.poisoned_old_serving",
                reg2.resolve("m").version == 1)
    except Exception as exc:  # noqa: BLE001
        v.fail_missing("online.refit_fault_no_swap",
                       "online.refit_fault_old_serving",
                       "online.poisoned_canary_rejects",
                       "online.poisoned_old_serving")
        print(f"# online leg: {exc!r}", flush=True)
    finally:
        faults.disarm()
        reg2.close()

    # ---- crash mid-continuation -> bit-exact resume ---------------------
    n_new = min(len(X), 400)
    Xn = rng.normal(size=(n_new, X.shape[1]))
    yn = (Xn[:, 0] - 0.3 * Xn[:, 2] > 0).astype(np.float64)
    cont_p = {"objective": "binary", "num_leaves": num_leaves,
              "min_data_in_leaf": 5, "verbose": -1, "device_type": device}
    ref_cont = tree_text(train_continue(
        base_path, Xn, yn, params=cont_p,
        num_boost_round=4).model_to_string(num_iteration=-1))
    ckdir3 = os.path.join(art, "online_ckpt")
    crash_p = dict(cont_p, tpu_on_device_error="abort",
                   tpu_checkpoint_dir=ckdir3, tpu_checkpoint_freq=1)
    # the continued run counts the base model's iterations first
    faults.configure(f"device_execute:raise@iter={n_serve + 2}")
    crashed = False
    try:
        train_continue(base_path, Xn, yn, params=crash_p, num_boost_round=4)
    except DeviceWedgedError:
        crashed = True
    faults.disarm()
    v.check("online.continue_crash_raises", crashed)
    try:
        m = tree_text(train_continue(
            base_path, Xn, yn, params=crash_p,
            num_boost_round=4).model_to_string(num_iteration=-1))
        v.check("online.continue_resume_bit_exact", m == ref_cont)
    except Exception as exc:  # noqa: BLE001
        v.check("online.continue_resume_bit_exact", False, repr(exc))

    # ---- streamed ingestion: chunk fault x recovery ---------------------
    from lightgbm_tpu_torch.ingest import (ArraySource, IngestError,
                                           ingest_dataset)
    Xi, yi = X[:min(len(X), 20_000)], y[:min(len(X), 20_000)]
    chunk = max(len(Xi) // 5, 100)
    icfg = _Cfg.from_params({"verbose": -1, "max_bin": 31})
    clean_ing = ingest_dataset(ArraySource(Xi, label=yi, chunk_rows=chunk),
                               icfg)
    faults.configure("ingest_chunk:transient@call=3")
    try:
        d2 = ingest_dataset(ArraySource(Xi, label=yi, chunk_rows=chunk),
                            icfg)
        v.check("ingest.chunk_fault_retry_bit_identical",
                np.array_equal(d2.X_bin, clean_ing.X_bin))
    except Exception as exc:  # noqa: BLE001
        v.check("ingest.chunk_fault_retry_bit_identical", False, repr(exc))
    faults.disarm()

    faults.configure("ingest_chunk:raise@call=2")
    try:
        ingest_dataset(ArraySource(Xi, label=yi, chunk_rows=chunk), icfg)
        v.check("ingest.fatal_chunk_aborts", False, "ingest completed")
    except (DeviceWedgedError, IngestError):
        v.check("ingest.fatal_chunk_aborts", True)
    faults.disarm()

    class _CorruptSource:  # column-count drift mid-stream
        group_sizes = None

        def __iter__(self):
            yield Xi[:100], {"label": yi[:100]}
            yield Xi[100:200, :3], {"label": yi[100:200]}

    try:
        ingest_dataset(_CorruptSource(), icfg)
        v.check("ingest.corrupt_chunk_aborts", False, "ingest completed")
    except IngestError:
        v.check("ingest.corrupt_chunk_aborts", True)

    faults.configure("ingest_chunk:sleep=0.25@call=2")
    try:
        ingest_dataset(ArraySource(Xi, label=yi, chunk_rows=chunk),
                       _Cfg.from_params({"verbose": -1, "max_bin": 31,
                                         "tpu_wedge_timeout_s": 0.05}))
        ing_stalls = [e for e in obs.flight_snapshot()
                      if e.get("event") == "device_stall"
                      and e.get("point") == "ingest_chunk"]
        v.check("ingest.stall_stamped", len(ing_stalls) >= 1)
    except Exception as exc:  # noqa: BLE001
        v.check("ingest.stall_stamped", False, repr(exc))
    faults.disarm()

    # ---- idle cadence: fires, no fresh rows -> skipped ------------------
    sloop = OnlineLoop(base_path, config=ocfg, push=None, params=dict(P))
    sloop.refresh_rows, sloop.refresh_s = 0, 0.01
    time.sleep(0.03)
    srep = sloop.tick()
    stall_events = [e for e in obs.flight_snapshot()
                    if e.get("event") == "online_refresh"
                    and e.get("skipped") == "ingest_stall"]
    v.check("online.ingest_stall_skipped",
            srep is not None and srep.get("skipped") == "ingest_stall"
            and sloop.versions == 0, srep)
    v.check("online.ingest_stall_stamped", len(stall_events) >= 1)

    # ---- serving store: corrupt entry -> loud fallback, same answers ----
    aotdir = os.path.join(art, "aot")
    warm = PredictorSession(bst, config=dict(
        P, tpu_serve_aot_dir=aotdir, tpu_serve_max_batch=64))
    warm.warmup()
    warm.close()
    aot_files = glob.glob(os.path.join(aotdir, "*.aot"))
    v.check("aot.store_written", len(aot_files) >= 1,
            f"{len(aot_files)} entries in {aotdir}")
    for path in aot_files:  # present but garbage
        with open(path, "r+b") as fh:
            fh.truncate(max(1, os.path.getsize(path) // 3))
    obs.enable_flight(64)  # a fresh ring, so the fallbacks stand out
    s_cold = PredictorSession(bst, config=dict(
        P, tpu_serve_aot_dir=aotdir, tpu_serve_max_batch=64))
    try:
        out_cold = s_cold.predict(probe)
        aot_st = (s_cold.stats() or {}).get("aot") or {}
        fb_events = [e for e in obs.flight_snapshot()
                     if e.get("event") == "aot_fallback"]
        v.check("aot.corrupt_falls_back_loudly",
                aot_st.get("fallbacks", 0) >= 1 and len(fb_events) >= 1,
                aot_st)
        with PredictorSession(bst, config=dict(
                P, tpu_serve_max_batch=64)) as s_ref:
            v.check("aot.corrupt_bit_identical",
                    np.array_equal(out_cold, s_ref.predict(probe)))
    except Exception as exc:  # noqa: BLE001
        v.check("aot.corrupt_falls_back_loudly", False, repr(exc))
        v.fail_missing("aot.corrupt_bit_identical")
    finally:
        s_cold.close()

    # ---- arena: byte pressure -> evict, then re-admit -------------------
    from lightgbm_tpu_torch.serve import ForestArena
    bst_b = lgb.train(dict(P), ds, num_boost_round=max(rounds - 2, 1),
                      verbose_eval=False)
    arena = ForestArena(budget_bytes=1, max_batch=64, max_wait_ms=1.0,
                        device=device)
    try:
        arena.admit("ta", bst)
        arena.admit("tb", bst_b)  # the budget evicts the LRU tenant 'ta'
        st_a = arena.stats()
        v.check("arena.pressure_evicts",
                st_a["evictions"] >= 1 and st_a["resident"] == 1, st_a)
        out_a = arena.predict(probe, model="ta")  # re-admits 'ta'
        st_b = arena.stats()
        with PredictorSession(bst, config=dict(
                P, tpu_serve_max_batch=64)) as s_ta:
            v.check("arena.readmit_transparent_bit_identical",
                    st_b["readmissions"] >= 1
                    and np.array_equal(out_a, s_ta.predict(probe)), st_b)
    except Exception as exc:  # noqa: BLE001
        v.fail_missing("arena.pressure_evicts")
        v.check("arena.readmit_transparent_bit_identical", False,
                repr(exc))
    finally:
        arena.close()


def poison(model_text: str) -> str:
    """The model text with every leaf value NaN."""
    return re.sub(r"^leaf_value=.*$",
                  lambda m: "leaf_value=" + " ".join(
                      ["nan"] * len(m.group(0).split("=")[1].split())),
                  model_text, flags=re.MULTILINE)


def child_env(**extra) -> dict:
    """The environment of a process this tool starts: the repository on
    the path, one intra-op thread, no fault armed."""
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    env.pop("LGBM_TPU_FAULTS", None)
    env.update(extra)
    return env


class CliOracle:
    """A never-failed single-process CLI run of a fleet's arguments (its
    own process, fleet keys dropped), started at once so it runs beside
    the fleet; :meth:`trees` waits for it."""

    def __init__(self, params: dict, out_path: str):
        p = {k: v for k, v in params.items()
             if not k.startswith("tpu_fleet")}
        p["output_model"] = self.out_path = out_path
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "lightgbm_tpu_torch",
             *[f"{k}={v}" for k, v in p.items()]],
            env=child_env(), stdout=subprocess.DEVNULL,
            stderr=subprocess.PIPE)

    def trees(self) -> str:
        try:
            _, err = self.proc.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            raise
        if self.proc.returncode != 0:
            raise RuntimeError(f"the oracle's CLI run failed: {err[-2000:]}")
        with open(self.out_path) as fh:
            return tree_text(fh.read())


def fleet_events(fleet_dir: str) -> list:
    from lightgbm_tpu_torch.fleet.launch import EVENTS
    path = os.path.join(fleet_dir, EVENTS)
    if not os.path.exists(path):
        return []
    with open(path) as fh:
        return [json.loads(line) for line in fh]


def launch(params: dict, per_rank_env=None) -> dict:
    """``launch_fleet`` with one intra-op thread a rank."""
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.fleet.launch import launch_fleet
    old = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        return launch_fleet(Config.from_params(params), params,
                            per_rank_env=per_rank_env)
    finally:
        if old is None:
            os.environ.pop("OMP_NUM_THREADS", None)
        else:
            os.environ["OMP_NUM_THREADS"] = old


def write_regression_tsv(path: str, seed: int = 3, rows: int = 120) -> None:
    frng = np.random.default_rng(seed)
    FX = frng.normal(size=(rows, 5))
    Fy = FX[:, 0] * 2.0 + np.sin(FX[:, 1]) + frng.normal(scale=0.1,
                                                          size=rows)
    np.savetxt(path, np.column_stack([Fy, FX]), delimiter="\t", fmt="%.8f")


def fleet_legs(v: Verdict, device: str, art: str) -> None:
    """The four legs of the elastic fleet: 3 ranks over the host TCP
    transport, each against the never-failed single-process CLI run."""
    fdata = os.path.join(art, "fleet_train.tsv")
    write_regression_tsv(fdata)

    def fleet_params(tag, **extra):
        p = {"task": "train", "objective": "regression", "data": fdata,
             "label_column": "0", "num_iterations": "12",
             "num_leaves": "7", "min_data_in_leaf": "5",
             "learning_rate": "0.1", "tpu_ingest": "true",
             "verbosity": "-1", "tpu_fleet": "3",
             "tpu_fleet_transport": "host", "device_type": device,
             "tpu_fleet_heartbeat_s": "3", "tpu_checkpoint_freq": "4",
             "tpu_fleet_dir": os.path.join(art, f"fleet_{tag}"),
             "output_model": os.path.join(art, f"fleet_{tag}.txt")}
        p.update({k: str(val) for k, val in extra.items()})
        return p

    def trees_of(path):
        with open(path) as fh:
            return tree_text(fh.read())

    # a rank killed mid-iteration -> the survivors roll back to the common
    # checkpoint, resume at the shrunk world, bit-exact (heal off)
    t0 = time.time()
    p = fleet_params("kill", tpu_fleet_heal="false")
    try:
        oracle = CliOracle(p, os.path.join(art, "oracle_kill.txt"))
        res = launch(p, per_rank_env={
            1: {"LGBM_TPU_FAULTS": "fleet_die:raise@iter=6"}})
        ev = [e["name"] for e in fleet_events(p["tpu_fleet_dir"])]
        v.check("fleet.rank_killed.survivors_recover",
                res["rc"] == 0 and res["rcs"].get(1) == 137
                and "member_dead" in ev and "resize" in ev, res)
        v.check("fleet.rank_killed.bit_exact",
                trees_of(p["output_model"]) == oracle.trees())
    except Exception as exc:  # noqa: BLE001
        v.check("fleet.rank_killed.survivors_recover", False, repr(exc))
        v.fail_missing("fleet.rank_killed.bit_exact")
    v.leg("fleet.rank_killed", t0)

    # the coordinator killed -> every surviving rank exits 143 with a
    # flight dump, and never hangs
    t0 = time.time()
    p = fleet_params("coord", tpu_fleet_heal="false")
    fldir = os.path.join(art, "fleet_coord_flight")
    try:
        t_coord = time.time()
        res = launch(p, per_rank_env={
            0: {"LGBM_TPU_FAULTS": "fleet_die:raise@iter=6"},
            1: {"LGBM_TPU_FLIGHT": "64", "LGBM_TPU_FLIGHT_DIR": fldir},
            2: {"LGBM_TPU_FLIGHT": "64", "LGBM_TPU_FLIGHT_DIR": fldir}})
        wall = time.time() - t_coord
        v.check("fleet.coordinator_killed.loud_exit",
                res["rcs"].get(0) == 137 and res["rcs"].get(1) == 143
                and res["rcs"].get(2) == 143 and wall < 60, res)
        dumps = glob.glob(os.path.join(fldir, "FLIGHT_*.json"))
        v.check("fleet.coordinator_killed.flight_dumped", len(dumps) >= 2,
                f"{len(dumps)} dumps in {fldir}")
    except Exception as exc:  # noqa: BLE001
        v.check("fleet.coordinator_killed.loud_exit", False, repr(exc))
        v.fail_missing("fleet.coordinator_killed.flight_dumped")
    v.leg("fleet.coordinator_killed", t0)

    # a heartbeat stall: one rank late past stall_frac x heartbeat each
    # iteration -> stamped ``fleet_stall``, not killed
    t0 = time.time()
    p = fleet_params("stall", tpu_fleet_heartbeat_s="3",
                     tpu_fingerprint_freq="1", num_iterations="4")
    try:
        res = launch(p, per_rank_env={
            2: {"LGBM_TPU_FAULTS": "fleet_hb:sleep=2.0@n=-1"}})
        ev = fleet_events(p["tpu_fleet_dir"])
        stalls = [e for e in ev if e["name"] == "fleet_stall"]
        deaths = [e for e in ev if e["name"] == "member_dead"]
        v.check("fleet.stall.stamped_not_killed",
                res["ok"] and len(stalls) >= 1 and not deaths,
                {"res": res, "stalls": len(stalls), "deaths": deaths})
    except Exception as exc:  # noqa: BLE001
        v.check("fleet.stall.stamped_not_killed", False, repr(exc))
    v.leg("fleet.stall", t0)

    # re-join after the heal: iterations slowed so the healed joiner's
    # start-up fits the rest of the run; it folds in mid-run, and the
    # model still equals the never-failed run's
    t0 = time.time()
    p = fleet_params("rejoin", num_iterations=REJOIN_ITERS[device],
                     tpu_fleet_heartbeat_s="4", tpu_checkpoint_freq="5")
    slow = "fleet_hb:sleep=0.5@n=-1"
    try:
        oracle = CliOracle(p, os.path.join(art, "oracle_rejoin.txt"))
        res = launch(p, per_rank_env={
            0: {"LGBM_TPU_FAULTS": slow},
            1: {"LGBM_TPU_FAULTS": slow + ";fleet_die:raise@iter=6"},
            2: {"LGBM_TPU_FAULTS": slow}})
        ev = fleet_events(p["tpu_fleet_dir"])
        joins = [e for e in ev if e["name"] == "member_join_pending"]
        grows = [e for e in ev if e["name"] == "resize" and e.get("joiners")]
        v.check("fleet.rejoin.folds_in_mid_run",
                res["ok"] and res["heals"] == 1 and joins and grows, res)
        v.check("fleet.rejoin.bit_exact_vs_never_failed",
                trees_of(p["output_model"]) == oracle.trees())
    except Exception as exc:  # noqa: BLE001
        v.check("fleet.rejoin.folds_in_mid_run", False, repr(exc))
        v.fail_missing("fleet.rejoin.bit_exact_vs_never_failed")
    v.leg("fleet.rejoin", t0)


def run_matrix(device: str, legs: str = "all", X=None, y=None,
               rounds: int = 6, num_leaves: int = 7,
               quiet: bool = False) -> dict:
    """The matrix's record.  ``legs``: ``all``, ``in_process`` (every leg
    but the fleet's) or ``fleet``.  ``X``/``y`` replace the default
    500 x 6 data of the in-process legs."""
    from lightgbm_tpu_torch import obs
    from lightgbm_tpu_torch.robust import faults
    v = Verdict("fault_matrix", quiet=quiet)
    art = tempfile.mkdtemp(prefix="fault_matrix_")
    old_dir = os.environ.get("LGBM_TPU_FLIGHT_DIR")
    os.environ["LGBM_TPU_FLIGHT_DIR"] = art
    k0 = k1_launches()
    ring = obs.flight_len()
    try:
        if legs in ("all", "in_process"):
            if X is None:
                X, y = default_data()
            in_process_legs(v, device, art, X, y, rounds, num_leaves)
        if legs in ("all", "fleet"):
            fleet_legs(v, device, art)
    finally:
        faults.disarm()
        obs.reset()
        obs.enable_flight(ring)
        if old_dir is None:
            os.environ.pop("LGBM_TPU_FLIGHT_DIR", None)
        else:
            os.environ["LGBM_TPU_FLIGHT_DIR"] = old_dir
    return v.record(device=device, legs=legs,
                    k1_launches=k1_launches() - k0, artifacts_dir=art)


def main(argv=None) -> int:
    ap = device_parser("The fault-injection matrix on the port")
    ap.add_argument("--legs", default="all",
                    choices=("all", "in_process", "fleet"),
                    help="which legs to run (default all)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if device is None:
        return 2
    return emit(run_matrix(device, legs=args.legs), args.json)


if __name__ == "__main__":
    sys.exit(main())
