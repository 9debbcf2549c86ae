"""The online loop (``lightgbm_tpu_torch/online/loop.py``), ``task=refit``
and ``task=online`` against the JAX package's (twins of the loop cases of
tests/test_online.py, of tests/test_drift.py's online-loop case and of
tests/test_cli.py's ``task=refit``), on the CPU.

- the loop's cadence, bounded window and ingest stall (its flight-ring
  event), refresh by refresh against the JAX package's loop on the same
  model file and rows: the same counters and reports, and refit leaves
  within 1e-6;
- an ``online_refit`` fault is a failed refresh that keeps the old base;
- continue mode adds ``tpu_online_trees`` trees whose thresholds are the
  base model's;
- ``read_label_stream`` yields the JAX package's batches, and in follow
  mode heartbeats while idle and joins a line written in two parts;
- the loop carries the quality windows of a model's sidecar;
- ``task=refit`` keeps the structure, moves the leaves, and agrees with
  ``Booster.refit`` (1e-10) and the JAX package's refit (1e-6);
- ``run_online`` in process over HTTP on a finite stream: its pushes go
  through ``POST /models/{name}/swap``, and ``/metrics`` carries the
  ``tpu_online_*`` series under the JAX package's names, equal to the
  loop's ``stats()``."""
import json
import os
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import obs
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.online import (OnlineLoop, read_label_stream,
                                       run_online)
from lightgbm_tpu_torch.robust import faults

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARAMS = {"objective": "binary", "num_leaves": 15, "learning_rate": 0.1,
          "min_data_in_leaf": 5, "verbose": -1}
CPU = dict(PARAMS, device_type="cpu")


@pytest.fixture(autouse=True)
def _clean():
    faults.disarm()
    yield
    faults.disarm()
    obs.disable()
    obs.enable_flight(0)
    obs.reset()


@pytest.fixture(autouse=True)
def _one_cpu_thread():
    """One intra-op thread a test: a parallel test run shares the machine
    among its workers, and torch's CPU thread pool then spends most of a
    small op waiting for oversubscribed threads (these tests ran 10-60x
    slower there).  Restored after each test."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def jlgb():
    pytest.importorskip("jax")
    import lightgbm_tpu
    return lightgbm_tpu


def _problem(n=1200, seed=0, f=6):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f))
    y = (X[:, 0] + X[:, 1] * X[:, 2] + 0.2 * rng.normal(size=n) > 0)
    return X, y.astype(np.float64)


class _Cfg:
    tpu_online_mode = "refit"
    tpu_online_window = 500
    tpu_online_refit_every = 300
    tpu_online_refit_every_s = 0.0
    tpu_online_trees = 3
    tpu_online_decay = 0.6
    refit_decay_rate = 0.9


def _base_model(tmp_path, seed=14, **train_kw):
    X, y = _problem(n=800, seed=seed)
    bst = lt.train(PARAMS, lt.Dataset(X, label=y, free_raw_data=False), 4,
                   device="cpu", **train_kw)
    path = str(tmp_path / "base.txt")
    bst.save_model(path)
    return path, bst, X, y


def _leaves(path):
    return [t.leaf_value for t in
            lt.Booster(model_file=path, device="cpu")._gbdt.models]


def test_online_loop_cadence_window_and_stall(jlgb, tmp_path):
    """Refresh by refresh, the port's loop and the JAX package's on the
    same base file and rows: the cadence, the bounded window, the adopted
    base, refit leaves within 1e-6, and the ingest stall skipped with an
    ``online_refresh`` event in the flight ring (valid under the JAX
    package's schema)."""
    from lightgbm_tpu.online import OnlineLoop as JLoop
    path, _, X, y = _base_model(tmp_path)
    pushed, jpushed = [], []
    loop = OnlineLoop(path, config=_Cfg(), workdir=str(tmp_path / "p"),
                      push=lambda p: pushed.append(p) or {"ok": True},
                      params=CPU)
    jloop = JLoop(path, config=_Cfg(), workdir=str(tmp_path / "j"),
                  push=lambda p: jpushed.append(p) or {"ok": True},
                  params=dict(PARAMS))
    for lp in (loop, jloop):
        lp.ingest(X[:200], y[:200])
        assert lp.tick() is None           # not due yet
        lp.ingest(X[200:800], y[200:800])
        assert len(lp._X) == 500           # the oldest rows fell out
    rep, jrep = loop.tick(), jloop.tick()
    assert rep["ok"] and rep["version"] == 1 and rep["rows"] == 500
    assert {k: rep[k] for k in ("ok", "version", "rows", "mode")} == \
        {k: jrep[k] for k in ("ok", "version", "rows", "mode")}
    assert loop.base == pushed[0] and len(pushed) == 1
    for a, b in zip(_leaves(loop.base), _leaves(jloop.base)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    assert max(float(np.abs(a - b).max()) for a, b in
               zip(_leaves(loop.base), _leaves(path))) > 1e-3
    # the time cadence with no fresh rows: an ingest stall
    loop.refresh_rows, loop.refresh_s = 0, 0.01
    time.sleep(0.02)
    obs.enable_flight(32)
    rep2 = loop.tick()
    stamped = [e for e in obs.flight_snapshot()
               if e.get("event") == "online_refresh"
               and e.get("skipped") == "ingest_stall"]
    assert rep2 == {"ok": False, "skipped": "ingest_stall"}
    assert loop.versions == 1 and loop.skipped == 1 and len(stamped) == 1
    from importlib import import_module
    report = import_module("lightgbm_tpu.obs.report")
    assert report.validate_events(stamped) == []
    st, jst = loop.stats(), jloop.stats()
    assert set(st) == set(jst)


def test_online_loop_refit_fault_keeps_old_base(tmp_path):
    path, _, X, y = _base_model(tmp_path)
    pushed = []
    loop = OnlineLoop(path, config=_Cfg(), workdir=str(tmp_path / "v"),
                      push=lambda p: pushed.append(p) or {"ok": True},
                      params=CPU)
    loop.ingest(X[:400], y[:400])
    faults.configure("online_refit:raise")
    try:
        rep = loop.tick()
    finally:
        faults.disarm()
    assert not rep["ok"] and "FaultInjected" in rep["error"]
    assert loop.base == path and not pushed and loop.failed == 1
    # the next cycle recovers from the same base
    loop.ingest(X[400:800], y[400:800])
    rep2 = loop.tick()
    assert rep2["ok"] and len(pushed) == 1 and loop.base == pushed[0]


def test_online_loop_continue_mode(tmp_path):
    """Continue mode boosts ``tpu_online_trees`` trees onto the base in
    its own bin space: every new threshold is one of the base model's."""
    cfg = _Cfg()
    cfg.tpu_online_mode = "continue"
    path, base, X, y = _base_model(tmp_path, seed=15)
    loop = OnlineLoop(path, config=cfg, push=None,
                      workdir=str(tmp_path / "v"),
                      params=dict(CPU, num_leaves=7))
    loop.ingest(X[:400], y[:400])
    assert loop.tick()["ok"]
    cont = lt.Booster(model_file=loop.base, device="cpu")
    assert cont.num_trees() == 4 + cfg.tpu_online_trees
    base_thr = {float(t) for tr in base._gbdt.models
                for t in tr.threshold[:max(tr.num_leaves - 1, 0)]}
    for tr in cont._gbdt.models[4:]:
        for i in range(max(tr.num_leaves - 1, 0)):
            assert float(tr.threshold[i]) in base_thr


def test_online_knobs_train():
    """The refit and online parameters are accepted by training (they
    were refused before online/ was ported)."""
    X, y = _problem(n=300)
    for extra in ({"tpu_online_mode": "continue"},
                  {"refit_decay_rate": 0.5, "tpu_refit_device": False}):
        bst = lt.train({**PARAMS, **extra}, lt.Dataset(X, label=y), 1,
                       device="cpu")
        assert bst.num_trees() == 1
    with pytest.raises(lt.LightGBMError, match="tpu_online_mode"):
        Config.from_params({"tpu_online_mode": "sometimes"})
    with pytest.raises(lt.LightGBMError, match="refresh cadence"):
        Config.from_params({"task": "online", "tpu_online_refit_every": 0})


def test_read_label_stream(jlgb, tmp_path):
    from lightgbm_tpu.online import read_label_stream as jread
    path = str(tmp_path / "s.jsonl")
    with open(path, "w") as fh:
        for i in range(5):
            fh.write(json.dumps({"x": [float(i), 2.0], "y": i % 2}) + "\n")
        fh.write("not json\n")
        fh.write(json.dumps({"features": [9.0, 9.0], "label": 1.0}) + "\n")
    got = list(read_label_stream(path, batch_rows=4))
    want = list(jread(path, batch_rows=4))
    assert len(got) == len(want) == 2
    for (a, b), (c, d) in zip(got, want):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)
    X = np.concatenate([b[0] for b in got])
    assert X.shape == (6, 2) and X[-1, 0] == 9.0


def test_read_label_stream_follow_heartbeats_and_fragments(tmp_path):
    """Follow mode yields None heartbeats while idle, joins a line written
    in two parts, and skips a row of another width."""
    path = str(tmp_path / "s.jsonl")
    open(path, "w").close()

    def feeder():
        time.sleep(0.2)
        with open(path, "a") as fh:
            fh.write(json.dumps({"x": [1.0, 2.0], "y": 1.0}) + "\n")
            line = json.dumps({"x": [7.0, 7.0], "y": 0.0}) + "\n"
            fh.write(line[:9])
            fh.flush()
            time.sleep(0.3)
            fh.write(line[9:])
            fh.write(json.dumps({"x": [1.0], "y": 0.0}) + "\n")

    t = threading.Thread(target=feeder)
    t.start()
    stop_at = time.monotonic() + 1.6
    hb = rows = 0
    for batch in read_label_stream(path, follow=True, poll_s=0.05,
                                   stop=lambda: time.monotonic() > stop_at):
        if batch is None:
            hb += 1
        else:
            assert batch[0].shape[1] == 2
            rows += batch[0].shape[0]
    t.join()
    assert hb >= 3 and rows == 2


def test_online_loop_carries_quality_and_refresh_age(jlgb, tmp_path):
    """The twin of tests/test_drift.py's online-loop case: a tracker armed
    from the model's sidecar scores the loop's labeled batches, as the
    JAX package's tracker does on the same scores."""
    from lightgbm_tpu.serve.quality import QualityTracker as JTracker
    from lightgbm_tpu_torch.obs.drift import QualityProfile, profile_path
    from lightgbm_tpu_torch.serve.quality import QualityTracker
    path, bst, X, y = _base_model(tmp_path, keep_training_booster=True)
    prof = QualityProfile.load(profile_path(path))

    def fn(rows):
        return bst.predict(rows, raw_score=True)
    loop = OnlineLoop(path, config=_Cfg(), workdir=str(tmp_path / "v"))
    loop.quality = QualityTracker(
        fn, prof, config=Config.from_params({"tpu_quality_window": 128}))
    jt = JTracker(fn, prof, config=Config.from_params(
        {"tpu_quality_window": 128}))
    loop.ingest(X[:256], y[:256])
    jt.add(X[:256], y[:256])
    st = loop.stats()
    assert st["rows_ingested"] == 256 and st["last_refresh_age_s"] >= 0.0
    assert st["quality"]["windows"] == jt.windows == 2
    assert st["quality"]["last"]["auc"] > 0.8
    assert abs(st["quality"]["last"]["auc"] - jt.last["auc"]) <= 1e-12


def _run_cli(args, cwd):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"      # as _one_cpu_thread, for the child
    r = subprocess.run([sys.executable, "-m", "lightgbm_tpu_torch"] + args,
                       cwd=cwd, env=env, capture_output=True, text=True,
                       timeout=420)
    assert r.returncode == 0, r.stderr[-2000:]
    return r


def test_cli_task_refit(jlgb, tmp_path):
    """task=refit on flipped labels keeps every tree's structure, moves
    the leaves, writes what ``Booster.refit`` gives on the same rows
    (predictions within 1e-10), and agrees with the JAX package's refit
    of the same model file (leaves within 1e-6)."""
    X, y = _problem(n=800, seed=9, f=4)
    bst = lt.train(PARAMS, lt.Dataset(X, label=y), 8, device="cpu")
    bst.save_model(str(tmp_path / "model.txt"))
    np.savetxt(tmp_path / "new.train", np.column_stack([1 - y, X]),
               delimiter="\t", fmt="%.8f")
    (tmp_path / "refit.conf").write_text(
        "task = refit\nobjective = binary\ndata = new.train\n"
        "input_model = model.txt\noutput_model = refitted.txt\n"
        "device_type = cpu\nverbosity = -1\n")
    _run_cli(["config=refit.conf"], tmp_path)
    orig = lt.Booster(model_file=str(tmp_path / "model.txt"), device="cpu")
    refit = lt.Booster(model_file=str(tmp_path / "refitted.txt"),
                       device="cpu")
    for a, b in zip(orig._gbdt.models, refit._gbdt.models):
        assert a.num_leaves == b.num_leaves
        np.testing.assert_array_equal(a.split_feature, b.split_feature)
        np.testing.assert_array_equal(a.threshold, b.threshold)
    data = np.loadtxt(tmp_path / "new.train", delimiter="\t")
    Xf, yf = data[:, 1:], data[:, 0]
    assert not np.allclose(orig.predict(Xf), refit.predict(Xf))
    inproc = orig.refit(Xf, yf, decay_rate=0.9)
    np.testing.assert_allclose(refit.predict(Xf), inproc.predict(Xf),
                               rtol=0, atol=1e-10)
    ref = jlgb.Booster(model_file=str(tmp_path / "model.txt")).refit(
        Xf, yf, decay_rate=0.9)
    for a, b in zip(ref._gbdt.models, refit._gbdt.models):
        np.testing.assert_allclose(b.leaf_value, a.leaf_value, rtol=0,
                                   atol=1e-6)


JAX_ONLINE_SERIES = {
    'tpu_online_refresh_total{outcome="pushed"}',
    'tpu_online_refresh_total{outcome="rejected"}',
    'tpu_online_refresh_total{outcome="failed"}',
    'tpu_online_refresh_total{outcome="skipped"}',
    "tpu_online_swap_rejected_total", "tpu_online_rows_ingested_total",
    "tpu_online_last_refresh_age_seconds"}


def test_run_online_over_http(tmp_path):
    """``run_online`` in process: a finite stream of 1,000 labeled rows at
    a 300-row cadence makes two versions, each pushed through this
    process's ``POST /models/default/swap``; the fleet's ``/metrics``
    carries the ``tpu_online_*`` series (the JAX package's names, those
    of tests/test_drift.py) equal to the loop's ``stats()``; the quality
    windows are armed from the sidecar; the refreshes' events are valid
    under the JAX package's schema."""
    from lightgbm_tpu_torch.serve import parse_prometheus
    path, _, _, _ = _base_model(tmp_path, keep_training_booster=True)
    Xs, ys = _problem(n=1000, seed=31)
    stream = tmp_path / "labels.jsonl"
    with open(stream, "w") as fh:
        for xr, yr in zip(Xs, ys):
            fh.write(json.dumps({"x": xr.tolist(), "y": yr}) + "\n")
    cfg = Config.from_params({
        "task": "online", "input_model": path, "device_type": "cpu",
        "tpu_online_source": str(stream), "tpu_online_refit_every": 300,
        "tpu_online_window": 500, "tpu_online_dir": str(tmp_path / "v"),
        "tpu_serve_replicas": 1, "tpu_serve_rollback_watch_s": 0,
        "tpu_quality_window": 200, "verbose": -1})
    seen = {}

    def on_drained(loop, reg, server):
        with urllib.request.urlopen(server.url + "/metrics",
                                    timeout=30) as r:
            seen["metrics"] = parse_prometheus(r.read().decode())
        seen["stats"] = loop.stats()
        seen["live"] = reg.resolve(None).version
        rows = Xs[:16]
        req = urllib.request.Request(
            server.url + "/predict",
            data=json.dumps({"rows": rows.tolist()}).encode())
        with urllib.request.urlopen(req, timeout=30) as r:
            seen["reply"] = json.loads(r.read())

    obs.enable_flight(64)
    st = run_online(cfg, {"device_type": "cpu", "verbose": -1},
                    on_drained=on_drained)
    events = [e for e in obs.flight_snapshot()
              if e.get("event") == "online_refresh"]
    assert st["versions"] == 2 and st["failed"] == 0
    assert st["rejected"] == 0 and st["rows_ingested"] == 1000
    assert seen["live"] == 3 and seen["reply"]["version"] == 3
    want = lt.Booster(model_file=st["base"], device="cpu").predict(Xs[:16])
    np.testing.assert_allclose(seen["reply"]["predictions"], want, rtol=0,
                               atol=1e-6)
    m = seen["metrics"]
    assert JAX_ONLINE_SERIES <= set(m)
    assert m['tpu_online_refresh_total{outcome="pushed"}'] == 2
    assert m['tpu_online_refresh_total{outcome="failed"}'] == 0
    assert m["tpu_online_rows_ingested_total"] == 1000
    assert seen["stats"]["quality"]["windows"] == 5
    assert [e["ok"] for e in events] == [True, True]
    pytest.importorskip("jax")
    from importlib import import_module
    report = import_module("lightgbm_tpu.obs.report")
    assert report.validate_events(events) == []


def test_fleet_metrics_online_series_equal_jax(jlgb, tmp_path):
    """With the same online provider parked on each package's registry,
    the ``tpu_online_*`` lines of the fleet exposition are the JAX
    package's, line for line; a provider that raises leaves the scrape
    whole, without the series."""
    from lightgbm_tpu.config import Config as JConfig
    from lightgbm_tpu.serve.metrics import render_prometheus_fleet as jrender
    from lightgbm_tpu.serve.registry import ModelRegistry as JRegistry
    from lightgbm_tpu_torch.serve import ModelRegistry
    from lightgbm_tpu_torch.serve.metrics import render_prometheus_fleet
    path, _, _, _ = _base_model(tmp_path)
    stats = {"versions": 3, "rejected": 1, "failed": 0, "skipped": 2,
             "rows_ingested": 640, "last_refresh_age_s": 1.5}
    params = {"verbose": -1, "tpu_serve_rollback_watch_s": 0}

    def online_lines(text):
        return [ln for ln in text.splitlines() if "tpu_online_" in ln]
    reg = ModelRegistry(config=params, n_replicas=1, device="cpu")
    jreg = JRegistry(config=JConfig.from_params(params), n_replicas=1)
    try:
        reg.add_model("default", path)
        jreg.add_model("default", path)
        reg.online_provider = jreg.online_provider = lambda: dict(stats)
        ours = online_lines(render_prometheus_fleet(reg))
        assert len(ours) == 15 and ours == online_lines(jrender(jreg))

        def dead():
            raise RuntimeError("the loop is gone")
        reg.online_provider = dead
        text = render_prometheus_fleet(reg)
        assert "tpu_serve_models 1" in text and not online_lines(text)
    finally:
        reg.close()
        jreg.close()
