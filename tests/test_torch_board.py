"""The train board (``lightgbm_tpu_torch/obs/board.py``) against the JAX
package's: one event sequence fed to both renders the same Prometheus
series and the same ``/progress`` keys; a port training is scraped over
HTTP while it runs (``/metrics``, ``/progress`` with the device guard's
``watchdog`` provider, ``/debug/flight``); the port resolves the port
number as the JAX package does, except that the parameter's 0 takes a
free port (the JAX package reads it as off, ROADMAP.md §3.12); the ETA
counts this run's iterations; the fleet's heartbeat hands the board its
providers."""
import json
import urllib.request

import pytest

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import obs
from lightgbm_tpu_torch.obs import board, core


@pytest.fixture(autouse=True)
def _one_cpu_thread():
    """One intra-op thread a test, the flight ring off (a serving session
    or a guarded training of an earlier file in this process may have
    armed it: the board arms only a ring that is off); each restored
    after, and the board's records reset."""
    import torch
    prev = torch.get_num_threads()
    ring = obs.flight_len()
    torch.set_num_threads(1)
    obs.enable_flight(0)
    yield
    torch.set_num_threads(prev)
    b = board.current()
    if b is not None:
        b.stop()
    obs.reset()
    obs.enable_flight(ring)


def _get(url, timeout=10):
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.status, resp.read()


# one sequence of events: iterations, a checkpoint and a restore, a retry
# and a stall, a failed health check, a straggler, a reconciliation
_EVENTS = (
    [("iteration", dict(iteration=i, iter_s=0.1, recompiles=0,
                        metrics={"training.auc": 0.9},
                        phase_s={"tree growth": 0.07,
                                 "boosting (grad/hess)": 0.02},
                        cum_row_iters_per_s=1e6)) for i in range(3)]
    + [("checkpoint", dict(iteration=3, path="ck")),
       ("restore", dict(iteration=3, path="ck")),
       ("retry", dict(point="device_execute", attempt=0,
                      classify="transient", action="retry")),
       ("device_stall", dict(point="device_execute", elapsed_s=1.0,
                             deadline_s=0.5)),
       ("health", dict(check="grad", phase="tree growth", iteration=2,
                       mode="monitor", ok=False)),
       ("straggler", dict(rank=1, phase="tree growth", iteration=2,
                          ratio=3.0, median_s=0.01, rank_s=0.03,
                          consecutive=3, breach=True)),
       ("reconciliation", dict(iteration=2, units={
           "tree_growth": {"measured_s": 0.07, "modeled_s": 0.001,
                           "ratio": 70.0}}))])


def _series(text):
    """Every series name of a Prometheus text (samples and TYPE lines)."""
    names = set()
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            names.add(line.split()[2])
        elif line and not line.startswith("#"):
            names.add(line.split("{")[0].split()[0])
    return names


def _render(mod_board, mod_obs, mod_core):
    mod_obs.reset()
    b = mod_board.TrainBoard(total_rounds=10, port=0)
    b.start()
    try:
        for name, fields in _EVENTS:
            mod_core.event(name, **fields)
        text = b.metrics_text()
        prog = b.progress()
        status, body = _get(b.url + "/metrics")
        assert status == 200 and _series(body.decode()) == _series(text)
    finally:
        b.stop()
        mod_obs.reset()
    return text, prog


def test_same_series_and_progress_keys_as_the_jax_board():
    pytest.importorskip("jax")
    from lightgbm_tpu import obs as jobs
    from lightgbm_tpu.obs import board as jboard
    from lightgbm_tpu.obs import core as jcore
    ref_text, ref_prog = _render(jboard, jobs, jcore)
    text, prog = _render(board, obs, core)
    assert _series(text) == _series(ref_text)
    assert len(_series(text)) >= 25
    assert set(prog) == set(ref_prog)
    assert set(prog["checkpoint"]) == set(ref_prog["checkpoint"])
    for key in ("iteration", "completed", "eta_s", "ema_iter_s",
                "row_iters_per_s", "vs_baseline", "restores",
                "stragglers", "reconciliation"):
        assert prog[key] == ref_prog[key], key
    # the same baseline: LightGBM's OpenCL GPU run on HIGGS
    assert board.baseline_row_iters_per_s() == pytest.approx(
        10_500_000 * 500 / 238.5)
    for line in ("tpu_train_stragglers_total 1",
                 "tpu_train_restores_total 1", "tpu_train_retries_total 1",
                 "tpu_train_health_failures_total 1",
                 'tpu_train_reconciliation_ratio{unit="tree_growth"} 70'):
        assert line in text and line in ref_text, line


def test_training_is_scraped_mid_run():
    import numpy as np
    rng = np.random.default_rng(3)
    X = rng.normal(size=(400, 5))
    y = (X[:, 0] > 0).astype(np.float64)
    seen = {}

    def scrape(env):
        if env.iteration == 2:
            b = board.current()
            seen["metrics"] = _get(b.url + "/metrics")[1].decode()
            seen["progress"] = json.loads(_get(b.url + "/progress")[1])
            seen["flight"] = json.loads(_get(b.url + "/debug/flight")[1])
    params = {"objective": "binary", "num_leaves": 7, "verbose": -1,
              "min_data_in_leaf": 10, "tpu_train_metrics_port": 0}
    lt.train(params, lt.Dataset(X, label=y), 5, device="cpu",
             callbacks=[scrape])
    assert not board.active()
    m = seen["metrics"]
    assert "tpu_train_iteration 2" in m
    assert "tpu_train_total_rounds 5" in m
    assert 'tpu_train_phase_seconds{phase="tree growth"}' in m
    assert "tpu_train_watchdog_active 0" in m
    p = seen["progress"]
    assert p["iteration"] == 2 and p["completed"] == 3
    assert p["watchdog"]["policy"] == "retry"
    assert len(p["recent"]) == 3 and p["eta_s"] > 0
    assert seen["flight"]["enabled"]
    assert not obs.flight_enabled()   # the board disarmed what it armed


def test_resolve_port(monkeypatch):
    cfg = lt.Config.from_params({"tpu_train_metrics_port": 8123})
    monkeypatch.delenv("LGBM_TPU_TRAIN_METRICS", raising=False)
    assert board.resolve_port(cfg) == 8123
    assert board.resolve_port(None) is None
    assert board.resolve_port(lt.Config()) is None
    assert board.resolve_port(
        lt.Config.from_params({"tpu_train_metrics_port": 0})) == 0
    for env, want in (("0", 0), ("off", None), ("-1", None),
                      ("not-a-port", None), ("9000", 9000)):
        monkeypatch.setenv("LGBM_TPU_TRAIN_METRICS", env)
        assert board.resolve_port(cfg) == want, env


def test_eta_counts_this_run():
    """A board resumed at 80 of 100, fed 5 iterations of 0.1 s: the ETA
    is the 15 rounds left at the smoothed rate."""
    b = board.TrainBoard(total_rounds=100, start_round=80, port=0)
    b.start()
    try:
        for i in range(80, 85):
            core.event("iteration", iteration=i, iter_s=0.1,
                       phase_s={}, cum_row_iters_per_s=1e6)
        pr = b.progress()
        assert pr["start_round"] == 80 and pr["completed"] == 5
        assert pr["eta_s"] == pytest.approx(1.5, rel=0.01)
        assert pr["frac"] == pytest.approx(0.85)
    finally:
        b.stop()


def test_fleet_heartbeat_arms_the_board_providers():
    from lightgbm_tpu_torch.fleet.health import FleetHeartbeatCallback

    class _Client:
        world, shard, mid, epoch = 3, 1, "m1", 2

    class _Hub:
        def snapshot(self):
            return {"members": 3}

    class _Session:
        client, hub, view, recoveries = _Client(), _Hub(), {}, 0

        def snapshot(self):
            return {"world": 3, "rank": 1, "member": "m1", "epoch": 2,
                    "recoveries": 0, "dead": [], "pending_join": 0,
                    "members": {}}

    b = board.TrainBoard(total_rounds=4, port=0)
    b.start()
    try:
        FleetHeartbeatCallback(_Session(), 1)._arm_board()
        pr = b.progress()
        assert pr["fleet"]["world"] == 3 and pr["fleet_hub"]["members"] == 3
        assert "tpu_train_fleet_world_size 3" in b.metrics_text()
    finally:
        b.stop()


def test_board_arms_the_iteration_record(monkeypatch):
    """The trainer builds its iteration record (metrics included) only
    when something reads it: with no sink and no board, never; with the
    board armed, every iteration."""
    import numpy as np
    from lightgbm_tpu_torch.boosting.gbdt import GBDT
    calls = []
    orig = GBDT._emit_iteration_record

    def counted(self, *a, **kw):
        calls.append(self.iter_)
        return orig(self, *a, **kw)
    monkeypatch.setattr(GBDT, "_emit_iteration_record", counted)
    monkeypatch.delenv("LGBM_TPU_TRAIN_METRICS", raising=False)
    rng = np.random.default_rng(4)
    X = rng.normal(size=(300, 4))
    y = (X[:, 1] > 0).astype(np.float64)
    params = {"objective": "binary", "num_leaves": 5, "verbose": -1}
    lt.train(params, lt.Dataset(X, label=y), 2, device="cpu")
    assert calls == [] and core._board_hook is None
    lt.train(dict(params, tpu_train_metrics_port=0),
             lt.Dataset(X, label=y), 2, device="cpu")
    assert calls == [0, 1] and core._board_hook is None
