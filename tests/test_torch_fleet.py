"""The serving fleet (``lightgbm_tpu_torch/serve/router.py``,
``registry.py``, ``robust/watchdog.py CircuitBreaker``) against the JAX
package's on the CPU, on JAX-trained model files (the fixture of
tests/test_fleet.py):

- the circuit breaker walks the JAX package's states on the same
  failure sequence;
- failover on a wedged replica, draining, an all-down fleet, a degraded
  replica's sibling answering (no host fallback);
- swap and rollback, a canary rejection, an injected swap fault, the
  post-swap automatic rollback, a swap under concurrent mixed traffic
  that loses nothing and answers every request from exactly one version;
- priority shedding: low sheds first, an unknown priority serves as
  normal;
- the HTTP fleet round trip and the Prometheus exposition parsed back:
  every series of the port is one of the JAX package's, and those it
  leaves out are the documented ones.
"""
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.robust import faults
from lightgbm_tpu_torch.robust.watchdog import CircuitBreaker
from lightgbm_tpu_torch.serve import (DeviceFailed, ModelRegistry,
                                      NoReplicaAvailable, PredictorSession,
                                      PredictServer, ReplicaRouter,
                                      ServeOverloadError, SwapRejected,
                                      parse_prometheus)
from lightgbm_tpu_torch.serve.router import replica_devices

TIMEOUT = 60
P = {"objective": "binary", "num_leaves": 7, "min_data_in_leaf": 5,
     "verbose": -1}


@pytest.fixture(autouse=True)
def _disarm():
    faults.disarm()
    yield
    faults.disarm()


@pytest.fixture(scope="module")
def fleet_models(tmp_path_factory):
    """Two JAX-trained models over one feature space whose predictions
    differ, saved to files, their host predictions, and the probe rows."""
    pytest.importorskip("jax")
    import lightgbm_tpu as jlgb
    rng = np.random.default_rng(3)
    X = rng.normal(size=(500, 6))
    X[rng.random(X.shape) < 0.04] = np.nan
    y = (np.nan_to_num(X[:, 0]) - 0.4 * np.nan_to_num(X[:, 2]) > 0
         ).astype(np.float64)
    b1 = jlgb.train(P, jlgb.Dataset(X, label=y, params=P), num_boost_round=4)
    P2 = dict(P, num_leaves=5, learning_rate=0.2)
    b2 = jlgb.train(P2, jlgb.Dataset(X, label=y, params=P2),
                    num_boost_round=6)
    d = tmp_path_factory.mktemp("tfleet")
    m1, m2 = str(d / "m1.txt"), str(d / "m2.txt")
    b1.save_model(m1)
    b2.save_model(m2)
    return m1, b1, m2, b2, X


def _params(**over):
    return {**P, "tpu_serve_max_batch": 64, "tpu_serve_max_wait_ms": 1.0,
            "tpu_serve_canary_rows": 16, "tpu_serve_canary_probes": 2,
            "tpu_serve_rollback_watch_s": 0.0, "tpu_serve_reprobe_s": 0.0,
            **over}


def _cfg(**over):
    return Config.from_params(_params(**over))


def _close(a, b, atol=1e-6):
    return np.allclose(a, b, rtol=0, atol=atol)


# ---------------------------------------------------------------------
# circuit breaker
# ---------------------------------------------------------------------

def _walk(br, steps):
    """Drive a breaker through (op, arg) steps; return its states."""
    out = []
    for op, arg in steps:
        if op == "fail":
            br.record_failure(arg)
        elif op == "ok":
            br.record_ok()
        elif op == "sleep":
            time.sleep(arg)
        elif op == "allow":
            out.append(br.allow())
        out.append((br.state, br.opens, br.consecutive))
    return out


def test_breaker_trips_and_half_opens():
    pytest.importorskip("jax")
    from lightgbm_tpu.robust.watchdog import CircuitBreaker as JBreaker
    hiccup = RuntimeError("UNAVAILABLE: hiccup")
    steps = [("allow", None), ("fail", hiccup), ("fail", hiccup),
             ("allow", None), ("sleep", 0.45), ("allow", None),
             ("allow", None), ("ok", None), ("allow", None)]
    # the first backoff is 0.3-0.375 s: the open-state checks before the
    # sleep stay well inside it
    kw = dict(trip_after=2, backoff_base_s=0.3, backoff_cap_s=0.5, seed=0)
    got = _walk(CircuitBreaker(**kw), steps)
    assert got == _walk(JBreaker(**kw), steps)
    # one transient is not a trip; two are; one half-open probe; closed
    assert got[2] == ("closed", 0, 1) and got[3] == ("open", 1, 2)
    assert got[7:9] == [True, ("half_open", 1, 2)] and got[9] is False
    assert got[-2:] == [True, ("closed", 1, 0)]


def test_breaker_fatal_trips_and_reopens_on_probe_failure():
    br = CircuitBreaker(trip_after=5, backoff_base_s=0.03,
                        backoff_cap_s=0.05, seed=1)
    assert br.record_failure(ValueError("nonsense")) == "fatal"
    assert br.state == "open" and br.opens == 1
    time.sleep(0.05)
    assert br.allow()                    # the half-open probe
    br.record_failure(RuntimeError("UNAVAILABLE: still dead"))
    assert br.state == "open" and br.opens == 2
    snap = br.snapshot()
    assert snap["failures"] == 2 and "still dead" in snap["last_error"]


# ---------------------------------------------------------------------
# replica router
# ---------------------------------------------------------------------

def test_replica_devices(monkeypatch):
    assert replica_devices(3, "cpu") == [torch.device("cpu")] * 3
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert replica_devices(2, "cuda") == [torch.device("cuda:0")] * 2
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert [str(d) for d in replica_devices(5, "cuda")] == [
        "cuda:0", "cuda:1", "cuda:2", "cuda:3", "cuda:0"]


def test_router_failover_on_wedged_replica(fleet_models):
    m1, b1, _, _, X = fleet_models
    router = ReplicaRouter(m1, n_replicas=2, config=_cfg(), device="cpu")
    ref = b1.predict(X[:8])
    try:
        faults.configure("serve_replica_0:raise@n=-1")
        for _ in range(6):
            t = router.submit(X[:8])
            assert t.replica.idx == 1    # the survivor carries the traffic
            assert _close(router.result(t, timeout=TIMEOUT), ref)
        st = router.stats()
        assert st["replicas"][0]["breaker"]["state"] in ("open",
                                                         "half_open")
        assert st["failovers"] >= 1 and not st["degraded"]
        assert router.events[0]["event"] == "serve_failover"
        faults.disarm()
        # the half-open probe re-admits replica 0 after the backoff
        deadline = time.time() + 10
        while (router.replicas[0].breaker.state != "closed"
               and time.time() < deadline):
            router.result(router.submit(X[:4]), timeout=TIMEOUT)
            time.sleep(0.1)
        assert router.replicas[0].breaker.state == "closed"
        assert router.routable_count() == 2
    finally:
        router.close()


def test_router_degraded_replica_fails_over_to_sibling(fleet_models):
    """A device failure on one replica fails that batch's request (no
    host answer); the degraded replica then refuses work at submit, its
    breaker opens, and the sibling answers; a later probe recovers it."""
    m1, b1, _, _, X = fleet_models
    router = ReplicaRouter(m1, n_replicas=2, device="cpu",
                           config=_cfg(tpu_serve_reprobe_s=0.3,
                                       tpu_serve_breaker_backoff_s=0.2))
    ref = b1.predict(X[:8])
    try:
        faults.configure("serve_device:raise@n=1")
        t = router.submit(X[:8])
        with pytest.raises(DeviceFailed):
            router.result(t, timeout=TIMEOUT)
        bad = t.replica.idx
        assert router.replicas[bad].breaker.state == "open"
        assert router.stats()["any_degraded"]
        for _ in range(4):
            t = router.submit(X[:8])
            assert t.replica.idx == 1 - bad
            assert _close(router.result(t, timeout=TIMEOUT), ref)
        deadline = time.time() + 10
        while ((router.replicas[bad].session.stats()["degraded"]
                or router.replicas[bad].breaker.state != "closed")
               and time.time() < deadline):
            try:
                router.result(router.submit(X[:4]), timeout=TIMEOUT)
            except DeviceFailed:
                pass
            time.sleep(0.1)
        st = router.stats()
        assert not st["any_degraded"] and st["recoveries"] == 1
        assert router.replicas[bad].breaker.state == "closed"
    finally:
        router.close()


def test_router_drain_removes_replica_from_routing(fleet_models):
    m1, _, _, _, X = fleet_models
    router = ReplicaRouter(m1, n_replicas=2, config=_cfg(), device="cpu")
    try:
        router.drain(0)
        for _ in range(4):
            t = router.submit(X[:4])
            assert t.replica.idx == 1
            router.result(t, timeout=TIMEOUT)
        assert router.routable_count() == 1
        router.undrain(0)
        assert router.routable_count() == 2
        boot = router.restart_replica(0)
        assert boot["replica"] == 0
        assert _close(router.result(router.submit(X[:4]), timeout=TIMEOUT),
                      router.replicas[1].session.predict(X[:4]))
    finally:
        router.close()


def test_router_all_replicas_down_raises_overload(fleet_models):
    m1, _, _, _, X = fleet_models
    router = ReplicaRouter(m1, n_replicas=2, config=_cfg(), device="cpu")
    try:
        router.drain(0)
        router.drain(1)
        with pytest.raises(NoReplicaAvailable):
            router.submit(X[:4])
        assert router.metrics.snapshot()["shed_by_priority"] == {
            "normal": 1}
    finally:
        router.close()


# ---------------------------------------------------------------------
# registry: swap, canary, rollback
# ---------------------------------------------------------------------

def _registry(**over):
    return ModelRegistry(config=_cfg(**over), n_replicas=1, device="cpu")


def test_swap_flips_and_rollback_restores(fleet_models):
    m1, b1, m2, b2, X = fleet_models
    reg = _registry()
    try:
        reg.add_model("default", m1)
        t = reg.submit(X[:8])
        assert t.version == 1 and _close(reg.result(t), b1.predict(X[:8]))
        report = reg.swap("default", m2)
        assert report["ok"] and report["to_version"] == 2
        assert report["canary"]["checks"]["parity"]
        t2 = reg.submit(X[:8])
        assert t2.version == 2 and _close(reg.result(t2), b2.predict(X[:8]))
        assert reg.rollback("default", reason="test")["to_version"] == 1
        t3 = reg.submit(X[:8])
        assert t3.version == 1 and _close(reg.result(t3), b1.predict(X[:8]))
        row = reg.models()[0]
        assert row["swaps"] == 1 and row["rollbacks"] == 1
        with pytest.raises(RuntimeError):
            reg.rollback("default")     # nothing resident to go back to
        assert [e["event"] for e in reg.events].count("serve_canary") == 2
    finally:
        reg.close()


def test_canary_rejection_leaves_old_model_serving(fleet_models):
    m1, b1, m2, _, X = fleet_models
    reg = _registry()
    try:
        reg.add_model("default", m1)
        faults.configure("serve_canary:raise@call=1")
        with pytest.raises(SwapRejected):
            reg.swap("default", m2)
        faults.disarm()
        row = reg.models()[0]
        assert row["live_version"] == 1 and row["swaps_rejected"] == 1
        t = reg.submit(X[:8])
        assert t.version == 1 and _close(reg.result(t), b1.predict(X[:8]))
    finally:
        reg.close()


def test_injected_swap_fault_aborts_before_flip(fleet_models):
    m1, b1, m2, _, X = fleet_models
    reg = _registry()
    try:
        reg.add_model("default", m1)
        faults.configure("serve_swap:raise@call=1")
        with pytest.raises(SwapRejected):
            reg.swap("default", m2)
        faults.disarm()
        assert reg.resolve(None).version == 1
        assert _close(reg.result(reg.submit(X[:4])), b1.predict(X[:4]))
    finally:
        reg.close()


def test_postswap_regression_triggers_auto_rollback(fleet_models):
    """A swapped-in version whose device path dies: its requests fail
    (no host answer) and the post-swap check rolls back to v1."""
    m1, b1, m2, _, X = fleet_models
    reg = _registry(tpu_serve_rollback_degraded=1)
    try:
        reg.add_model("default", m1)
        assert reg.swap("default", m2)["ok"]
        faults.configure("serve_device:raise@n=-1")
        failures = 0
        for _ in range(3):
            try:
                reg.result(reg.submit(X[:4]), timeout=TIMEOUT)
            except (DeviceFailed, ServeOverloadError):
                failures += 1
        assert failures == 3
        out = reg.check_postswap("default")
        faults.disarm()
        assert out is not None and str(out["reason"]).startswith("auto:")
        assert reg.resolve(None).version == 1
        assert _close(reg.result(reg.submit(X[:4])), b1.predict(X[:4]))
    finally:
        reg.close()


def test_swap_under_concurrent_mixed_traffic_is_loss_free(fleet_models):
    """A hot swap under concurrent predict and explain traffic loses
    nothing, and every answer matches the version it names."""
    m1, b1, m2, b2, X = fleet_models
    reg = _registry()
    expected = {
        1: (b1.predict(X[:32]), b1.predict(X[:32], pred_contrib=True)),
        2: (b2.predict(X[:32]), b2.predict(X[:32], pred_contrib=True)),
    }
    results, lock = [], threading.Lock()
    stop = threading.Event()

    def client(seed):
        rng = np.random.default_rng(seed)
        while not stop.is_set():
            n = int(rng.integers(1, 9))
            lo = int(rng.integers(0, 32 - n + 1))
            explain = rng.random() < 0.3
            try:
                t = (reg.submit_explain if explain else reg.submit)(
                    X[lo:lo + n])
                out = reg.result(t, timeout=TIMEOUT)
                with lock:
                    results.append((t.version, explain, lo, n,
                                    np.asarray(out)))
            except Exception as exc:  # noqa: BLE001 — counted as a loss
                with lock:
                    results.append((None, explain, lo, n, repr(exc)))
            time.sleep(0.005)

    threads = [threading.Thread(target=client, args=(s,), daemon=True)
               for s in range(3)]
    try:
        reg.add_model("default", m1)
        for t in threads:
            t.start()
        time.sleep(0.4)
        assert reg.swap("default", m2)["ok"]
        time.sleep(0.4)
    finally:
        stop.set()
        for t in threads:
            t.join(TIMEOUT)
        reg.close()
    lost = [r for r in results if r[0] is None]
    assert not lost, lost[:3]
    assert len(results) > 10 and {r[0] for r in results} == {1, 2}
    for ver, explain, lo, n, out in results:
        want = expected[ver][1 if explain else 0][lo:lo + n]
        assert out.shape == np.asarray(want).shape
        assert np.allclose(out, want, atol=1e-5), (ver, explain, lo)


# ---------------------------------------------------------------------
# priority shedding
# ---------------------------------------------------------------------

def test_low_priority_sheds_first(fleet_models, monkeypatch):
    m1, _, _, _, X = fleet_models
    sess = PredictorSession(m1, device="cpu", config=_cfg(
        tpu_serve_max_batch=16, tpu_serve_queue_depth=64,
        tpu_serve_max_wait_ms=50.0))
    orig = sess._run_device

    def slow(bins):
        time.sleep(0.1)
        return orig(bins)

    monkeypatch.setattr(sess, "_run_device", slow)
    try:
        tickets = [sess.submit(X[:8], priority="normal") for _ in range(6)]
        with pytest.raises(ServeOverloadError) as exc_info:
            sess.submit(X[:8], priority="low")
        assert exc_info.value.priority == "low" and exc_info.value.shed
        tickets.append(sess.submit(X[:8], priority="high"))
        for t in tickets:
            sess.result(t, timeout=TIMEOUT)
        snap = sess.metrics.snapshot()
    finally:
        sess.close()
    assert snap["shed_by_priority"] == {"low": 1}
    assert snap["served_by_priority"] == {"high": 1, "normal": 6}


def test_unknown_priority_serves_as_normal(fleet_models):
    m1, _, _, _, X = fleet_models
    with PredictorSession(m1, config=_cfg(), device="cpu") as sess:
        sess.result(sess.submit(X[:4], priority="urgent-nonsense"),
                    timeout=TIMEOUT)
        assert sess.metrics.snapshot()["served_by_priority"] == {
            "normal": 1}


# ---------------------------------------------------------------------
# HTTP fleet surface
# ---------------------------------------------------------------------

def _post(url, payload, timeout=TIMEOUT):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read())


def _get_json(url):
    with urllib.request.urlopen(url, timeout=TIMEOUT) as r:
        return json.loads(r.read())


def test_http_fleet_roundtrip_swap_and_models(fleet_models):
    m1, b1, m2, b2, X = fleet_models
    reg = ModelRegistry(config=_cfg(), n_replicas=2, device="cpu")
    reg.add_model("default", m1)
    server = PredictServer(reg).start()
    url = server.url
    try:
        code, body = _post(url + "/predict", {"rows": X[:4].tolist(),
                                              "priority": "high"})
        assert code == 200 and body["version"] == 1
        assert body["model"] == "default" and "replica" in body
        assert _close(body["predictions"], b1.predict(X[:4]))
        listing = _get_json(url + "/models")
        assert listing["default"] == "default"
        assert listing["models"][0]["live_version"] == 1
        health = _get_json(url + "/health")
        assert health["status"] == "ok" and len(health["replicas"]) == 2
        assert health["models"]["default"]["live_version"] == 1
        stats = _get_json(url + "/stats")
        assert stats["stats"]["n_replicas"] == 2 and "metrics" in stats
        assert _get_json(url + "/drift") == {"models": {"default": {
            "drift": None, "quality_breach": None}}}
        code, rep = _post(url + "/models/default/swap", {"model_file": m2})
        assert code == 200 and rep["ok"] and rep["to_version"] == 2
        code, body = _post(url + "/predict", {"rows": X[:4].tolist()})
        assert body["version"] == 2
        assert _close(body["predictions"], b2.predict(X[:4]))
        code, rb = _post(url + "/models/default/rollback",
                         {"reason": "test"})
        assert code == 200 and rb["to_version"] == 1
        code, body = _post(url + "/predict", {"rows": X[:4].tolist()})
        assert body["version"] == 1
        assert _post(url + "/models/default/rollback", {})[0] == 409
        code, body = _post(url + "/predict", {"rows": X[:4].tolist(),
                                              "model": "nope"})
        assert code == 404
    finally:
        server.stop(close_session=True)


def test_http_fleet_metrics_exposition(fleet_models):
    """The fleet's /metrics parses back; every series the port renders is
    one the JAX package renders for the same fleet, and the JAX series
    the port leaves out are the documented ones (recompiles, AOT, drift,
    online)."""
    from lightgbm_tpu.config import Config as JConfig
    from lightgbm_tpu.serve import ModelRegistry as JRegistry
    from lightgbm_tpu.serve.metrics import render_prometheus_fleet as jrender
    m1, _, _, _, X = fleet_models
    reg = ModelRegistry(config=_cfg(), n_replicas=2, device="cpu")
    reg.add_model("default", m1)
    server = PredictServer(reg).start()
    try:
        _post(server.url + "/predict", {"rows": X[:4].tolist()})
        with urllib.request.urlopen(server.url + "/metrics",
                                    timeout=TIMEOUT) as r:
            text = r.read().decode()
        pm = parse_prometheus(text)
        assert pm.get('tpu_serve_model_version{model="default"}') == 1.0
        assert pm.get('tpu_serve_swaps_total{model="default"}') == 0.0
        assert pm.get('tpu_serve_rollbacks_total{model="default"}') == 0.0
        assert 'tpu_serve_replica_healthy{replica="r0"}' in pm
        assert 'tpu_serve_replica_breaker_state{replica="r1"}' in pm
        assert 'tpu_serve_shed_total{priority="low"}' in pm
        assert pm.get('tpu_serve_served_total{priority="normal"}') >= 1.0
        assert "tpu_serve_degraded" in pm
    finally:
        server.stop(close_session=True)
    jreg = JRegistry(config=JConfig.from_params(_params()), n_replicas=2)
    try:
        jreg.add_model("default", m1)
        jtext = jrender(jreg)
    finally:
        jreg.close()

    def names(t):
        return {line.split()[2] for line in t.splitlines()
                if line.startswith("# TYPE")}
    ours, theirs = names(text), names(jtext)
    assert ours <= theirs, ours - theirs
    left_out = {n for n in theirs - ours
                if not n.startswith(("tpu_serve_aot_", "tpu_serve_drift_",
                                     "tpu_online_"))}
    assert left_out == {"tpu_serve_recompiles_total"}, left_out


def test_bare_session_server_has_no_fleet_fields(fleet_models):
    m1, b1, _, _, X = fleet_models
    sess = PredictorSession(m1, config=_cfg(), device="cpu")
    server = PredictServer(sess).start()
    try:
        code, body = _post(server.url + "/predict", {"rows": X[:3].tolist()})
        assert code == 200 and "version" not in body
        assert _close(body["predictions"], b1.predict(X[:3]))
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(server.url + "/models", timeout=TIMEOUT)
        assert err.value.code == 404
    finally:
        server.stop(close_session=True)
