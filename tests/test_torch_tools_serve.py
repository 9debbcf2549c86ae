"""The port's serving twins on the CPU (lightgbm_tpu_torch/tools/):
``chaos_serve``, ``online_smoke``, ``arena_smoke`` and ``drift_report``.
Each runs in a process of its own with ``--device cpu``; every check of
its verdict map holds, and its check names are the JAX tool's (read from
tools/<name>.py with ``ast``; nothing of JAX runs) but for its
``DEPARTURES`` table.  ``drift_report``'s report mode reads the smoke's
model and a stream file."""
import json
import os
import re
import subprocess
import sys

import pytest

from lightgbm_tpu_torch.tools import (arena_smoke, chaos_serve, drift_report,
                                      online_smoke)
from lightgbm_tpu_torch.tools._verdict import declared_checks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_twin(module, *args, cwd, timeout=240):
    """``python -m lightgbm_tpu_torch.tools.<module> --device cpu --json``
    with one intra-op thread: (exit code, the last line's record)."""
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    env.pop("LGBM_TPU_FAULTS", None)
    r = subprocess.run(
        [sys.executable, "-m", f"lightgbm_tpu_torch.tools.{module}", *args,
         "--device", "cpu", "--json"], capture_output=True, text=True,
        timeout=timeout, cwd=str(cwd), env=env)
    lines = r.stdout.strip().splitlines()
    assert lines, r.stderr[-3000:]
    return r.returncode, json.loads(lines[-1])


def expected_names(tool, departures, drop=()):
    """The JAX tool's check names, renamed or dropped by ``departures``,
    less ``drop``."""
    names, patterns = declared_checks(os.path.join(REPO, "tools", tool))
    out = set()
    for n in names - set(drop):
        out.add(departures[n][0] if n in departures else n)
    return out - {None}, patterns


TWINS = {
    "chaos_serve": (chaos_serve, ()),
    "online_smoke": (online_smoke, ()),
    "arena_smoke": (arena_smoke, ()),
    "drift_report": (drift_report, ("--smoke",)),
}


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    out = {}
    for name, (_, args) in TWINS.items():
        cwd = tmp_path_factory.mktemp(name)
        out[name] = run_twin(name, *args, cwd=cwd) + (cwd,)
    return out


@pytest.mark.parametrize("name", sorted(TWINS))
def test_every_check_holds(records, name):
    rc, rec, _ = records[name]
    failed = [k for k, ok in rec["checks"].items() if not ok]
    assert rc == 0 and rec["ok"] and not failed, failed
    assert rec["device"] == "cpu"


@pytest.mark.parametrize("name", sorted(TWINS))
def test_check_names_are_the_jax_tools(records, name):
    _, rec, _ = records[name]
    mod = TWINS[name][0]
    want, patterns = expected_names(name + ".py", mod.DEPARTURES)
    got = set(rec["checks"])
    assert want <= got
    extra = got - want
    for pat in patterns:
        hits = {n for n in extra if re.fullmatch(pat, n)}
        assert hits, pat
        extra -= hits
    assert not extra


@pytest.mark.parametrize("name", sorted(TWINS))
def test_writes_nothing_where_it_runs(records, name):
    """The default run leaves its artefacts in a temporary directory."""
    _, _, cwd = records[name]
    assert os.listdir(cwd) == []


def test_online_smoke_pushed_two_versions(records):
    _, rec, _ = records["online_smoke"]
    assert rec["online_swap_ok"] >= 2 and rec["online_swap_rejected"] >= 1


def test_chaos_records_the_swap_blip(records):
    _, rec, _ = records["chaos_serve"]
    assert rec["requests"] >= 8 and rec["swap_ms"] > 0
    assert set(rec["leg_s"]) == set(chaos_serve.SCENARIOS)


def test_drift_report_mode_reads_the_smokes_model(records, tmp_path):
    _, rec, _ = records["drift_report"]
    model = os.path.join(rec["artifacts_dir"], "model.txt")
    stream = tmp_path / "live.jsonl"
    stream.write_text('{"x": [1, 2, 3, 4, 5, 6]}\nnot json\n'
                      '{"features": [0, 0, 0, 0, 0, 0]}\n')
    env = dict(os.environ, PYTHONPATH=REPO)
    base = [sys.executable, "-m", "lightgbm_tpu_torch.tools.drift_report",
            model]
    r = subprocess.run(base, capture_output=True, text=True, timeout=120,
                       env=env, cwd=str(tmp_path))
    assert r.returncode == 0 and "6 numerical feature record(s)" in r.stdout
    r = subprocess.run(base + ["--stream", str(stream)], capture_output=True,
                       text=True, timeout=120, env=env, cwd=str(tmp_path))
    assert r.returncode == 0, r.stderr
    assert "2 row(s)" in r.stdout and "skipped 1 malformed" in r.stdout


def test_restart_after_warmup_warms_the_replacement():
    """Once its router was warmed, a restarted replica is warmed before it
    takes traffic (chaos_serve's restart scenario counts the CUDA graphs
    its first request captures on the card: none)."""
    import numpy as np

    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.serve import ReplicaRouter
    rng = np.random.default_rng(0)
    X = rng.normal(size=(300, 4))
    y = (X[:, 0] > 0).astype(np.float64)
    bst = lt.train({"objective": "binary", "num_leaves": 5, "verbose": -1},
                   lt.Dataset(X, label=y), 3, device="cpu")
    cfg = {"verbose": -1, "tpu_serve_max_batch": 16, "device_type": "cpu"}
    router = ReplicaRouter(bst, n_replicas=2, config=lt.Config.from_params(
        cfg))
    try:
        cold = router.restart_replica(0)
        assert router.replicas[0].session.stats()["buckets"] == []
        router.warmup()
        boot = router.restart_replica(1)
        assert boot["boot_captures"] == 0 and boot["aot"] is False
        assert cold["replica"] == 0 and boot["replica"] == 1
        assert router.replicas[1].session.stats()["buckets"] == [
            1, 2, 4, 8, 16]
        got = router.replicas[1].session.predict(X)
        np.testing.assert_array_equal(
            got, router.replicas[0].session.predict(X))
        np.testing.assert_allclose(got, bst.predict(X), rtol=0, atol=1e-6)
    finally:
        router.close()
