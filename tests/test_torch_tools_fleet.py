"""The port's fleet twins and its ingestion bench on the CPU
(lightgbm_tpu_torch/tools/): ``fleet_smoke`` (3-rank host-TCP fleets
against the single process on the plain, bagging and lambdarank
fixtures, and a killed rank), the fleet legs of ``fault_matrix`` (a
killed rank, a killed coordinator, a heartbeat stall, a healed joiner)
and ``ingest_bench``.  Every check of each verdict map holds, and the
check names are the JAX tools' (read with ``ast``; nothing of JAX runs)
but for their ``DEPARTURES`` tables.  Ranks run with one intra-op
thread."""
import json
import os
import subprocess
import sys

import pytest

from lightgbm_tpu_torch.tools import fault_matrix, fleet_smoke, ingest_bench
from lightgbm_tpu_torch.tools._verdict import declared_checks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_twin(module, *args, cwd, timeout=240, **extra_env):
    """``python -m lightgbm_tpu_torch.tools.<module> --device cpu --json``
    with one intra-op thread: (exit code, the last line's record)."""
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""),
               **extra_env)
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


@pytest.fixture(scope="module")
def smoke(tmp_path_factory):
    return run_twin("fleet_smoke", cwd=tmp_path_factory.mktemp("fleet"))


@pytest.fixture(scope="module")
def fleet_legs(tmp_path_factory):
    return run_twin("fault_matrix", "--legs", "fleet",
                    cwd=tmp_path_factory.mktemp("fleet_legs"))


@pytest.fixture(scope="module")
def ingest(tmp_path_factory):
    # a million rows, so the stream's raw f64 bytes (96 MB) dwarf the
    # sample, the bin matrix and the labels the peak must hold
    return run_twin("ingest_bench", cwd=tmp_path_factory.mktemp("ingest"),
                    INGEST_ROWS="1000000")


def _all_hold(rc, rec):
    failed = [k for k, ok in rec["checks"].items() if not ok]
    assert rc == 0 and rec["ok"] and not failed, (failed, rec)


def test_fleet_smoke_every_check_holds(smoke):
    rc, rec = smoke
    _all_hold(rc, rec)
    assert rec["fleet_ranks"] == 3 and rec["fleet_recoveries"] >= 1


def test_fleet_smoke_check_names(smoke):
    want, _ = expected_names("fleet_smoke.py", fleet_smoke.DEPARTURES)
    assert set(smoke[1]["checks"]) == want


def test_fault_matrix_fleet_legs_every_check_holds(fleet_legs):
    _all_hold(*fleet_legs)
    assert set(fleet_legs[1]["leg_s"]) == {
        "fleet.rank_killed", "fleet.coordinator_killed", "fleet.stall",
        "fleet.rejoin"}


def test_fault_matrix_fleet_legs_check_names(fleet_legs):
    names, _ = declared_checks(os.path.join(REPO, "tools",
                                            "fault_matrix.py"))
    fleet = {n for n in names if n.startswith("fleet.")}
    assert fleet == set(fault_matrix.FLEET_CHECKS)
    assert set(fleet_legs[1]["checks"]) == fleet


def test_ingest_bench_every_check_holds(ingest):
    rc, rec = ingest
    _all_hold(rc, rec)
    assert rec["ingest_rows_per_s"] > 0
    assert rec["peak_traced_bytes"] < rec["raw_matrix_bytes"] // 2


def test_ingest_bench_check_names(ingest):
    want, _ = expected_names("ingest_bench.py", ingest_bench.DEPARTURES)
    assert set(ingest[1]["checks"]) == want


def test_ingest_bench_writes_a_round_file_only_when_asked(tmp_path):
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    r = subprocess.run(
        [sys.executable, "-m", "lightgbm_tpu_torch.tools.ingest_bench",
         "--device", "cpu", "--json", "--out", str(tmp_path)],
        capture_output=True, text=True, timeout=240, env=env,
        cwd=str(tmp_path))
    assert r.returncode == 0, r.stderr[-2000:]
    rec = json.loads(r.stdout.strip().splitlines()[-1])
    assert rec["rows"] == 120_000 and rec["ok"]
    assert sorted(os.listdir(tmp_path)) == ["INGEST_r01.json"]
    assert json.loads((tmp_path / "INGEST_r01.json").read_text()) == rec


def test_flight_dumps_into_one_directory_keep_each_round(tmp_path,
                                                         monkeypatch):
    """Two processes that dump at once may both see round 1 free (a
    killed coordinator's ranks): the dump is created exclusively, so the
    second takes the next round instead of overwriting the first."""
    from lightgbm_tpu_torch import obs
    from lightgbm_tpu_torch.obs import spans
    (tmp_path / "FLIGHT_r01.json").write_text('{"kind": "flight"}')
    seen = iter([1, 2])
    monkeypatch.setattr(spans, "_next_flight_round", lambda d: next(seen))
    ring = obs.flight_len()
    obs.enable_flight(8)
    try:
        path = obs.flight_dump("test", out_dir=str(tmp_path))
    finally:
        obs.enable_flight(ring)
    assert path.endswith("FLIGHT_r02.json")
    assert json.loads((tmp_path / "FLIGHT_r01.json").read_text()) == {
        "kind": "flight"}
    assert json.loads((tmp_path / "FLIGHT_r02.json").read_text())[
        "reason"] == "test"
