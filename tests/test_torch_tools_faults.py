"""The port's fault-injection matrix (lightgbm_tpu_torch/tools/
fault_matrix.py) on the CPU, every leg but the fleet's: each check of its
verdict map holds, and its check names are the JAX tool's
(tools/fault_matrix.py, read with ``ast``; nothing of JAX runs) but for
the fleet legs (tests/test_torch_tools_fleet.py) and the ``DEPARTURES``
table."""
import json
import os
import subprocess
import sys

import pytest

from lightgbm_tpu_torch.tools import fault_matrix
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


@pytest.fixture(scope="module")
def matrix(tmp_path_factory):
    return run_twin("fault_matrix", "--legs", "in_process",
                    cwd=tmp_path_factory.mktemp("fault_matrix"))


def test_every_in_process_check_holds(matrix):
    rc, rec = matrix
    failed = [k for k, ok in rec["checks"].items() if not ok]
    assert rc == 0 and rec["ok"] and not failed, failed
    assert rec["kind"] == "fault_matrix" and rec["device"] == "cpu"
    assert rec["k1_launches"] == 0       # the plain version on the CPU


def test_check_names_are_the_jax_tools(matrix):
    _, rec = matrix
    want, patterns = expected_names("fault_matrix.py",
                                    fault_matrix.DEPARTURES,
                                    drop=fault_matrix.FLEET_CHECKS)
    assert not patterns
    assert set(rec["checks"]) == want


def test_departures_name_their_reason():
    names, _ = declared_checks(os.path.join(REPO, "tools",
                                            "fault_matrix.py"))
    assert set(fault_matrix.DEPARTURES) <= names
    assert set(fault_matrix.FLEET_CHECKS) <= names
    for jax_name, (port_name, why) in fault_matrix.DEPARTURES.items():
        assert "ROADMAP.md 3.10" in why, jax_name
        assert port_name is None or port_name not in names


def test_poison_makes_every_leaf_nan():
    text = "Tree=0\nleaf_value=0.1 -0.2 0.3\nTree=1\nleaf_value=1\n"
    assert fault_matrix.poison(text) == \
        "Tree=0\nleaf_value=nan nan nan\nTree=1\nleaf_value=nan\n"
