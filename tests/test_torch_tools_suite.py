"""The port's suite runner (lightgbm_tpu_torch/tools/run_suite.py) and
its board and profiler-window twins on the CPU: the runner's count
parsing, a small ``--select`` run, a failing selection, the table of
``tools/`` left without a twin; ``board_smoke`` and ``xprof_smoke`` with
every check true and the JAX tools' check names (read with ``ast``) but
for their ``DEPARTURES``; and every twin's refusal to run on the CPU
unless asked."""
import importlib
import json
import os
import subprocess
import sys

import pytest
import torch

from lightgbm_tpu_torch.tools import board_smoke, run_suite, xprof_smoke
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


TWINS = ("fault_matrix", "chaos_serve", "online_smoke", "arena_smoke",
         "drift_report", "ingest_bench", "fleet_smoke", "board_smoke",
         "xprof_smoke", "run_suite")


def _suite(*args, cwd):
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    r = subprocess.run(
        [sys.executable, "-m", "lightgbm_tpu_torch.tools.run_suite", *args],
        capture_output=True, text=True, timeout=300, env=env, cwd=str(cwd))
    return r.returncode, json.loads(r.stdout.strip().splitlines()[-1])


def test_parse_counts():
    out = ("....F\n=== 3 failed, 1207 passed, 2 skipped, 4 deselected, "
           "7 warnings in 9.1s ===\n")
    assert run_suite.parse_counts(out) == {
        "failed": 3, "passed": 1207, "skipped": 2, "deselected": 4,
        "warning": 7}
    assert run_suite.parse_counts("1 error in 0.2s") == {"error": 1}
    assert run_suite.parse_counts("no summary") == {}


def test_select_runs_the_quick_tier(tmp_path):
    rc, tail = _suite("--tiers", "quick,faults", "--device", "cpu",
                      "--select", "tests/test_torch_tools_faults.py::"
                      "test_poison_makes_every_leaf_nan", "--out",
                      str(tmp_path), cwd=REPO)
    assert rc == 0 and tail["ok"] and tail["failed"] == 0
    rec = json.loads((tmp_path / "SUITE.json").read_text())
    # --select narrows the pytest tier and drops the tool tiers
    assert list(rec["tiers"]) == ["quick"]
    assert rec["tiers"]["quick"]["counts"]["passed"] >= 1


def test_a_failing_selection_fails_the_suite(tmp_path):
    bad = tmp_path / "test_red.py"
    bad.write_text("def test_red():\n    assert 1 == 2\n")
    rc, tail = _suite("--tiers", "quick", "--device", "cpu", "--select",
                      str(bad), "--out", str(tmp_path / "out"),
                      cwd=tmp_path)
    assert rc == 1 and not tail["ok"] and tail["failed"] == 1
    rec = json.loads((tmp_path / "out" / "SUITE.json").read_text())
    assert rec["tiers"]["quick"]["counts"] == {"failed": 1}


def test_the_record_goes_to_a_temporary_directory(tmp_path):
    rc, tail = _suite("--tiers", "quick", "--device", "cpu", "--select",
                      "tests/test_torch_tools_faults.py::"
                      "test_poison_makes_every_leaf_nan", cwd=REPO)
    assert rc == 0
    assert not tail["record"].startswith(REPO)
    assert os.path.isfile(tail["record"])


def test_tool_tiers_name_the_twins():
    for tier, (mod, *_) in run_suite.TOOL_TIERS.items():
        assert importlib.util.find_spec(f"lightgbm_tpu_torch.tools.{mod}")
    assert set(run_suite.TOOL_TIERS) == {
        "faults", "chaos", "online", "ingest", "drift", "board", "xprof",
        "arena", "fleet"}
    assert "serve" not in run_suite.TOOL_TIERS
    assert "bench_serve.py" in run_suite.NO_TWIN


@pytest.fixture(scope="module")
def board_rec(tmp_path_factory):
    return run_twin("board_smoke", cwd=tmp_path_factory.mktemp("board"))


@pytest.fixture(scope="module")
def xprof_rec(tmp_path_factory):
    return run_twin("xprof_smoke", cwd=tmp_path_factory.mktemp("xprof"))


@pytest.mark.parametrize("which", ["board", "xprof"])
def test_smoke_every_check_holds(which, board_rec, xprof_rec):
    rc, rec = board_rec if which == "board" else xprof_rec
    failed = [k for k, ok in rec["checks"].items() if not ok]
    assert rc == 0 and rec["ok"] and not failed, (failed, rec)


@pytest.mark.parametrize("which", ["board", "xprof"])
def test_smoke_check_names(which, board_rec, xprof_rec):
    rec = (board_rec if which == "board" else xprof_rec)[1]
    mod = board_smoke if which == "board" else xprof_smoke
    want, _ = expected_names(f"{which}_smoke.py", mod.DEPARTURES)
    assert set(rec["checks"]) == want


def test_xprof_joins_the_plain_histograms_on_the_cpu(xprof_rec):
    """On the CPU the window holds ``lgbm/hist_wave`` (the plain version's
    calls) against K1's cost function over the CPU's peak row."""
    rec = xprof_rec[1]
    assert "lgbm/hist_wave" in rec["kernels"] and rec["k1_launches"] == 0
    from lightgbm_tpu_torch.obs import xprof
    ctx = {"rows": 1000, "features": 4, "bins": 64, "k1_launches": 0,
           "k1_plain_calls": 3, "k1_rows": 1500}
    ops, nbytes, model = xprof._model_cost("lgbm/hist_wave", ctx)
    from lightgbm_tpu_torch.ops.hist_wave import hist_wave_cost
    o1, b1 = hist_wave_cost(1000, 4, 64, 500.0, packed=True, fused=False,
                            quant=False)
    assert model == "hist_wave" and (ops, nbytes) == (3 * o1, 3 * b1)
    assert xprof._model_cost("lgbm/hist_wave",
                             dict(ctx, k1_plain_calls=0)) is None


@pytest.mark.parametrize("name", TWINS)
def test_no_card_no_cpu_flag_fails_loudly(name, monkeypatch, capsys):
    """Asked for the card (the default) where there is none, a twin exits
    non-zero with a message before it does any work."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module(f"lightgbm_tpu_torch.tools.{name}")
    args = (["--smoke", "--json"] if name == "drift_report"
            else ["--tiers", "faults"] if name == "run_suite" else ["--json"])
    assert mod.main(args) == 2
    err = capsys.readouterr().err
    assert "torch.cuda.is_available() is False" in err and "--device cpu" \
        in err
