"""Checkpoint/resume, the device guard and fault injection of the port
(``robust/``), after the JAX package's tests/test_robust.py.

A crashed run resumed from its checkpoints writes the model text of an
uninterrupted run, byte for byte (the parameters block aside: the
checkpoint knobs differ), under bagging, GOSS, DART, early stopping, int16
and a learning-rate schedule, and after SIGTERM's preemption checkpoint;
the mechanics (checksums, orphans, pruning,
config digest) and the guard's policies are held as there, and the fault
grammar and backoff schedule against the JAX package's own."""
import glob
import os

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.robust import faults
from lightgbm_tpu_torch.robust.checkpoint import (CheckpointManager,
                                                  config_digest)
from lightgbm_tpu_torch.robust.faults import FaultInjected, FaultTransient
from lightgbm_tpu_torch.robust.watchdog import (DeviceGuard,
                                                DeviceWedgedError,
                                                backoff_delays,
                                                classify_error)
from lightgbm_tpu_torch.utils.log import LightGBMError

N = 500
_rng = np.random.default_rng(0)
X = _rng.normal(size=(N, 6))
y = (X[:, 0] + 0.5 * X[:, 1] + 0.3 * _rng.normal(size=N) > 0).astype(float)
XV = _rng.normal(size=(150, 6))
YV = (XV[:, 0] + 0.5 * XV[:, 1] > 0).astype(float)

BASE = {"objective": "binary", "num_leaves": 7, "min_data_in_leaf": 5,
        "verbose": -1, "seed": 1}


@pytest.fixture(autouse=True)
def _disarm_faults():
    faults.disarm()
    yield
    faults.disarm()


def _model(booster):
    """Model text minus the parameters block (the checkpoint knobs
    differ between the uninterrupted and the resumed run)."""
    return booster.model_to_string(num_iteration=-1).split(
        "\nparameters:")[0]


def _train(params, n, **kw):
    ds = lt.Dataset(X, label=y)
    vs = lt.Dataset(XV, label=YV, reference=ds)
    return lt.train(dict(params), ds, n, valid_sets=[vs], verbose_eval=False,
                    device="cpu", **kw)


def _diff_resume(extra, tmp, n=10, crash=7, freq=3, **kw):
    """(uninterrupted, resumed) boosters: the crashed run is one that
    ends after ``crash`` rounds."""
    p = {**BASE, **extra}
    b1 = _train(p, n, **kw)
    p2 = dict(p, tpu_checkpoint_dir=str(tmp), tpu_checkpoint_freq=freq)
    _train(p2, crash, **kw)
    return b1, _train(p2, n, **kw)


@pytest.mark.parametrize("extra,kw", [
    ({"bagging_fraction": 0.7, "bagging_freq": 2,
      "feature_fraction": 0.8}, {}),
    ({"boosting": "goss", "learning_rate": 0.5, "top_rate": 0.3,
      "other_rate": 0.2}, {}),
    ({"boosting": "dart", "drop_rate": 0.5, "skip_drop": 0.2}, {}),
    ({"learning_rate": 0.3}, {"early_stopping_rounds": 2}),
    ({"tpu_hist_dtype": "int16", "bagging_fraction": 0.8,
      "bagging_freq": 1}, {}),
], ids=["bagging", "goss", "dart", "early_stopping", "int16"])
def test_resume_is_byte_equal(tmp_path, extra, kw):
    b1, b2 = _diff_resume(extra, tmp_path, **kw)
    assert b1.best_iteration == b2.best_iteration
    assert _model(b1) == _model(b2)
    assert glob.glob(os.path.join(str(tmp_path), "ckpt_*"))


def test_resume_learning_rate_schedule(tmp_path):
    """The first resumed round trains at the scheduled rate, not the
    checkpoint's."""
    p = dict(BASE, learning_rate=0.1)
    lrs = [0.2, 0.2, 0.2, 0.2, 0.1, 0.1, 0.1, 0.1]
    b1 = _train(p, 8, learning_rates=list(lrs))
    p2 = dict(p, tpu_checkpoint_dir=str(tmp_path), tpu_checkpoint_freq=2)

    class Boom(Exception):
        pass

    def boom(env):
        if env.iteration == 5:
            raise Boom()
    boom.order = 99
    with pytest.raises(Boom):
        _train(p2, 8, learning_rates=list(lrs), callbacks=[boom])
    assert _model(b1) == _model(_train(p2, 8, learning_rates=list(lrs)))


def test_resume_restores_eval_history(tmp_path):
    p = dict(BASE, learning_rate=0.3)
    ev1, ev2 = {}, {}
    _train(p, 8, evals_result=ev1)
    p2 = dict(p, tpu_checkpoint_dir=str(tmp_path), tpu_checkpoint_freq=3)
    _train(p2, 5)
    _train(p2, 8, evals_result=ev2)
    assert ev1 == ev2


def test_corrupt_newest_checkpoint_falls_back(tmp_path):
    p = dict(BASE, tpu_checkpoint_dir=str(tmp_path), tpu_checkpoint_freq=3)
    _train(p, 7)
    cks = sorted(glob.glob(os.path.join(str(tmp_path), "ckpt_*")))
    assert len(cks) == 2       # iterations 3 and 6
    with open(os.path.join(cks[-1], "model.txt"), "a") as fh:
        fh.write("corruption")
    peeked = CheckpointManager(str(tmp_path)).peek(Config.from_params(p))
    assert peeked[0] == cks[0] and peeked[1]["iteration"] == 3


def test_orphans_swept_and_pruning(tmp_path):
    orphan = tmp_path / ".tmp-9999-5"
    orphan.mkdir()
    (orphan / "model.txt").write_text("partial")
    p = dict(BASE, tpu_checkpoint_dir=str(tmp_path), tpu_checkpoint_freq=2,
             tpu_checkpoint_keep=2)
    assert CheckpointManager(str(tmp_path)).peek(
        Config.from_params(p)) is None
    _train(p, 9)
    assert not orphan.exists()
    names = sorted(os.path.basename(d) for d in
                   glob.glob(os.path.join(str(tmp_path), "ckpt_*")))
    assert names == ["ckpt_00000006", "ckpt_00000008"]


def test_config_mismatch_refuses_resume(tmp_path):
    p = dict(BASE, tpu_checkpoint_dir=str(tmp_path), tpu_checkpoint_freq=3)
    _train(p, 4)
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.peek(Config.from_params(p)) is not None
    assert mgr.peek(Config.from_params(dict(p, num_leaves=15))) is None
    a = Config.from_params(dict(BASE))
    b = Config.from_params(dict(BASE, tpu_checkpoint_dir="/x",
                                output_model="z.txt", tpu_watchdog=True,
                                tpu_hist_dtype="float32"))
    assert config_digest(a) == config_digest(b)
    assert config_digest(a) != config_digest(
        Config.from_params(dict(BASE, learning_rate=0.42)))


def test_fault_grammar_matches_reference():
    pytest.importorskip("jax")
    from lightgbm_tpu.robust import faults as ref
    spec = ("device_execute:transient@iter=3&n=2;"
            "gradients:raise;checkpoint_write:sleep=0.5@call=2&p=0.5;"
            "device_execute:hang@n=-1")
    assert [vars(s) for s in faults.parse_spec(spec)] == \
        [vars(s) for s in ref.parse_spec(spec)]
    for bad in ("nocolon", "p:unknown_action", "p:raise@call",
                "p:raise@zzz=1"):
        with pytest.raises(ValueError):
            faults.parse_spec(bad)


def test_fault_fires_deterministically():
    faults.configure("pt:transient@call=2&n=1")
    faults.check("pt")
    with pytest.raises(FaultTransient):
        faults.check("pt")
    faults.check("pt")
    faults.configure("pt:raise@iter=5")
    faults.check("pt", iteration=4)
    with pytest.raises(FaultInjected):
        faults.check("pt", iteration=5)

    def fires(seed):
        faults.configure("pt:raise@p=0.5&n=-1", seed=seed)
        out = []
        for _ in range(32):
            try:
                faults.check("pt")
                out.append(0)
            except FaultInjected:
                out.append(1)
        return out
    assert fires(3) == fires(3) != fires(4)


@pytest.mark.parametrize("exc,cls", [
    (RuntimeError("CUDA error: an illegal memory access was encountered"),
     "fatal"),
    (RuntimeError("CUDA error: unspecified launch failure"), "fatal"),
    (torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate"),
     "transient"),
    (RuntimeError("UNAVAILABLE: socket closed"), "transient"),
    (RuntimeError("RESOURCE_EXHAUSTED: hbm"), "transient"),
    (FaultTransient("x"), "transient"),
    (FaultInjected("x"), "fatal"),
    (ValueError("bad shape"), "fatal"),
])
def test_classify_error(exc, cls):
    assert classify_error(exc) == cls


def test_backoff_delays_match_reference():
    pytest.importorskip("jax")
    from lightgbm_tpu.robust.watchdog import backoff_delays as ref
    for args in ((5, 0.1, 0.8, 9), (3, 0.05, 2.0, 0), (0, 0.1, 1.0, 1)):
        assert backoff_delays(*args) == ref(*args)
    a = backoff_delays(5, base_s=0.1, cap_s=0.8, seed=9)
    assert all(d <= 0.8 * 1.25 + 1e-9 for d in a) and a[1] > a[0]


def test_guard_policies():
    faults.configure("pt:transient@n=2")
    guard = DeviceGuard(policy="retry", retries=3, backoff_base_s=0.001)
    calls = []
    assert guard.run(lambda: calls.append(1) or "ok", point="pt") == "ok"
    assert len(calls) == 1 and guard.retry_count == 2
    faults.configure("pt:transient@n=-1")
    with pytest.raises(DeviceWedgedError):
        DeviceGuard(policy="abort").run(lambda: "never", point="pt")
    faults.configure("pt:raise")
    hooked = []
    guard = DeviceGuard(policy="retry", retries=3,
                        on_fatal=lambda reason, exc: hooked.append(reason))
    with pytest.raises(DeviceWedgedError):
        guard.run(lambda: 42, point="pt")
    assert hooked == ["device_wedge:pt"] and guard.retry_count == 1
    with pytest.raises(ValueError):
        DeviceGuard(policy="fallback")
    faults.disarm()
    guard = DeviceGuard(policy="retry")
    assert not guard.active and guard.run(lambda: 7) == 7


def test_train_wedge_abort_writes_boundary_checkpoint(tmp_path):
    p = dict(BASE, bagging_fraction=0.8, bagging_freq=2)
    ref = _train(p, 6)
    faults.configure("device_execute:raise@iter=3")
    p2 = dict(p, tpu_on_device_error="abort",
              tpu_checkpoint_dir=str(tmp_path), tpu_checkpoint_freq=0)
    with pytest.raises(DeviceWedgedError):
        _train(p2, 6)
    faults.disarm()
    cks = glob.glob(os.path.join(str(tmp_path), "ckpt_*"))
    assert len(cks) == 1 and cks[0].endswith("ckpt_00000003")
    assert _model(ref) == _model(_train(p2, 6))


def test_fallback_is_refused():
    """A failed device step never carries on on the CPU: the JAX
    package's ``fallback`` policy raises, naming its ROADMAP.md item."""
    with pytest.raises(LightGBMError, match="ROADMAP.md port queue: CPU "
                       "fallback of a failed device step"):
        _train(dict(BASE, tpu_on_device_error="fallback"), 2)


@pytest.mark.parametrize("policy,spec", [
    ("retry", "device_execute:transient@iter=2"),
    ("retry", "gradients:transient@iter=1"),
])
def test_train_survives_fault(policy, spec):
    """A transient fault is retried: the model text of a run without the
    fault."""
    ref = _train(BASE, 5)
    faults.configure(spec)
    bst = _train(dict(BASE, tpu_on_device_error=policy), 5)
    assert sum(faults.fired_counts().values()) == 1
    assert _model(ref) == _model(bst)


_CHILD = """
import os, signal, sys
import numpy as np
import lightgbm_tpu_torch as lt
d = np.load(sys.argv[1])

def term(env):
    if env.iteration == 3:
        os.kill(os.getpid(), signal.SIGTERM)
lt.train({"objective": "binary", "num_leaves": 7, "min_data_in_leaf": 5,
          "verbose": -1, "seed": 1, "bagging_fraction": 0.8,
          "bagging_freq": 2, "tpu_checkpoint_dir": sys.argv[2],
          "tpu_checkpoint_freq": 0}, lt.Dataset(d["X"], label=d["y"]), 8,
         device="cpu", callbacks=[term])
"""


def test_sigterm_finishes_the_round_checkpoints_and_resumes(tmp_path):
    """SIGTERM in iteration 3 of a training process: the round finishes,
    a checkpoint of 4 rounds is written, the process exits 143; a rerun
    resumes to the uninterrupted model text."""
    import subprocess
    import sys
    np.savez(tmp_path / "data.npz", X=X, y=y)
    ck = tmp_path / "ck"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run([sys.executable, "-c", _CHILD,
                        str(tmp_path / "data.npz"), str(ck)], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 128 + 15, r.stderr[-2000:]
    assert sorted(os.listdir(ck)) == ["ckpt_00000004"]
    p = dict(BASE, bagging_fraction=0.8, bagging_freq=2)
    ref = lt.train(dict(p), lt.Dataset(X, label=y), 8, device="cpu")
    again = lt.train(dict(p, tpu_checkpoint_dir=str(ck),
                          tpu_checkpoint_freq=0),
                     lt.Dataset(X, label=y), 8, device="cpu")
    assert _model(ref) == _model(again)


@pytest.mark.cuda
def test_card_resume_is_byte_equal(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run there")
    p = dict(BASE, bagging_fraction=0.8, bagging_freq=1)
    ds = lt.Dataset(X, label=y)
    b1 = lt.train(dict(p), ds, 8, device="cuda")
    p2 = dict(p, tpu_checkpoint_dir=str(tmp_path), tpu_checkpoint_freq=3)
    lt.train(dict(p2), lt.Dataset(X, label=y), 5, device="cuda")
    b2 = lt.train(dict(p2), lt.Dataset(X, label=y), 8, device="cuda")
    assert _model(b1) == _model(b2)
