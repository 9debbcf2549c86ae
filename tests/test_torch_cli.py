"""The port's CLI, ``python -m lightgbm_tpu_torch``, on the CPU
(``device_type=cpu``): train from a .conf file, predict from the model
file alone, and agree with ``Booster(model_file=...).predict`` and with
the JAX package's CLI on the same model file (the fixture of
tests/test_cli.py)."""
import os
import subprocess
import sys

import numpy as np
import pytest

import lightgbm_tpu_torch as lt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(module, args, cwd, check=True):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, "-m", module] + args, cwd=cwd,
                       env=env, capture_output=True, text=True, timeout=420)
    if check:
        assert r.returncode == 0, r.stderr[-2000:]
    return r


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    rng = np.random.default_rng(0)
    N = 800
    X = rng.normal(size=(N, 4))
    y = (X[:, 0] + X[:, 1] > 0).astype(int)
    np.savetxt(d / "data.train", np.column_stack([y, X]), delimiter="\t",
               fmt="%.8f")
    np.savetxt(d / "data.test", np.column_stack([y, X])[:200], delimiter="\t",
               fmt="%.8f")
    (d / "train.conf").write_text(
        "task = train\nobjective = binary\ndata = data.train\n"
        "valid_data = data.test\nmetric = auc\nnum_trees = 8\n"
        "num_leaves = 15\nmin_data_in_leaf = 5\n"
        "output_model = model.txt\nverbosity = -1\n")
    _run("lightgbm_tpu_torch", ["config=train.conf", "device_type=cpu"], d)
    return d


def test_cli_train_writes_a_model(workdir):
    text = (workdir / "model.txt").read_text()
    assert text.count("Tree=") == 8 and "[device_type: cpu]" in text
    data = np.loadtxt(workdir / "data.train", delimiter="\t")
    bst = lt.train({"objective": "binary", "num_leaves": 15,
                    "min_data_in_leaf": 5, "verbose": -1},
                   lt.Dataset(data[:, 1:], label=data[:, 0]), 8,
                   device="cpu")
    # the trees; the file's names are Column_1.. (the label is column 0)
    def trees(t):
        return t.split("\nTree=0\n")[1].split("end of trees")[0]
    assert trees(bst.model_to_string()) == trees(text)
    assert "feature_names=Column_1 Column_2 Column_3 Column_4" in text


@pytest.mark.parametrize("raw", [False, True])
def test_cli_predict_matches_booster(workdir, raw):
    out = f"pred_{int(raw)}.txt"
    _run("lightgbm_tpu_torch",
         ["task=predict", "data=data.test", "input_model=model.txt",
          f"output_result={out}", "device_type=cpu",
          f"predict_raw_score={str(raw).lower()}"], workdir)
    bst = lt.Booster(model_file=str(workdir / "model.txt"), device="cpu")
    data = np.loadtxt(workdir / "data.test", delimiter="\t")
    np.testing.assert_allclose(np.loadtxt(workdir / out),
                               bst.predict(data[:, 1:], raw_score=raw),
                               atol=1e-10)


def test_reference_cli_predicts_port_model(workdir):
    pytest.importorskip("jax")
    _run("lightgbm_tpu_torch",
         ["task=predict", "data=data.test", "input_model=model.txt",
          "output_result=pred_port.txt", "device_type=cpu"], workdir)
    _run("lightgbm_tpu",
         ["task=predict", "data=data.test", "input_model=model.txt",
          "output_result=pred_ref.txt", "device_type=cpu"], workdir)
    np.testing.assert_allclose(np.loadtxt(workdir / "pred_port.txt"),
                               np.loadtxt(workdir / "pred_ref.txt"),
                               atol=1e-10)


def test_cli_predict_leaf_and_early_stop(workdir, tmp_path):
    """A predict .conf in another directory: leaf indices, and the
    prediction early stop knobs reaching the loaded model."""
    bst = lt.Booster(model_file=str(workdir / "model.txt"), device="cpu")
    X = np.loadtxt(workdir / "data.test", delimiter="\t")[:, 1:]
    (tmp_path / "p.conf").write_text(
        f"task = predict\ndata = {workdir / 'data.test'}\n"
        f"model_file = {workdir / 'model.txt'}\n"
        f"output_result = {tmp_path / 'leaf.txt'}\n"
        "predict_leaf_index = true\ndevice_type = cpu\nverbosity = -1\n")
    _run("lightgbm_tpu_torch", ["config=p.conf"], tmp_path)
    np.testing.assert_array_equal(np.loadtxt(tmp_path / "leaf.txt"),
                                  bst.predict(X, pred_leaf=True))
    _run("lightgbm_tpu_torch",
         ["config=p.conf", "predict_leaf_index=false",
          f"output_result={tmp_path / 'es.txt'}", "pred_early_stop=true",
          "pred_early_stop_freq=2", "pred_early_stop_margin=0.5"], tmp_path)
    np.testing.assert_allclose(
        np.loadtxt(tmp_path / "es.txt"),
        bst.predict(X, pred_early_stop=True, pred_early_stop_freq=2,
                    pred_early_stop_margin=0.5), atol=1e-10)


@pytest.mark.parametrize("task,item", [("serve", "serving"),
                                       ("convert_model", "convert_model"),
                                       ("refit", "online")])
def test_unported_task_names_its_item(workdir, task, item):
    r = _run("lightgbm_tpu_torch",
             [f"task={task}", "input_model=model.txt", "device_type=cpu"],
             workdir, check=False)
    assert r.returncode != 0
    assert "ROADMAP.md" in r.stderr and item in r.stderr
