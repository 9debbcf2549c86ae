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


@pytest.mark.parametrize("task,item", [
    # task=serve runs, its store directory too since serve/aot.py was
    # ported, and the fleet family since fleet/ was; what it still
    # refuses is the train board of item 8B
    pytest.param("serve", "Obs, tools and bindings, part B",
                 id="serve-serving"),
    # task=online and task=refit run since online/ was ported (item None)
    pytest.param("online", None, id="online-online"),
    pytest.param("refit", None, id="refit-online")])
def test_unported_task_names_its_item(workdir, tmp_path, task, item):
    """A task's refusal names its ROADMAP.md item; a ported task runs:
    ``task=refit`` writes the refit model, ``task=online`` serves the
    model and pushes a version a cadence over a finite label stream."""
    args = [f"task={task}", "input_model=model.txt", "device_type=cpu"]
    if item is not None:
        r = _run("lightgbm_tpu_torch", args + ["tpu_train_metrics_port=1"],
                 workdir, check=False)
        assert r.returncode != 0
        assert "ROADMAP.md" in r.stderr and item in r.stderr
        return
    if task == "refit":
        out = tmp_path / "refit.txt"
        _run("lightgbm_tpu_torch", args + ["data=data.test",
                                           f"output_model={out}"], workdir)
        assert out.read_text().count("Tree=") == 8
        return
    import json
    data = np.loadtxt(workdir / "data.train", delimiter="\t")
    stream = tmp_path / "labels.jsonl"
    stream.write_text("".join(json.dumps({"x": r[1:].tolist(), "y": r[0]})
                              + "\n" for r in data))
    _run("lightgbm_tpu_torch",
         args + [f"tpu_online_source={stream}", "tpu_online_refit_every=300",
                 "tpu_online_window=500", f"tpu_online_dir={tmp_path / 'v'}",
                 "tpu_serve_replicas=1", "tpu_serve_rollback_watch_s=0"],
         workdir)
    assert sorted(f for f in os.listdir(tmp_path / "v")
                  if f.endswith(".txt")) == ["model_v2.txt", "model_v3.txt"]


@pytest.mark.parametrize("objective,cols", [
    ("lambdarank", ["weight_column=1", "group_column=0"]),
    ("regression", ["header=true", "weight_column=name:w",
                    "group_column=name:qid"])])
def test_cli_weight_and_group_columns(tmp_path, objective, cols):
    """``task=train`` with a weight and a group (query id) column, by index
    (not counting the label) and by name: the API's model on the same
    weights and query sizes."""
    rng = np.random.default_rng(3)
    qid = np.repeat(np.arange(40), rng.integers(3, 25, size=40))
    n = len(qid)
    X = rng.normal(size=(n, 4))
    w = rng.uniform(0.5, 2.0, n).round(4)
    y = (np.clip(np.round(X[:, 0] + X[:, 1] + 2), 0, 4) if objective ==
         "lambdarank" else X[:, 0] * 2 + X[:, 1] ** 2)
    table = np.column_stack([y, qid, w, X])
    with open(tmp_path / "data.tsv", "w") as fh:
        if "header=true" in cols:
            fh.write("y\tqid\tw\ta\tb\tc\td\n")
        np.savetxt(fh, table, delimiter="\t", fmt="%.8f")
    _run("lightgbm_tpu_torch",
         ["task=train", "data=data.tsv", f"objective={objective}",
          "num_trees=4", "num_leaves=7", "min_data_in_leaf=5",
          "output_model=model.txt", "device_type=cpu", "verbosity=-1", *cols],
         tmp_path)
    text = (tmp_path / "model.txt").read_text()
    bst = lt.train({"objective": objective, "num_leaves": 7,
                    "min_data_in_leaf": 5, "verbose": -1},
                   lt.Dataset(table[:, 3:].round(8), label=y.round(8),
                              weight=w, group=np.bincount(qid)), 4,
                   device="cpu")

    def trees(t):
        return t.split("\nTree=0\n")[1].split("end of trees")[0]
    assert text.count("Tree=") == 4
    assert trees(bst.model_to_string()) == trees(text)


def _fixture(name):
    return os.path.join(REPO, "tests", "fixtures", name)


_HARNESS = r"""
#include <stdio.h>
#include <stdlib.h>
void PredictRaw(const double* row, double* output);
int main(int argc, char** argv) {
  int n = atoi(argv[2]), f = atoi(argv[3]), k = atoi(argv[4]);
  FILE* fh = fopen(argv[1], "rb");
  double* row = malloc(sizeof(double) * f);
  double* out = malloc(sizeof(double) * k);
  for (int i = 0; i < n; ++i) {
    if (fread(row, sizeof(double), f, fh) != (size_t)f) return 1;
    PredictRaw(row, out);
    for (int j = 0; j < k; ++j) printf("%.17g\n", out[j]);
  }
  return 0;
}
"""


@pytest.mark.parametrize("model,rows", [
    ("ref_binary_model.txt", "binary_test_rows.npy"),
    ("ref_cat_model.txt", "cat_rows.npy")])
def test_model_to_if_else_matches_reference_and_compiles(tmp_path, model,
                                                         rows):
    """The C code generator: the JAX package's string for the same model
    file, byte for byte; compiled with the host C compiler, it scores
    rows within 1e-10 of ``predict(raw_score=True)``."""
    pytest.importorskip("jax")
    import shutil

    import lightgbm_tpu
    bst = lt.Booster(model_file=_fixture(model), device="cpu")
    code = bst.model_to_if_else()
    assert code == lightgbm_tpu.Booster(
        model_file=_fixture(model)).model_to_if_else()
    cc = shutil.which("cc") or shutil.which("gcc")
    if cc is None:
        pytest.skip("no C compiler on this machine to build the code")
    X = np.load(_fixture(rows))
    X = X[:, 1:] if X.shape[1] == bst.num_feature() + 1 else X
    X = np.ascontiguousarray(X[:200], np.float64)
    (tmp_path / "model.c").write_text(code)
    (tmp_path / "main.c").write_text(_HARNESS)
    X.tofile(tmp_path / "rows.bin")
    exe = str(tmp_path / "score")
    subprocess.run([cc, "-O1", "-o", exe, str(tmp_path / "model.c"),
                    str(tmp_path / "main.c"), "-lm"], check=True,
                   timeout=300)
    K = bst.num_model_per_iteration()
    out = subprocess.run([exe, str(tmp_path / "rows.bin"), str(len(X)),
                          str(X.shape[1]), str(K)], check=True,
                         capture_output=True, text=True, timeout=60).stdout
    got = np.asarray(out.split(), np.float64).reshape(len(X), K)
    want = bst.predict(X, raw_score=True).reshape(len(X), K)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)


def test_cli_convert_model(workdir):
    """task=convert_model writes ``Booster.model_to_if_else`` of the
    input model to ``convert_model``."""
    _run("lightgbm_tpu_torch", ["task=convert_model", "input_model=model.txt",
                                "convert_model=model.c", "device_type=cpu"],
         workdir)
    bst = lt.Booster(model_file=str(workdir / "model.txt"), device="cpu")
    assert (workdir / "model.c").read_text() == bst.model_to_if_else()


def test_cli_predict_contrib(workdir):
    """task=predict with predict_contrib: [n, F+1] per row, the
    Booster's contributions."""
    _run("lightgbm_tpu_torch", ["task=predict", "data=data.test",
                                "input_model=model.txt",
                                "output_result=contrib.txt",
                                "predict_contrib=true", "device_type=cpu"],
         workdir)
    got = np.loadtxt(workdir / "contrib.txt", delimiter="\t")
    X = np.loadtxt(workdir / "data.test", delimiter="\t")[:, 1:]
    bst = lt.Booster(model_file=str(workdir / "model.txt"), device="cpu")
    assert got.shape == (len(X), X.shape[1] + 1)
    np.testing.assert_allclose(got, bst.predict(X, pred_contrib=True),
                               rtol=0, atol=1e-10)


@pytest.mark.parametrize("min_work", ["0", "1000000000"])
def test_cli_predict_routes_agree(workdir, min_work):
    """``LGBM_TPU_PREDICT_MIN_WORK`` forces the route: 0 sends the rows
    through a ``PredictorSession`` (as the JAX package's CLI does for
    heavy work), a huge value through ``Booster.predict``; both agree at
    the serving tolerance."""
    out = f"route_{min_work}.txt"
    env = dict(os.environ, LGBM_TPU_PREDICT_MIN_WORK=min_work,
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    r = subprocess.run(
        [sys.executable, "-m", "lightgbm_tpu_torch", "task=predict",
         "data=data.test", "input_model=model.txt", f"output_result={out}",
         "device_type=cpu"], cwd=workdir, env=env, capture_output=True,
        text=True, timeout=420)
    assert r.returncode == 0, r.stderr[-2000:]
    assert ("through a PredictorSession" in r.stderr) == (min_work == "0")
    bst = lt.Booster(model_file=str(workdir / "model.txt"), device="cpu")
    X = np.loadtxt(workdir / "data.test", delimiter="\t")[:, 1:]
    np.testing.assert_allclose(np.loadtxt(workdir / out), bst.predict(X),
                               rtol=0, atol=1e-6)


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _http(url, payload=None, timeout=30):
    import json
    import urllib.error
    import urllib.request
    data = None if payload is None else json.dumps(payload).encode()
    try:
        with urllib.request.urlopen(urllib.request.Request(url, data=data),
                                    timeout=timeout) as resp:
            body = resp.read().decode()
            code = resp.status
    except urllib.error.HTTPError as exc:
        body, code = exc.read().decode(), exc.code
    return code, (json.loads(body) if body.startswith("{") else body)


def test_cli_task_serve(workdir):
    """task=serve on the CPU: the fleet answers /health, /predict,
    /explain, /metrics, /stats, /models, swap and rollback, and exits
    cleanly on SIGINT."""
    import signal
    import time
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen(
        [sys.executable, "-m", "lightgbm_tpu_torch", "task=serve",
         "input_model=model.txt", "device_type=cpu",
         f"tpu_serve_port={port}", "tpu_serve_replicas=2",
         "tpu_serve_max_batch=64", "tpu_serve_rollback_watch_s=0"],
        cwd=workdir, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    url = f"http://127.0.0.1:{port}"
    try:
        deadline = time.time() + 120
        health = None
        while time.time() < deadline and proc.poll() is None:
            try:
                code, health = _http(url + "/health", timeout=5)
                if code == 200:
                    break
            except OSError:
                time.sleep(0.2)
        assert proc.poll() is None and health["status"] == "ok", health
        assert len(health["replicas"]) == 2
        bst = lt.Booster(model_file=str(workdir / "model.txt"), device="cpu")
        X = np.loadtxt(workdir / "data.test", delimiter="\t")[:50, 1:]
        code, body = _http(url + "/predict", {"rows": X.tolist()})
        assert code == 200 and body["version"] == 1
        np.testing.assert_allclose(body["predictions"], bst.predict(X),
                                   rtol=0, atol=1e-6)
        code, body = _http(url + "/explain", {"rows": X[:5].tolist()})
        np.testing.assert_allclose(body["contributions"],
                                   bst.predict(X[:5], pred_contrib=True),
                                   rtol=0, atol=1e-5)
        code, text = _http(url + "/metrics")
        assert code == 200 and "tpu_serve_models 1" in text
        assert _http(url + "/stats")[0] == 200
        assert _http(url + "/models")[1]["default"] == "default"
        code, rep = _http(url + "/models/default/swap",
                          {"model_file": "model.txt"})
        assert code == 200 and rep["to_version"] == 2
        code, rep = _http(url + "/models/default/rollback", {})
        assert code == 200 and rep["to_version"] == 1
    finally:
        if proc.poll() is None:
            proc.send_signal(signal.SIGINT)
        try:
            out, err = proc.communicate(timeout=10)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            raise
    assert proc.returncode == 0, err[-2000:]
