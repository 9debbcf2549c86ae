"""The loadable C ABI of the port (``native/capi_abi.c``, built by
``native.capi_abi_lib`` into ``build/``): the C program of
tests/test_capi_abi.py, with ``device_type=cpu`` added to its parameter
string, links the port's library, creates a dataset from raw row-major
memory, sets the label field, boosts 10 rounds, predicts, saves, reloads
and predicts again through ``LGBM_*`` symbols the dynamic linker
resolves.  Its model's trees equal those of ``lightgbm_tpu_torch.train``
on the same rows (the program's own generator, replayed in numpy).  The
program's source is read from that file, not imported: the JAX package
need not be importable.  Skips only where gcc or a shared libpython is
missing."""
import ast
import os
import shutil
import subprocess
import sysconfig
from pathlib import Path

import numpy as np
import pytest

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import native

ROOT = Path(__file__).resolve().parent.parent
PARAMS = "objective=binary num_leaves=7 min_data_in_leaf=5 verbose=-1"


def _c_program() -> str:
    """``C_PROGRAM`` of tests/test_capi_abi.py, with the CPU asked for."""
    tree = ast.parse((ROOT / "tests" / "test_capi_abi.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and \
                node.targets[0].id == "C_PROGRAM":
            src = ast.literal_eval(node.value)
            break
    # the parameters PARAMS holds, split over two string literals there
    assert '"objective=binary num_leaves=7 min_data_in_leaf=5 "' in src
    out = src.replace('"verbose=-1";', '"verbose=-1 device_type=cpu";')
    assert out != src
    return out


def _program_rows(N=400, F=4):
    """The C program's rows: its linear congruential generator."""
    X = np.empty((N, F))
    s = 42
    for i in range(N):
        for j in range(F):
            s = (s * 1664525 + 1013904223) & 0xFFFFFFFF
            X[i, j] = ((s >> 8) / 16777216.0) * 4.0 - 2.0
    y = (X[:, 0] + 0.3 * X[:, 1] > 0.0).astype(np.float32)
    return X, y


def _trees(text: str) -> str:
    return text[text.index("Tree=0"):text.index("end of trees")]


def test_c_program_trains_through_the_port_abi(tmp_path):
    if shutil.which("gcc") is None:
        pytest.skip("gcc is not installed")
    if not sysconfig.get_config_var("Py_ENABLE_SHARED"):
        pytest.skip("this Python has no shared libpython to embed")
    lib = native.capi_abi_lib()
    assert Path(lib).parent == ROOT / "build"
    src = tmp_path / "main.c"
    src.write_text(_c_program())
    exe = str(tmp_path / "abi_demo")
    libdir = os.path.dirname(lib)
    r = subprocess.run(
        ["gcc", "-O1", str(src), f"-L{libdir}",
         f"-l:{os.path.basename(lib)}", f"-Wl,-rpath,{libdir}", "-lm",
         "-o", exe], capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT), sysconfig.get_paths()["purelib"]]
        + env.get("PYTHONPATH", "").split(os.pathsep))
    env["OMP_NUM_THREADS"] = "1"
    model = tmp_path / "abi_model.txt"
    r = subprocess.run([exe, str(model)], capture_output=True, text=True,
                       env=env, timeout=300)
    assert r.returncode == 0, (r.stdout, r.stderr)
    assert "C_ABI_OK iters=10" in r.stdout

    X, y = _program_rows()
    params = dict(tok.split("=") for tok in PARAMS.split())
    bst = lt.train(params, lt.Dataset(X, label=y), 10, device="cpu")
    assert _trees(model.read_text()) == _trees(bst.model_to_string())
    loaded = lt.Booster(model_file=str(model), device="cpu")
    np.testing.assert_array_equal(loaded.predict(X), bst.predict(X))


def test_a_failed_build_raises(tmp_path, monkeypatch):
    """No fallback: gcc's error comes back as an exception."""
    if shutil.which("gcc") is None:
        pytest.skip("gcc is not installed")
    if not sysconfig.get_config_var("Py_ENABLE_SHARED"):
        pytest.skip("this Python has no shared libpython to embed")
    bad = tmp_path / "capi_abi.c"
    bad.write_text("this is not C\n")
    monkeypatch.setattr(native, "ABI_SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="gcc failed on capi_abi.c"):
        native.capi_abi_lib()
    assert not list((tmp_path / "build").glob("*.so"))
