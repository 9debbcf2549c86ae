"""Process bootstrap across ranks (``lightgbm_tpu_torch/parallel/
distributed.py``; reference: network.cpp Network::Init, config.h network
parameters), twins of tests/test_distributed.py: the machine-list forms
and their fatals against the JAX package's parser, the single-machine
no-op, ``Booster.set_network``/``free_network``, rank resolution, the
single-process identity of ``global_bin_sample`` and, in a real 2-process
gloo group (``tools/dist_check.py``, a file store in ``tmp_path``), the
pooled bin sample, the ``tpu_mesh_shape`` rule, and 5 rounds of
data-parallel int16 boosting whose model equals the 1-process run's bit
for bit on both ranks.  The CLI's ``task=train`` reads
``machine_list_filename``."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.parallel import distributed, mesh
from lightgbm_tpu_torch.tools.dist_check import launch
from lightgbm_tpu_torch.utils.log import LightGBMError


@pytest.fixture(autouse=True)
def _one_cpu_thread():
    """One intra-op thread a test: a parallel test run shares the machine
    among its workers, and torch's CPU thread pool then spends most of a
    small op waiting for oversubscribed threads.  Restored after each
    test."""
    import torch
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def test_parse_machine_list_forms(tmp_path):
    got = distributed.parse_machine_list("10.0.0.1:121,10.0.0.2:122")
    assert got == ["10.0.0.1:121", "10.0.0.2:122"]
    got = distributed.parse_machine_list("hostA,hostB", default_port=9000)
    assert got == ["hostA:9000", "hostB:9000"]
    p = tmp_path / "mlist.txt"
    p.write_text("10.0.0.1 121\n10.0.0.2 122\n\n")
    got = distributed.parse_machine_list(machine_list_filename=str(p))
    assert got == ["10.0.0.1:121", "10.0.0.2:122"]
    pytest.importorskip("jax")
    from lightgbm_tpu.parallel import distributed as jdist
    for args in ((("a:1, b:2\nc",), {}), ((), {"machine_list_filename":
                                               str(p)}),
                 (("hostA",), {"default_port": 7})):
        assert distributed.parse_machine_list(*args[0], **args[1]) == \
            jdist.parse_machine_list(*args[0], **args[1])


def test_single_machine_is_noop(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert distributed.init_distributed(num_machines=1) is False
    assert distributed.init_distributed(lt.Config.from_params(
        {"verbose": -1})) is False
    assert distributed.world_size() == 1 and distributed.rank() == 0


def test_machine_count_mismatch_is_fatal():
    with pytest.raises(LightGBMError, match="machine list"):
        distributed.init_distributed(machines="a:1,b:2,c:3", num_machines=2)


def test_missing_machine_list_file_is_fatal(tmp_path):
    with pytest.raises(LightGBMError, match="does not exist"):
        distributed.parse_machine_list(
            machine_list_filename=str(tmp_path / "nope.txt"))


def test_set_network_records_topology():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(200, 4))
    y = (X[:, 0] > 0).astype(np.float64)
    p = {"objective": "binary", "num_leaves": 7, "verbose": -1,
         "min_data_in_leaf": 5}
    bst = lt.train(p, lt.Dataset(X, label=y, params=p), 1, device="cpu")
    try:
        assert bst.set_network(["10.1.1.1:121", "10.1.1.2"],
                               local_listen_port=5, listen_time_out=3,
                               num_machines=2) is bst
        assert mesh.NETWORK["num_machines"] == 2
        assert mesh.NETWORK["machines"] == "10.1.1.1:121,10.1.1.2:5"
        assert mesh.NETWORK["time_out"] == 3
        assert bst.free_network() is bst
        assert mesh.NETWORK["num_machines"] == 1
        assert mesh.NETWORK["machines"] == ""
    finally:
        mesh.NETWORK.update(machines="", num_machines=1, rank=0)


def test_process_id_resolution(monkeypatch):
    monkeypatch.setitem(mesh.NETWORK, "rank", 0)
    monkeypatch.delenv("RANK", raising=False)
    monkeypatch.setenv("LGBM_TPU_RANK", "3")
    assert distributed.process_id() == 3
    monkeypatch.delenv("LGBM_TPU_RANK")
    monkeypatch.setenv("RANK", "2")
    assert distributed.process_id() == 2
    monkeypatch.setitem(mesh.NETWORK, "rank", 1)
    assert distributed.process_id() == 1


def test_process_id_from_machine_list(monkeypatch):
    monkeypatch.setitem(mesh.NETWORK, "rank", 0)
    for var in ("LGBM_TPU_RANK", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert distributed.process_id(["10.9.9.9:12400", "localhost:12400"]) == 1
    assert distributed.process_id(["10.9.9.8:1", "10.9.9.9:1"]) is None


def test_global_bin_sample_single_host_identity():
    s = np.random.default_rng(0).normal(size=(50, 3))
    out, n_global = distributed.global_bin_sample(s, 200)
    assert out is s
    assert n_global == 200
    import scipy.sparse as sp
    csc = sp.random(20, 4, density=0.3, format="csc", random_state=1)
    out, n = distributed.global_bin_sample_sparse(csc, 20)
    assert out is csc and n == 20
    assert distributed.rank_allgather_stats([1.0, 2.0]) is None


def test_build_mesh_single_process():
    assert mesh.build_mesh("").size == 1
    assert mesh.build_mesh("data:4").size == 1      # at or above the world
    for bad in ("data:0", "data:x"):
        with pytest.raises(LightGBMError, match="tpu_mesh_shape"):
            mesh.build_mesh(bad)


def _problem(n=900, f=5, seed=3):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f))
    y = (X[:, 0] + X[:, 1] * X[:, 2] > 0).astype(np.float64)
    return X, y


def test_two_process_data_parallel_bitmatch(tmp_path):
    """Twin of test_distributed.py::test_two_process_data_parallel_bitmatch:
    two ranks bring the group up, pool their bin samples, refuse a mesh
    smaller than the world, and train 5 int16 data-parallel rounds whose
    model text (trees) equals the single-process run's on both ranks."""
    X, y = _problem()
    np.savez(tmp_path / "rows.npz", X=X, y=y)
    p = {"objective": "binary", "num_leaves": 15, "verbose": -1,
         "min_data_in_leaf": 5, "tree_learner": "data",
         "tpu_hist_dtype": "int16"}
    spec = {"data": str(tmp_path / "rows.npz"), "device": "cpu",
            "bin_sample": True,
            "mesh_shapes": ["", "data:2", "data:8", "data:1"],
            "modes": [{"name": "int16", "params": p, "rounds": 5}]}
    with open(tmp_path / "spec.json", "w") as fh:
        json.dump(spec, fh)
    res = launch(str(tmp_path / "spec.json"), 2, str(tmp_path), timeout=300)
    one = lt.train(p, lt.Dataset(X, label=y, params=p), 5, device="cpu")
    want = one.model_to_string().split("\nparameters:")[0]
    for r in res:
        assert r["ok"] and r["group"] and r["world_seen"] == 2
        assert r["bin_sample"] == {"rows": len(X), "equal": True}
        shapes = r["mesh_shapes"]
        assert shapes[""] == shapes["data:2"] == shapes["data:8"] == 2
        assert shapes["data:1"].startswith("refused") \
            and "fewer ranks" in shapes["data:1"]
        m = r["modes"]["int16"]
        assert m["ranks"] == 2 and m["backend"] == "gloo"
        assert m["model"].split("\nparameters:")[0] == want
        np.testing.assert_array_equal(np.asarray(m["raw"]),
                                      one.predict(X, raw_score=True))


def test_cli_train_reads_the_machine_list(tmp_path):
    """``task=train`` reads ``machine_list_filename``: a list whose length
    is not ``num_machines`` is fatal before any rendezvous."""
    X, y = _problem(n=200)
    data = tmp_path / "train.tsv"
    np.savetxt(data, np.column_stack([y, X]), delimiter="\t")
    mlist = tmp_path / "mlist.txt"
    mlist.write_text("127.0.0.1 12400\n127.0.0.1 12401\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    r = subprocess.run(
        [sys.executable, "-m", "lightgbm_tpu_torch", "task=train",
         f"data={data}", "objective=binary", "tree_learner=data",
         "num_machines=3", f"machine_list_filename={mlist}",
         "device_type=cpu", f"output_model={tmp_path / 'm.txt'}"],
        capture_output=True, text=True, timeout=120, cwd=str(tmp_path),
        env=env)
    assert r.returncode != 0
    assert "num_machines=3 but the machine list has 2 entries" in r.stderr
