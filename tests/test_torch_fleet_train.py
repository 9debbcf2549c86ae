"""The elastic training fleet in the port (lightgbm_tpu_torch/fleet/) on the
CPU: the twins of tests/test_fleet_train.py.

1. geometry: ``RowShardPlan.replan`` re-cuts the same rows for another
   world size (the JAX package's cuts), and sharded ingest halves stack
   to the whole stream;
2. the transport in process: a real ``FleetHub`` and threaded
   ``FleetClient``s over loopback TCP (ordered gathers, the allgather
   contract, dead ranks, the resize barrier, the checkpoint fetch);
3. the fleet end to end: ``launch_fleet`` starts 3 ranks over the host
   transport (``device_type=cpu``); the elected model and every rank's
   copy have the trees of the port's single-process CLI model, byte for
   byte, and that model is within the regression differential's budget
   of the JAX package's CLI model (tests/test_torch_train_objectives.py:
   trees equal in structure, leaves within 5e-5 of the tree's largest,
   predictions within rtol 1e-5 / atol 1e-5; the JAX side on its wave
   grower, ``LGBM_TPU_FORCE_WAVE=interpret``).

The kill-one-rank leg is ``slow`` as its JAX twin is; the card runs it
(``chip_smoke.py`` phase 33).
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.fleet.launch import (_worker_argv,
                                             device_collective_support,
                                             resolve_fleet, run_done,
                                             should_gang_launch,
                                             wait_rendezvous, write_done,
                                             write_rendezvous)
from lightgbm_tpu_torch.fleet.transport import (FleetClient,
                                                FleetCoordinatorLost,
                                                FleetError, FleetHub,
                                                FleetPeerLost,
                                                HostCollectives)
from lightgbm_tpu_torch.ingest.shard import (local_query_sizes,
                                             plan_row_shards)
from lightgbm_tpu_torch.robust.checkpoint import (CheckpointManager,
                                                  config_digest)
from lightgbm_tpu_torch.utils.log import LightGBMError

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_cpu_thread():
    """One intra-op thread a test: a parallel test run shares the machine
    among its workers.  Restored after each test."""
    import torch
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# ---------------------------------------------------------------------------
# 1. shard re-planning
# ---------------------------------------------------------------------------

def _covered_rows(plan):
    out = []
    for s in range(plan.num_shards):
        lo, hi = plan.shard_range(s)
        assert lo <= hi
        out.append(np.arange(lo, hi))
    return np.concatenate(out)


def _jax_plan(*args):
    pytest.importorskip("jax")
    from lightgbm_tpu.ingest.shard import plan_row_shards as jax_plan
    return jax_plan(*args)


def test_replan_shrink_exact_repartition():
    plan = plan_row_shards(120, 3)
    re2 = plan.replan(2)
    assert re2.num_shards == 2 and re2.n_rows == 120
    np.testing.assert_array_equal(_covered_rows(re2), np.arange(120))
    assert [re2.local_rows(s) for s in range(2)] == [60, 60]
    np.testing.assert_array_equal(plan.cuts, [0, 40, 80, 120])
    np.testing.assert_array_equal(re2.cuts, _jax_plan(120, 3).replan(2).cuts)


def test_replan_grow_exact_repartition():
    plan = plan_row_shards(121, 2)
    re4 = plan.replan(4)
    np.testing.assert_array_equal(_covered_rows(re4), np.arange(121))
    sizes = [re4.local_rows(s) for s in range(4)]
    assert sum(sizes) == 121 and max(sizes) - min(sizes) <= 1
    np.testing.assert_array_equal(re4.cuts, _jax_plan(121, 2).replan(4).cuts)


def test_replan_preserves_query_alignment():
    rng = np.random.default_rng(0)
    qsizes = rng.integers(3, 15, size=17)
    b = np.concatenate([[0], np.cumsum(qsizes)]).astype(np.int64)
    n = int(b[-1])
    plan = plan_row_shards(n, 3, b)
    assert plan.query_aligned
    re2 = plan.replan(2, b)
    assert re2.query_aligned
    np.testing.assert_array_equal(_covered_rows(re2), np.arange(n))
    assert set(re2.cuts.tolist()) <= set(b.tolist())
    q0 = local_query_sizes(re2, 0, b)
    q1 = local_query_sizes(re2, 1, b)
    np.testing.assert_array_equal(np.concatenate([q0, q1]), qsizes)
    jre2 = _jax_plan(n, 3, b).replan(2, b)
    np.testing.assert_array_equal(re2.cuts, jre2.cuts)
    np.testing.assert_array_equal(re2.query_cuts, jre2.query_cuts)


def test_replan_without_boundaries_drops_alignment():
    b = np.array([0, 10, 25, 40], dtype=np.int64)
    plan = plan_row_shards(40, 2, b)
    assert plan.query_aligned
    assert not plan.replan(3).query_aligned


def test_two_shard_ingest_concat_bitmatches_oracle():
    from lightgbm_tpu_torch.ingest import ArraySource, ingest_dataset
    rng = np.random.default_rng(42)
    X = rng.normal(size=(150, 6))
    y = rng.normal(size=150)
    cfg = Config.from_params({"verbose": -1, "max_bin": 31})
    oracle = ingest_dataset(ArraySource(X, label=y, chunk_rows=41), cfg)
    halves = [ingest_dataset(ArraySource(X, label=y, chunk_rows=41), cfg,
                             num_shards=2, shard_id=r) for r in (0, 1)]
    for h in halves:
        np.testing.assert_array_equal(h.bin_offsets, oracle.bin_offsets)
    np.testing.assert_array_equal(
        np.concatenate([np.asarray(h.X_bin) for h in halves], axis=0),
        np.asarray(oracle.X_bin))
    lo0, hi0 = halves[0].ingest_row_range
    lo1, hi1 = halves[1].ingest_row_range
    assert (lo0, hi1) == (0, 150) and hi0 == lo1


# ---------------------------------------------------------------------------
# 2. the transport: an in-process hub and threaded clients
# ---------------------------------------------------------------------------

def _hub(tmp_path, world=3, heartbeat_s=2.0, **kw):
    hub = FleetHub(world_size=world, heartbeat_s=heartbeat_s,
                   events_path=str(tmp_path / "events.jsonl"), **kw)
    return hub, hub.start()


def _run_all(fns):
    """One callable a rank, concurrently; the first failure re-raised."""
    out = [None] * len(fns)
    errs = []

    def wrap(i):
        try:
            out[i] = fns[i]()
        except BaseException as exc:  # noqa: BLE001 — reported below
            errs.append(exc)

    ts = [threading.Thread(target=wrap, args=(i,)) for i in range(len(fns))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
    if errs:
        raise errs[0]
    return out


def _events(path):
    return [json.loads(line) for line in open(path)]


def test_gather_returns_parts_in_shard_order(tmp_path):
    hub, addr = _hub(tmp_path)
    try:
        clients = [FleetClient(addr, mid=r, heartbeat_s=2.0)
                   for r in range(3)]
        res = _run_all([(lambda c=c: c.gather("k", {"from": c.shard}))
                        for c in clients])
        for parts, view in res:
            assert [p["from"] for p in parts] == [0, 1, 2]
            assert view["world"] == 3 and view["epoch"] == 0
        res2 = _run_all([(lambda c=c: c.gather("k", c.shard * 10))
                         for c in clients])
        assert all(parts == [0, 10, 20] for parts, _ in res2)
        for c in clients:
            c.bye()
        assert hub.wait_drain(timeout=5)
    finally:
        hub.stop()


def test_host_collectives_allgather_contract(tmp_path):
    """[world, *shape] in shard-rank order, the dtype kept; a torch
    tensor goes on the wire as its host numpy copy; ``pause`` stands the
    collectives down.  Installed, they are ``parallel/distributed``'s."""
    import torch

    from lightgbm_tpu_torch.parallel import distributed
    hub, addr = _hub(tmp_path)
    try:
        clients = [FleetClient(addr, mid=r, heartbeat_s=2.0)
                   for r in range(3)]
        colls = [HostCollectives(c) for c in clients]
        assert all(c.active() and c.world_size == 3 for c in colls)
        assert [c.rank for c in colls] == [0, 1, 2]

        def leg(i):
            a = np.full((2, 2), i, dtype=np.float32)
            return colls[i].allgather(torch.from_numpy(a) if i == 1 else a)

        for stacked in _run_all([(lambda i=i: leg(i)) for i in range(3)]):
            assert isinstance(stacked, np.ndarray)
            assert stacked.shape == (3, 2, 2)
            assert stacked.dtype == np.float32
            np.testing.assert_array_equal(stacked[:, 0, 0], [0, 1, 2])
        with colls[0].pause():
            assert not colls[0].active()
        assert colls[0].active()
        distributed.set_host_collectives(colls[0])
        try:
            assert distributed.world_size() == 3
            assert distributed.rank() == 0
        finally:
            distributed.set_host_collectives(None)
        assert distributed.world_size() == 1
        for c in clients:
            c.bye()
    finally:
        hub.stop()


def test_silent_rank_classified_dead_and_peers_told(tmp_path):
    hub, addr = _hub(tmp_path, heartbeat_s=0.5)
    try:
        clients = [FleetClient(addr, mid=r, heartbeat_s=0.5)
                   for r in range(2)]

        def leg(c):
            with pytest.raises(FleetPeerLost) as ei:
                c.gather("hb", {"iteration": 1})
            return ei.value.lost

        t0 = time.time()
        assert all(lost == [2] for lost in
                   _run_all([(lambda c=c: leg(c)) for c in clients]))
        assert time.time() - t0 < 10
        dead = [e for e in _events(tmp_path / "events.jsonl")
                if e["name"] == "member_dead"]
        assert len(dead) == 1 and dead[0]["mid"] == 2
        assert "timeout" in dead[0]["why"]
    finally:
        hub.stop()


def test_socket_drop_classified_dead(tmp_path):
    hub, addr = _hub(tmp_path)
    try:
        clients = [FleetClient(addr, mid=r, heartbeat_s=2.0)
                   for r in range(3)]
        clients[1].sock.close()          # a SIGKILL's signature: EOF
        deadline = time.time() + 5
        while time.time() < deadline and hub.members[1]["alive"]:
            time.sleep(0.02)
        assert not hub.members[1]["alive"]

        def leg(c):
            with pytest.raises(FleetPeerLost) as ei:
                c.gather("hb", {})
            return ei.value.lost

        assert all(lost == [1] for lost in _run_all(
            [(lambda c=c: leg(c)) for c in (clients[0], clients[2])]))
    finally:
        hub.stop()


def test_resize_admits_joiner_with_dense_shards(tmp_path):
    hub, addr = _hub(tmp_path, world=2)
    try:
        c0 = FleetClient(addr, mid=0, heartbeat_s=2.0)
        c1 = FleetClient(addr, mid=1, heartbeat_s=2.0)
        j = FleetClient(addr, mid=None, join=True, heartbeat_s=2.0)
        assert j.pending and j.mid == 2
        reps = _run_all([c.resize for c in (c0, c1, j)])
        assert all(r["world"] == 3 and r["epoch"] == 1 for r in reps)
        assert (c0.shard, c1.shard, j.shard) == (0, 1, 2)
        assert not j.pending
        rz = [e for e in _events(tmp_path / "events.jsonl")
              if e["name"] == "resize"]
        assert rz and rz[-1]["joiners"] == 1 and rz[-1]["world"] == 3
        for c in (c0, c1, j):
            c.bye()
    finally:
        hub.stop()


def test_parked_joiner_told_done_after_run_completes(tmp_path):
    hub, addr = _hub(tmp_path, world=2)
    try:
        c0 = FleetClient(addr, mid=0, heartbeat_s=2.0)
        c1 = FleetClient(addr, mid=1, heartbeat_s=2.0)
        c0.bye()
        c1.bye()
        j = FleetClient(addr, mid=None, join=True, heartbeat_s=2.0)
        assert j.resize().get("done") is True
        j.bye()
    finally:
        hub.stop()


def test_fetch_checkpoint_roundtrip(tmp_path):
    ck = tmp_path / "ckpt" / "ckpt_00000008"
    ck.mkdir(parents=True)
    (ck / "model.txt").write_text("tree\nfleet fetch payload\n")
    hub, addr = _hub(tmp_path, world=1, ckpt_dir=str(tmp_path / "ckpt"))
    try:
        c = FleetClient(addr, mid=0, heartbeat_s=2.0)
        dest = tmp_path / "joiner"
        assert c.fetch_checkpoint(str(dest)) == 0
        hub.serve_iteration = 8
        assert c.fetch_checkpoint(str(dest)) == 8
        assert (dest / "ckpt_00000008" / "model.txt").read_text() == \
            "tree\nfleet fetch payload\n"
        c.bye()
    finally:
        hub.stop()


def test_hub_refuses_unknown_member(tmp_path):
    hub, addr = _hub(tmp_path, world=2)
    try:
        c0 = FleetClient(addr, mid=0, heartbeat_s=2.0)
        c0.mid = 7                      # a member id never registered
        with pytest.raises(FleetError):
            c0.gather("hb", {})
    finally:
        hub.stop()


def test_frames_interoperate_with_the_jax_hub(tmp_path):
    """The port's client speaks the JAX package's frames: a JAX hub
    gathers a port client's parts in shard order."""
    pytest.importorskip("jax")
    from lightgbm_tpu.fleet.transport import FleetClient as JClient
    from lightgbm_tpu.fleet.transport import FleetHub as JHub
    hub = JHub(world_size=2, heartbeat_s=2.0)
    addr = hub.start()
    try:
        a = FleetClient(addr, mid=0, heartbeat_s=2.0)
        b = JClient(addr, mid=1, heartbeat_s=2.0)
        res = _run_all([lambda: a.gather("k", np.arange(3)),
                        lambda: b.gather("k", np.arange(3) + 10)])
        for parts, _ in res:
            np.testing.assert_array_equal(np.stack(parts),
                                          [[0, 1, 2], [10, 11, 12]])
        a.bye()
        b.bye()
    finally:
        hub.stop()


# ---------------------------------------------------------------------------
# 3. config surface, rendezvous files, digest, checkpoints
# ---------------------------------------------------------------------------

def test_config_fleet_knob_validation():
    assert Config.from_params({"tpu_fleet": 3}).tpu_fleet == 3
    for bad in ({"tpu_fleet": -1}, {"tpu_fleet_heartbeat_s": 0},
                {"tpu_fleet_transport": "carrier-pigeon"},
                {"tpu_fleet_min_ranks": 0},
                {"tpu_fleet_max_recoveries": -1}):
        with pytest.raises(LightGBMError):
            Config.from_params(bad)
    for value in ("auto", "jax", "host"):
        assert Config.from_params(
            {"tpu_fleet_transport": value}).tpu_fleet_transport == value


def test_resolve_fleet_env_overrides(monkeypatch):
    cfg = Config.from_params({"tpu_fleet": 2, "tpu_fleet_heartbeat_s": 30,
                              "tpu_fleet_dir": "/cfg"})
    monkeypatch.setenv("LGBM_TPU_FLEET", "4")
    monkeypatch.setenv("LGBM_TPU_FLEET_HEARTBEAT_S", "1.5")
    monkeypatch.setenv("LGBM_TPU_FLEET_TRANSPORT", "host")
    monkeypatch.setenv("LGBM_TPU_FLEET_DIR", "/env")
    fs = resolve_fleet(cfg)
    assert (fs.world, fs.heartbeat_s, fs.transport, fs.fleet_dir) == (
        4, 1.5, "host", "/env")
    monkeypatch.setenv("LGBM_TPU_FLEET", "many")
    monkeypatch.setenv("LGBM_TPU_FLEET_TRANSPORT", "warp")
    fs = resolve_fleet(cfg)
    assert fs.world == 2 and fs.transport == "auto"


def test_should_gang_launch(monkeypatch):
    monkeypatch.delenv("LGBM_TPU_FLEET", raising=False)
    monkeypatch.delenv("LGBM_TPU_FLEET_RANK", raising=False)
    assert should_gang_launch(Config.from_params({"tpu_fleet": 3}))
    assert not should_gang_launch(Config.from_params({"tpu_fleet": 0}))
    monkeypatch.setenv("LGBM_TPU_FLEET_RANK", "1")
    assert not should_gang_launch(Config.from_params({"tpu_fleet": 3}))


def test_device_collective_support_cpu():
    """No CUDA here: ``auto`` takes the host transport, as the JAX
    package's CPU backend does."""
    assert device_collective_support() is False


def test_worker_argv_spawns_the_port():
    argv = _worker_argv({"data": "d.tsv", "tpu_fleet": "2"},
                        {"tpu_fleet": "3", "task": "train"})
    assert argv[:3] == [sys.executable, "-m", "lightgbm_tpu_torch.fleet"]
    assert argv[3:] == ["data=d.tsv", "tpu_fleet=3", "task=train"]


def test_rendezvous_roundtrip(tmp_path):
    write_rendezvous(str(tmp_path), ("127.0.0.1", 12345), world=3)
    assert wait_rendezvous(str(tmp_path), timeout=5) == ("127.0.0.1", 12345)
    with pytest.raises(FleetCoordinatorLost):
        wait_rendezvous(str(tmp_path / "nowhere"), timeout=0.3)


def test_done_marker(tmp_path):
    assert not run_done(str(tmp_path))
    write_done(str(tmp_path), rc=0)
    assert run_done(str(tmp_path))


def test_config_digest_fleet_world_invariance():
    base = {"objective": "regression", "num_leaves": 15, "verbose": -1}
    d3 = config_digest(Config.from_params(
        dict(base, tpu_fleet=3, tpu_ingest_shards=3, tpu_ingest_shard_id=2,
             num_machines=3)))
    d2 = config_digest(Config.from_params(
        dict(base, tpu_fleet=2, tpu_ingest_shards=2, tpu_ingest_shard_id=0,
             num_machines=2)))
    d0 = config_digest(Config.from_params(base))
    assert d3 == d2 == d0
    s2 = config_digest(Config.from_params(
        dict(base, tpu_ingest_shards=2, tpu_ingest_shard_id=0)))
    assert s2 != d0
    assert config_digest(Config.from_params(
        dict(base, num_leaves=31, tpu_fleet=3))) != d3


def test_checkpoint_trim_to(tmp_path):
    for it in (4, 8, 12):
        (tmp_path / f"ckpt_{it:08d}").mkdir()
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.trim_to(8) == 1
    assert sorted(p.name for p in tmp_path.iterdir()) == \
        ["ckpt_00000004", "ckpt_00000008"]
    assert mgr.trim_to(0) == 2 and not any(tmp_path.iterdir())


def test_checkpoint_meta_records_world_size(tmp_path):
    """``world_size`` in ``meta.json``: 1 alone, the host transport's
    world with its collectives installed; never in the digest."""
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.parallel import distributed

    class World3:
        world_size, rank = 3, 0

        def active(self):
            return True

    rng = np.random.default_rng(5)
    X = rng.normal(size=(200, 4))
    y = rng.normal(size=200)
    metas = []
    for sub, coll in (("one", None), ("three", World3())):
        params = {"objective": "regression", "num_leaves": 7, "verbose": -1,
                  "tpu_checkpoint_dir": str(tmp_path / sub),
                  "tpu_checkpoint_freq": 5}
        distributed.set_host_collectives(coll)
        try:
            lt.train(params, lt.Dataset(X, label=y, params=params), 5,
                     device="cpu")
        finally:
            distributed.set_host_collectives(None)
        (meta,) = (tmp_path / sub).glob("ckpt_*/meta.json")
        metas.append(json.loads(meta.read_text()))
    assert [m["world_size"] for m in metas] == [1, 3]
    assert metas[0]["config_digest"] == metas[1]["config_digest"]


# ---------------------------------------------------------------------------
# 4. the fleet end to end: 3 processes, host transport, exact
# ---------------------------------------------------------------------------

def _write_tsv(path, X, y):
    np.savetxt(path, np.column_stack([y, X]), delimiter="\t", fmt="%.8f")


def _tree_text(path):
    with open(path) as fh:
        return fh.read().split("\nparameters:\n")[0]


@pytest.fixture(scope="module")
def fleet_fixture(tmp_path_factory):
    root = tmp_path_factory.mktemp("fleet_e2e")
    rng = np.random.default_rng(3)
    X = rng.normal(size=(120, 5))
    y = X[:, 0] * 2.0 + np.sin(X[:, 1]) + rng.normal(scale=0.1, size=120)
    _write_tsv(root / "train.tsv", X, y)
    return root


def _base_params(root, out_name):
    return {
        "task": "train", "objective": "regression",
        "data": str(root / "train.tsv"), "label_column": "0",
        "num_iterations": "10", "num_leaves": "7", "min_data_in_leaf": "5",
        "learning_rate": "0.1", "tpu_ingest": "true", "verbosity": "-1",
        "output_model": str(root / out_name), "device_type": "cpu",
    }


def _env(**extra):
    return dict(os.environ, PYTHONPATH=REPO + os.pathsep
                + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1",
                **extra)


def _oracle(root, params, tag, module="lightgbm_tpu_torch"):
    """The single-process CLI's model (its own process), fleet keys
    dropped; ``module="lightgbm_tpu"`` for the JAX package's CLI."""
    out = root / f"oracle_{module}_{tag}.txt"
    if not out.exists():
        p = {k: v for k, v in params.items() if not k.startswith("tpu_fleet")}
        p["output_model"] = str(out)
        env = _env()
        if module == "lightgbm_tpu":
            p.pop("device_type")
            env.update(JAX_PLATFORMS="cpu", LGBM_TPU_FORCE_WAVE="interpret")
        subprocess.run([sys.executable, "-m", module,
                        *[f"{k}={v}" for k, v in p.items()]],
                       check=True, env=env, capture_output=True, timeout=300)
    return out


def _launch(params, **kw):
    from lightgbm_tpu_torch.fleet.launch import launch_fleet
    old = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        return launch_fleet(Config.from_params(params), params, **kw)
    finally:
        if old is None:
            os.environ.pop("OMP_NUM_THREADS", None)
        else:
            os.environ["OMP_NUM_THREADS"] = old


def test_three_process_fleet_bitmatches_oracle(fleet_fixture):
    root = fleet_fixture
    params = _base_params(root, "fleet.txt")
    # a rank later than half the heartbeat is stamped ``fleet_stall``:
    # ranks starting beside a loaded parallel test run need the room
    params.update({"tpu_fleet": "3", "tpu_fleet_heartbeat_s": "30",
                   "tpu_fleet_transport": "host",
                   "tpu_fleet_dir": str(root / "fd")})
    res = _launch(params)
    assert res["ok"], res
    assert res["heals"] == 0 and res["rcs"] == {0: 0, 1: 0, 2: 0}
    oracle = _tree_text(_oracle(root, params, "healthy"))
    assert _tree_text(root / "fleet.txt") == oracle
    for r in range(3):
        assert _tree_text(str(root / "fleet.txt") + f".rank{r}") == oracle
    events = _events(root / "fd" / "fleet_events.jsonl")
    assert events[0]["name"] == "hub_up" and events[0]["world"] == 3
    assert not [e for e in events
                if e["name"] in ("member_dead", "resize", "fleet_stall")]
    for r in range(3):
        stats = json.loads((root / "fd" / f"rank{r}.stats.json").read_text())
        assert stats["transport"] == "host" and stats["device"] == "cpu"
        assert len(stats["iter_s"]) == 10 and stats["world"] == 3


def test_single_process_model_matches_the_jax_cli(fleet_fixture):
    """The port's single-process CLI model (the fleet's oracle) against
    the JAX package's CLI model on the same file and parameters."""
    import lightgbm_tpu_torch as lt
    root = fleet_fixture
    params = _base_params(root, "unused.txt")
    port = lt.Booster(model_file=str(_oracle(root, params, "healthy")),
                      device="cpu")
    ref = lt.Booster(model_file=str(_oracle(root, params, "healthy",
                                            module="lightgbm_tpu")),
                     device="cpu")
    X = np.loadtxt(root / "train.tsv", delimiter="\t")[:, 1:]
    pts, rts = port._gbdt.models, ref._gbdt.models
    assert len(pts) == len(rts) == 10
    for pt, rt in zip(pts, rts):
        assert pt.num_leaves == rt.num_leaves
        for name in ("split_feature", "threshold", "decision_type",
                     "left_child", "right_child"):
            np.testing.assert_array_equal(getattr(pt, name),
                                          getattr(rt, name))
        np.testing.assert_allclose(
            pt.leaf_value, rt.leaf_value, rtol=0,
            atol=5e-5 * np.abs(rt.leaf_value).max())
    np.testing.assert_allclose(port.predict(X), ref.predict(X), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.slow
def test_fleet_kill_one_rank_recovers_bitexact(fleet_fixture):
    root = fleet_fixture
    params = _base_params(root, "killed.txt")
    params.update({"tpu_fleet": "3", "tpu_fleet_heartbeat_s": "3",
                   "tpu_fleet_transport": "host",
                   "tpu_fleet_dir": str(root / "fd_kill"),
                   "num_iterations": "12", "tpu_checkpoint_freq": "4"})
    res = _launch(params, per_rank_env={
        1: {"LGBM_TPU_FAULTS": "fleet_die:raise@iter=6"}})
    assert res["ok"], res
    assert res["rcs"][1] == 137 and res["rc"] == 0
    names = [e["name"] for e in
             _events(root / "fd_kill" / "fleet_events.jsonl")]
    assert "member_dead" in names and "resize" in names
    assert _tree_text(root / "killed.txt") == \
        _tree_text(_oracle(root, params, "kill"))


def test_public_names_match_the_jax_package():
    pytest.importorskip("jax")
    import lightgbm_tpu.fleet as ref
    import lightgbm_tpu_torch.fleet as port
    assert sorted(port.__all__) == sorted(ref.__all__)
    assert all(hasattr(port, name) for name in port.__all__)
