"""Aggregation across ranks (``lightgbm_tpu_torch/obs/ranks.py``): the
straggler detector gives the JAX package's verdicts on the same seeded
matrices (hypothesis); a real two-rank gloo run, rank 1 slowed by the
fault harness at ``device_execute`` (each tree's growth), makes rank 0
emit a ``straggler`` event naming rank 1 in ``tree growth``; the
reconciler holds a phase's wall against the port's own cost functions;
``tpu_straggler_iters=0`` turns the aggregation off, and in one process
the exchange returns at once.

The ranks train a serial learner each (replicas): a learner across ranks
meets at its collectives inside ``tree growth``, so a rank waiting for a
slow peer shows the peer's wall there too, and only the wall outside
the collectives can name the slow rank.  With two ranks the median is
the mean of the pair, so no rank can exceed 2x it, and a loaded machine
slows both ranks' own work while the injected sleep stays 0.05 s: the
factor is 1.05."""
import json
import os

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.obs import ranks
from lightgbm_tpu_torch.obs.ranks import (PHASES, RankAggregator, Reconciler,
                                          StragglerDetector)


@pytest.fixture(autouse=True)
def _one_cpu_thread():
    """One intra-op thread a test; restored after."""
    import torch
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@settings(max_examples=40, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), world=st.integers(2, 6),
       factor=st.sampled_from([1.2, 1.5, 2.0, 3.0]),
       iters=st.integers(1, 4), updates=st.integers(1, 6))
def test_detector_verdicts_equal_the_jax_detector(seed, world, factor,
                                                  iters, updates):
    pytest.importorskip("jax")
    from lightgbm_tpu.obs.ranks import StragglerDetector as JDetector
    rng = np.random.default_rng(seed)
    mine, ref = StragglerDetector(factor, iters), JDetector(factor, iters)
    for it in range(updates):
        # walls around 10 ms, one rank sometimes slowed, a phase sometimes
        # below the noise floor
        means = rng.uniform(0.005, 0.015, size=(world, len(PHASES)))
        if rng.random() < 0.6:
            means[rng.integers(world), rng.integers(len(PHASES))] *= \
                rng.uniform(1.0, 6.0)
        if rng.random() < 0.2:
            means[:, 0] = 1e-6
        win = int(rng.integers(1, 3))
        got = mine.update(means.tolist(), win, it)
        want = ref.update(means.tolist(), win, it)
        assert got == want


def test_two_ranks_name_the_slow_one(tmp_path):
    from lightgbm_tpu_torch.tools.dist_check import launch
    rng = np.random.default_rng(2)
    X = rng.normal(size=(300, 4))
    y = (X[:, 0] - X[:, 1] > 0).astype(np.float64)
    np.savez(tmp_path / "rows.npz", X=X, y=y)
    telem = tmp_path / "telem"
    spec = {"data": str(tmp_path / "rows.npz"), "device": "cpu",
            "modes": [{"name": "replicas", "rounds": 6, "params": {
                "objective": "binary", "num_leaves": 7,
                "min_data_in_leaf": 20, "max_bin": 63, "verbose": -1,
                "tpu_telemetry": str(telem), "tpu_straggler_factor": 1.05,
                "tpu_straggler_iters": 2}}]}
    (tmp_path / "spec.json").write_text(json.dumps(spec))
    res = launch(str(tmp_path / "spec.json"), 2, str(tmp_path), timeout=240,
                 env={**os.environ, "OMP_NUM_THREADS": "1"},
                 rank_env={0: {"LGBM_TPU_RANK": "0"},
                           1: {"LGBM_TPU_RANK": "1", "LGBM_TPU_FAULTS":
                               "device_execute:sleep=0.05@n=-1"}})
    # both ranks hold the same skew table (the last exchange: one
    # iteration's walls, too noisy on a loaded machine to order)
    skew = [r["modes"]["replicas"]["skew"] for r in res]
    assert skew[0]["ranks"] == skew[1]["ranks"]
    assert sorted(skew[0]["ranks"]) == ["0", "1"]
    events = {}
    for r in (0, 1):
        with open(telem / f"telemetry.{r}.jsonl") as fh:
            events[r] = [json.loads(line) for line in fh]
    found = [e for e in events[0] if e["event"] == "straggler"
             and e["phase"] == "tree growth"]
    assert found and found[0]["rank"] == 1
    assert found[0]["ratio"] > 1.05 and found[0]["consecutive"] >= 2
    assert found[0]["rank_s"] > found[0]["median_s"]
    # rank 1 detects too, but only rank 0 reports
    assert not [e for e in events[1] if e["event"] == "straggler"]
    assert [e for e in events[1] if e["event"] == "fault_injected"]


def test_exchange_in_one_process_returns_none():
    agg = RankAggregator(factor=2.0, iters=1)
    agg.accumulate({"tree growth": 0.5, "boosting (grad/hess)": 0.1})
    assert agg.exchange(0) is None
    assert agg.exchange(1) is None          # nothing accumulated since
    assert ranks.skew_table() == {}


def test_straggler_iters_zero_turns_it_off():
    rng = np.random.default_rng(5)
    X = rng.normal(size=(200, 3))
    y = (X[:, 0] > 0).astype(np.float64)
    p = {"objective": "binary", "num_leaves": 5, "verbose": -1,
         "tpu_straggler_iters": 0}
    bst = lt.train(p, lt.Dataset(X, label=y), 2, device="cpu")
    assert bst._gbdt._ranks is None
    bst = lt.train(dict(p, tpu_straggler_iters=3), lt.Dataset(X, label=y),
                   2, device="cpu")
    assert bst._gbdt._ranks.detector.iters == 3


def test_reconciler_units_on_the_ports_cost_functions():
    from lightgbm_tpu_torch.core.splitter import partition_cost
    from lightgbm_tpu_torch.obs.profile import (device_peaks,
                                                roofline_seconds)
    from lightgbm_tpu_torch.ops.hist_channels import hist_channels_cost
    from lightgbm_tpu_torch.ops.hist_wave import hist_wave_cost
    peaks = device_peaks()
    rec = Reconciler()
    N, F, B = 100_000, 28, 256
    units = rec.score(phase_s={"tree growth": 0.5}, iter_s=0.6, N=N,
                      kern_rows=3 * N, waves=6,
                      wave_cost_args=(F, B, True, True, False),
                      splits=40, part_batched=True)
    ops, nbytes = hist_wave_cost(N, F, B, N / 2, packed=True, fused=True)
    want_k1 = roofline_seconds(6 * ops, 6 * nbytes, peaks)
    assert units["hist_wave"]["modeled_s"] == pytest.approx(want_k1,
                                                             abs=1e-6)
    want_part = roofline_seconds(*partition_cost(N, 40, True, 6), peaks)
    assert units["partition"]["modeled_s"] == pytest.approx(want_part,
                                                             abs=1e-6)
    assert units["tree_growth"]["ratio"] == pytest.approx(
        0.5 / (want_k1 + want_part), rel=1e-3)
    serial = rec.score(phase_s={"tree growth": 0.2}, iter_s=0.2, N=N,
                       channels_cost_args=(F, B, 32), k2_launches=10)
    want_k2 = roofline_seconds(*(10 * x for x in hist_channels_cost(
        N, F, B, 32)), peaks)
    assert serial["hist_channels"]["modeled_s"] == pytest.approx(
        want_k2, abs=1e-6)
    assert rec.score(phase_s={}, iter_s=0.1, N=N) is None
    # partition: the u8 bin read and the int32 leaf ids read and written
    assert partition_cost(1000, splits=5, batched=False) == (10000.0, 45000.0)
    assert partition_cost(1000, splits=5, batched=True, waves=2) == \
        (4000.0, 18000.0)
    rows = [{"kernel": "lgbm/hist_wave", "measured_ms": 2.0,
             "model_ms": 0.5}, {"kernel": "unattributed",
                                "measured_ms": 1.0}]
    assert rec.score_measured(rows) == {"lgbm/hist_wave": {
        "measured_s": 0.002, "modeled_s": 0.0005, "ratio": 4.0}}
