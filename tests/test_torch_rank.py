"""The port's ranking plane against the JAX package on the CPU: the padded
query blocks, the lambdarank pair pass and the NDCG@k / MAP@k metrics, on
ragged seeded query sizes (one-document queries, queries whose labels are
all equal, queries without relevance, tied scores).  Tolerance: 1e-6
absolute on the pair pass's g and h (values of order 1; the two packages'
reductions and transcendentals differ in the last bits) and on the
metrics.  On a card, the pair pass and the device NDCG are held against
the CPU."""
import numpy as np
import pytest
import torch

from lightgbm_tpu_torch.core.query import (CHUNK_ELEMS, build_query_blocks,
                                           default_label_gain)
from lightgbm_tpu_torch.objective.rank import pair_lambdas

EVAL_AT = [1, 3, 5, 10]


def _queries(seed=0):
    """Ragged sizes (1 to 150 documents, pads 8 to 256) and grades 0-4;
    query 0 holds one document, query 1 three equal labels, query 2 no
    relevance."""
    rng = np.random.default_rng(seed)
    sizes = np.concatenate([[1, 3, 6, 9, 40, 150],
                            rng.integers(1, 70, size=40)])
    n = int(sizes.sum())
    label = rng.integers(0, 5, size=n).astype(np.float64)
    label[1:4] = 2.0
    label[4:10] = 0.0
    bounds = np.concatenate([[0], np.cumsum(sizes)])
    weights = rng.uniform(0.5, 2.0, size=n).astype(np.float32)
    return bounds, label, weights


def _scores(kind, n, seed=1):
    rng = np.random.default_rng(seed)
    if kind == "zero":
        return np.zeros(n, np.float32)
    if kind == "ties":               # many equal scores, and -0.0 beside 0.0
        return np.round(rng.normal(size=n), 1).astype(np.float32)
    return rng.normal(size=n).astype(np.float32)


def _query_weights(bounds, weights):
    from lightgbm_tpu_torch.io.dataset import Metadata
    md = Metadata(int(bounds[-1]))
    md.set_weights(weights)
    md.set_query(bounds)
    return md.query_weights


def test_query_blocks_equal_reference():
    """The port's blocks are the JAX package's rows without its padding
    queries (which are pure padding: sentinel indices, zeros)."""
    pytest.importorskip("jax")
    from lightgbm_tpu.core.query import build_query_blocks as ref_build
    bounds, label, weights = _queries()
    n = int(bounds[-1])
    qw = _query_weights(bounds, weights)
    kw = dict(optimize_pos_at=7, eval_at=EVAL_AT, query_weights=qw,
              sentinel=n)
    ref = ref_build(bounds, label, default_label_gain(), **kw)
    port = build_query_blocks(bounds, label, default_label_gain(), **kw)
    assert [b.P for b in ref.buckets] == [b.P for b in port.buckets]
    assert port.sentinel == ref.sentinel and port.eval_at == ref.eval_at
    assert port.wsum == pytest.approx(ref.wsum, rel=1e-12)
    assert port.num_queries == ref.num_queries
    for rb, pb in zip(ref.buckets, port.buckets):
        Q = pb.idx.shape[0]
        for name in ("idx", "labs", "gains", "inv", "k_idx", "inv_k",
                     "one_k", "qw"):
            r = np.asarray(getattr(rb, name))
            r = r.reshape((rb.nc * rb.qc,) + r.shape[2:])
            np.testing.assert_array_equal(getattr(pb, name).numpy(), r[:Q],
                                          err_msg=name)
            pad = r[Q:]
            assert (pad == n).all() if name == "idx" else not pad.any()


@pytest.mark.parametrize("norm", [True, False], ids=["norm", "no_norm"])
@pytest.mark.parametrize("kind", ["zero", "normal", "ties"])
def test_pair_lambdas_match_reference(kind, norm):
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from lightgbm_tpu.core.query import build_query_blocks as ref_build
    from lightgbm_tpu.objective.rank import pair_lambdas as ref_pairs
    bounds, label, _ = _queries()
    n = int(bounds[-1])
    score = _scores(kind, n)
    gains = default_label_gain()
    g_r, h_r = ref_pairs(jnp.asarray(score),
                         ref_build(bounds, label, gains, sentinel=n).buckets,
                         1.3, norm)
    blocks = build_query_blocks(bounds, label, gains, sentinel=n)
    g_p, h_p = pair_lambdas(torch.as_tensor(score), blocks, 1.3, norm,
                            chunk_elems=CHUNK_ELEMS)
    np.testing.assert_allclose(g_p.numpy(), np.asarray(g_r), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(h_p.numpy(), np.asarray(h_r), rtol=0,
                               atol=1e-6)
    # a one-document query and an all-equal-label query get no lambdas
    assert g_p[0] == 0 and not g_p[1:4].any() and not h_p[1:4].any()
    # the chunk does not move a value: one query a chunk, bit for bit
    g_1, h_1 = pair_lambdas(torch.as_tensor(score), blocks, 1.3, norm,
                            chunk_elems=1)
    assert torch.equal(g_1, g_p) and torch.equal(h_1, h_p)


def _ndcg_pair(weighted):
    """The JAX package's NDCG metric and the port's on the same rows."""
    pytest.importorskip("jax")
    from lightgbm_tpu.config import Config as RefConfig
    from lightgbm_tpu.io.dataset import Metadata as RefMetadata
    from lightgbm_tpu.metric.rank import MapMetric as RefMap
    from lightgbm_tpu.metric.rank import NDCGMetric as RefNDCG
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.io.dataset import Metadata
    from lightgbm_tpu_torch.metric.rank import MapMetric, NDCGMetric
    bounds, label, weights = _queries()
    n = int(bounds[-1])
    params = {"objective": "lambdarank", "eval_at": EVAL_AT, "verbose": -1}
    out = []
    for cfg, md, classes in (
            (RefConfig.from_params(params), RefMetadata(n), (RefNDCG, RefMap)),
            (Config.from_params(params), Metadata(n), (NDCGMetric,
                                                        MapMetric))):
        md.set_label(label)
        md.set_weights(weights if weighted else None)
        md.set_query(bounds)
        ms = [c(cfg) for c in classes]
        for m in ms:
            m.init(md, n)
        out.append(ms)
    return out, n


@pytest.mark.parametrize("weighted", [False, True],
                         ids=["unweighted", "weighted"])
@pytest.mark.parametrize("kind", ["normal", "ties"])
def test_ndcg_and_map_match_reference(kind, weighted):
    import jax.numpy as jnp
    ((r_ndcg, r_map), (p_ndcg, p_map)), n = _ndcg_pair(weighted)
    score = _scores(kind, n)
    host = p_ndcg.eval_host(score.astype(np.float64))
    dev = p_ndcg.eval(torch.as_tensor(score), None)
    ref_dev = r_ndcg.eval(jnp.asarray(score), None)
    ref_host = r_ndcg.eval_host(score.astype(np.float64))
    for got, want in ((host, ref_host), (dev, ref_dev), (dev, ref_host)):
        assert [g[0] for g in got] == [w[0] for w in want]
        np.testing.assert_allclose([g[1] for g in got], [w[1] for w in want],
                                   rtol=0, atol=1e-6)
    got = p_map.eval(score.astype(np.float64), None)
    want = r_map.eval(score.astype(np.float64), None)
    np.testing.assert_allclose([g[1] for g in got], [w[1] for w in want],
                               rtol=0, atol=1e-6)


def test_mslr_like_sizes_equal_reference():
    pytest.importorskip("jax")
    from lightgbm_tpu.ops.rank import mslr_like_sizes as ref_sizes
    from lightgbm_tpu.ops.rank import rank_pair_cost as ref_cost
    from lightgbm_tpu_torch.ops.rank import mslr_like_sizes, rank_pair_cost
    for rows, seed in ((50_000, 0), (12_345, 7)):
        got = mslr_like_sizes(rows, np.random.default_rng(seed))
        want = ref_sizes(rows, np.random.default_rng(seed))
        np.testing.assert_array_equal(got, want)
        assert got.sum() == rows
        assert rank_pair_cost(got) == ref_cost(want)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the device path is only run there")


@pytest.mark.cuda
def test_pair_pass_on_card_matches_cpu():
    """The pair pass on the card (chunk sized from its memory) against the
    CPU's (the JAX package's chunk), at 1e-6."""
    _card()
    bounds, label, weights = _queries()
    n = int(bounds[-1])
    score = _scores("ties", n)
    for norm in (True, False):
        cpu = pair_lambdas(torch.as_tensor(score), build_query_blocks(
            bounds, label, default_label_gain(), sentinel=n), 1.0, norm)
        card = pair_lambdas(torch.as_tensor(score).cuda(), build_query_blocks(
            bounds, label, default_label_gain(), sentinel=n, device="cuda"),
            1.0, norm)
        for a, b in zip(cpu, card):
            np.testing.assert_allclose(b.cpu().numpy(), a.numpy(), rtol=0,
                                       atol=1e-6)


@pytest.mark.cuda
def test_ndcg_on_card_matches_host_loop():
    """The device NDCG on the card against the host loop, at 1e-6."""
    _card()
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.io.dataset import Metadata
    from lightgbm_tpu_torch.metric.rank import NDCGMetric
    bounds, label, weights = _queries()
    n = int(bounds[-1])
    md = Metadata(n)
    md.set_label(label)
    md.set_weights(weights)
    md.set_query(bounds)
    m = NDCGMetric(Config.from_params({"objective": "lambdarank",
                                       "eval_at": EVAL_AT}))
    m.init(md, n, "cuda")
    score = _scores("ties", n)
    dev = m.eval(torch.as_tensor(score).cuda(), None)
    host = m.eval_host(score.astype(np.float64))
    np.testing.assert_allclose([d[1] for d in dev], [h[1] for h in host],
                               rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# query-aligned shards of the data-parallel learner (parallel/rank_shard.py)
# ---------------------------------------------------------------------------

def test_query_shard_plan_equals_reference():
    """``plan_query_shards`` against the JAX package's at D = 2, 3, 4, 8:
    the same cuts on query boundaries, shard rows and gather map."""
    pytest.importorskip("jax")
    from lightgbm_tpu.parallel.rank_shard import plan_query_shards as jplan

    from lightgbm_tpu_torch.parallel.rank_shard import plan_query_shards
    bounds, _, _ = _queries()
    N = int(bounds[-1])
    for D in (2, 3, 4, 8):
        got, want = plan_query_shards(bounds, D), jplan(bounds, D)
        np.testing.assert_array_equal(got.query_cuts, want.query_cuts)
        np.testing.assert_array_equal(got.row_cuts, want.row_cuts)
        assert got.S == want.S
        np.testing.assert_array_equal(got.gather, want.gather)
        assert set(got.row_cuts.tolist()) <= set(bounds.tolist())
        assert (got.gather < N).sum() == N


def test_query_sharded_grads_at_two_ranks(tmp_path):
    """The twin of tests/test_rank_device.py's 2-device differential: two
    gloo ranks each run the pair pass on their whole queries, and the
    gathered g/h equal the single pass's bit for bit on both ranks; the
    plan is the JAX package's."""
    import json

    from lightgbm_tpu_torch.tools.dist_check import launch
    bounds, label, _ = _queries()
    n = int(bounds[-1])
    X = np.random.default_rng(2).normal(size=(n, 3))
    np.savez(tmp_path / "rank.npz", X=X, y=label,
             group=np.diff(bounds).astype(np.int64))
    spec = {"device": "cpu", "rank_grads": {
        "data": str(tmp_path / "rank.npz"),
        "params": {"objective": "lambdarank", "verbose": -1,
                   "min_data_in_leaf": 1}}}
    with open(tmp_path / "spec.json", "w") as fh:
        json.dump(spec, fh)
    res = launch(str(tmp_path / "spec.json"), 2, str(tmp_path), timeout=300)
    for r in res:
        assert r["rank_grads"]["equal"], r["rank_grads"]
    assert res[0]["rank_grads"] == res[1]["rank_grads"]
    pytest.importorskip("jax")
    from lightgbm_tpu.parallel.rank_shard import plan_query_shards as jplan
    want = jplan(bounds, 2)
    assert res[0]["rank_grads"]["row_cuts"] == want.row_cuts.tolist()
    assert res[0]["rank_grads"]["S"] == want.S
