"""The wave grower's ranges on the profiler's clock (``obs/core.py phase``,
the one range gate): under ``torch.profiler`` a training shows
``lgbm/grow.commit``, ``grow.partition``, ``grow.compact``, ``grow.hist``
and ``grow.scan`` inside ``lgbm/tree growth``, one ``grow.scan`` a wave
and ``lgbm/wait`` at every point where the host blocks on the device
(each read of a result and each host array's copy to the device: 17 a
wave + 22 a tree on the default path, PERF.md §3); with no profiler
recording a training enters no ``record_function``; the profiler
window's attribution keeps the dotted names whole."""
import importlib
import json
import re

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import obs
from lightgbm_tpu_torch.obs import xprof

GROW = ("lgbm/grow.commit", "lgbm/grow.partition", "lgbm/grow.compact",
        "lgbm/grow.hist", "lgbm/grow.scan")
# The waits, each in the innermost range that holds it.  A wave: K1's
# slot table and parents (grow.hist), then the indexes of the children's
# and siblings' stores (grow.hist_store, inside grow.hist); the
# active-row table and the count (grow.compact); the results' read
# (grow.scan: the candidates' block goes through page-locked memory
# without a wait).
WAITS_A_WAVE = {"lgbm/grow.hist": 2, "lgbm/grow.hist_store": 2,
                "lgbm/grow.compact": 2, "lgbm/grow.scan": 1}
# A partition (grow.partition): the batched apply's slot table, eight
# per-split columns and the bitset words, in every wave but the root's;
# the sequential oracle's eight columns a split.
WAITS_AN_APPLY, WAITS_A_SPLIT = 10, 8
# A tree, in ``tree growth`` outside the grower's ranges: the root sums'
# read, the tree's 14 arrays to the device and ``int(num_leaves)``;
# outside ``tree growth``: Tree.from_device's 14 reads, the feature mask
# and the iteration's end.
WAITS_TREE_GROWTH, WAITS_OUTSIDE = 16, 16


@pytest.fixture(autouse=True)
def _one_cpu_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _booster(seed=3, **extra):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(600, 5))
    y = (X[:, 0] + 0.5 * X[:, 1] * X[:, 2] > 0).astype(np.float64)
    params = {"objective": "binary", "num_leaves": 15, "verbose": -1,
              "min_data_in_leaf": 5, **extra}
    return lt.Booster(params, lt.Dataset(X, label=y), device="cpu")


def _ranges(prof):
    """(name, start_us, end_us) of every ``lgbm/*`` range."""
    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events() if e.name.startswith("lgbm/")]


def _inside(r, outer):
    return any(lo <= r[1] and r[2] <= hi for _, lo, hi in outer)


def _holder(r, rs):
    """The name of the innermost other range that holds ``r``, or None."""
    best = None
    for o in rs:
        if o != r and o[1] <= r[1] and r[2] <= o[2] and (
                best is None or o[2] - o[1] < best[2] - best[1]):
            best = o
    return None if best is None else best[0]


@pytest.mark.parametrize("extra", [
    {}, {"tpu_wave_overlap": "on"}, {"tpu_batched_split_apply": False}],
    ids=["eager", "overlap", "sequential"])
def test_grow_ranges_nest_and_count(extra):
    bst = _booster(**extra)
    bst.update()                      # the first tree outside the trace
    gb = bst._gbdt
    trees0 = len(gb.wave_stats)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            bst.update()
    trees = len(gb.wave_stats) - trees0
    waves = sum(w for w, _ in gb.wave_stats[trees0:])
    assert trees == 3 and waves > trees
    rs = _ranges(prof)
    leaves = sum(t.num_leaves for t in gb.models[-trees:])
    growth = [r for r in rs if r[0] == "lgbm/tree growth"]
    assert len(growth) == trees
    by = {n: [r for r in rs if r[0] == n] for n in GROW + ("lgbm/wait",)}
    for name in GROW:
        assert by[name], name
        assert all(_inside(r, growth) for r in by[name]), name
    assert len(by["lgbm/grow.scan"]) == waves
    # one compaction a wave; the histogram pass's slot tables go before
    # it, K1 after it
    assert len(by["lgbm/grow.compact"]) == waves
    assert len(by["lgbm/grow.hist"]) == 2 * waves
    holder = {r: _holder(r, rs) for r in by["lgbm/wait"]}
    held = {n: sum(1 for h in holder.values() if h == n)
            for n in set(holder.values())}
    for name, n in WAITS_A_WAVE.items():
        assert held[name] == n * waves, name
    partition = (WAITS_AN_APPLY * (waves - trees)
                 if extra.get("tpu_batched_split_apply", True)
                 else WAITS_A_SPLIT * (leaves - trees))
    assert held["lgbm/grow.partition"] == partition
    assert held["lgbm/tree growth"] == WAITS_TREE_GROWTH * trees
    assert held[None] == WAITS_OUTSIDE * trees
    assert len(holder) == (sum(WAITS_A_WAVE.values()) * waves + partition
                           + (WAITS_TREE_GROWTH + WAITS_OUTSIDE) * trees)


def test_no_profiler_enters_no_record_function(monkeypatch):
    """With no profiler recording a training opens no range; under one
    the same patched entry point is the one the phases use."""
    calls = []
    real = torch.profiler.record_function

    def counting(name, *a, **kw):
        calls.append(name)
        return real(name, *a, **kw)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    bst = _booster()
    for _ in range(2):
        bst.update()
    assert calls == []
    with profile(activities=[ProfilerActivity.CPU]):
        bst.update()
    assert "lgbm/grow.scan" in calls and "lgbm/wait" in calls
    assert not obs.tracing_enabled()


def test_attribute_keeps_dotted_names_whole(tmp_path):
    """A Kineto-shaped trace: device work launched inside the grower's
    ranges goes to ``lgbm/grow.partition`` and ``lgbm/grow.scan`` by
    name, whole; a host-only ``lgbm/wait`` stays a host row."""
    host, dev = 1, 0
    ev = [
        {"ph": "M", "name": "process_name", "pid": host,
         "args": {"name": "python"}},
        {"ph": "X", "cat": "user_annotation", "name": "lgbm/tree growth",
         "pid": host, "tid": 7, "ts": 100, "dur": 900},
        {"ph": "X", "cat": "user_annotation", "name": "lgbm/grow.partition",
         "pid": host, "tid": 7, "ts": 110, "dur": 100},
        {"ph": "X", "cat": "user_annotation", "name": "lgbm/grow.scan",
         "pid": host, "tid": 7, "ts": 300, "dur": 400},
        {"ph": "X", "cat": "user_annotation", "name": "lgbm/wait",
         "pid": host, "tid": 7, "ts": 500, "dur": 150},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "pid": host, "tid": 7, "ts": 150, "dur": 5,
         "args": {"correlation": 1}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "pid": host, "tid": 7, "ts": 350, "dur": 5,
         "args": {"correlation": 2}},
        {"ph": "X", "cat": "kernel", "pid": dev, "tid": 7, "ts": 220,
         "dur": 50, "name": "void at::native::index_elementwise_kernel()",
         "args": {"device": 0, "correlation": 1}},
        {"ph": "X", "cat": "kernel", "pid": dev, "tid": 7, "ts": 400,
         "dur": 30, "name": "void at::native::reduce_kernel<512, 1>()",
         "args": {"device": 0, "correlation": 2}},
    ]
    (tmp_path / "card.trace.json").write_text(json.dumps(
        {"traceEvents": ev}))
    k = xprof.attribute(xprof.parse_trace_dir(str(tmp_path)))["kernels"]
    assert k["lgbm/grow.partition"]["measured_ms"] == pytest.approx(0.05)
    assert k["lgbm/grow.scan"]["measured_ms"] == pytest.approx(0.03)
    assert k["lgbm/grow.scan"]["devices"] == ["GPU 0"]
    assert k["lgbm/wait"]["devices"] == ["host"]
    assert k["lgbm/wait"]["measured_ms"] == pytest.approx(0.15)
    assert not any(s.startswith("lgbm/grow") and s not in GROW for s in k)


def test_nested_phases_are_parts_of_their_holder(tmp_path):
    """Trace mode makes a span of a top-level phase only; the report's
    shares divide by the phases no other phase holds and mark the nested
    ones, so the grower's time is not counted twice."""
    core = importlib.import_module("lightgbm_tpu_torch.obs.core")
    report = importlib.import_module("lightgbm_tpu_torch.obs.report")
    rng = np.random.default_rng(1)
    X = rng.normal(size=(300, 4))
    y = (X[:, 0] > 0).astype(np.float64)
    params = {"objective": "binary", "num_leaves": 7, "verbose": -1,
              "tpu_telemetry": str(tmp_path / "telem"), "tpu_trace": True}
    try:
        lt.train(params, lt.Dataset(X, label=y, params=params), 3,
                 device="cpu")
        core.event("summary", **core.digest())
    finally:
        obs.disable()
        obs.enable_trace(False)
        obs.reset()
    events = report.load_events(str(tmp_path / "telem"))
    spans = [e["name"] for e in events if e.get("event") == "span"]
    assert spans.count("phase/tree growth") == 3
    assert not any(n.startswith("phase/grow.") for n in spans)
    # the waits outside every other phase: the tree's 14 reads to the
    # host, the feature mask and the iteration's end
    assert spans.count("phase/wait") == WAITS_OUTSIDE * 3
    d = report.summarize(events)
    assert {"grow.scan", "grow.hist", "wait"} <= set(d["phase_nested"])
    assert "tree growth" not in d["phase_nested"]
    rows = [re.match(r"(.+?)( \*)? +[0-9.]+ +([0-9.]+)% +\S+$", line)
            for line in report.render(d).splitlines()]
    shares = {m[1]: (m[2] is not None, float(m[3])) for m in rows if m}
    assert shares["grow.scan"][0] and not shares["tree growth"][0]
    top = sum(s for nested, s in shares.values() if not nested)
    assert top == pytest.approx(100.0, abs=0.5)
