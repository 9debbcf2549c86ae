"""Merge telemetry JSONL files into per-phase and per-iteration
summaries (counterpart of lightgbm_tpu/obs/report.py, the port's own
copy: it imports nothing of the JAX package).

Pure stdlib, so the report starts at once on a machine without torch or
a card.  Also the CLI::

    python -m lightgbm_tpu_torch.obs.report <path> [--json]

``<path>`` is a telemetry directory (every ``telemetry.{rank}.jsonl`` in
it merged), one ``.jsonl`` file, or a glob.  The default output is a
table; ``--json`` prints the digest.

The port writes the JAX package's event schema; where its events differ
this reader takes the port's kinds too: ``kernel_profile`` events of the
hand kernels (``hist_wave``, ``hist_channels``), ``compile`` events of
kind ``kernel_build`` (an ``nvcc`` build of the CUDA kernels,
``ops/build.py``) and ``graph_capture`` (a serving bucket's CUDA graph,
``serve/aot.py``) in place of XLA compiles, and ``kernel_measured`` rows
from the torch-profiler window (``obs/xprof.py``).
"""
from __future__ import annotations

import glob
import json
import math
import os
import re
from collections import defaultdict
from typing import List


def telemetry_files(path: str) -> List[str]:
    """Resolve ``path`` (a telemetry dir, a ``.jsonl`` file, or a glob)
    to the sorted list of per-process JSONL files.  A ``base.jsonl``
    argument also picks up the ``base.{i}.jsonl`` siblings non-zero
    ranks write in file-sink mode (obs/core.py sink_path)."""
    if os.path.isdir(path):
        return sorted(glob.glob(os.path.join(path, "telemetry.*.jsonl")))
    if path.endswith(".jsonl"):
        sibs = glob.glob(path[:-len(".jsonl")] + ".*.jsonl")
        out = {f for f in sibs + [path] if os.path.isfile(f)}
        return sorted(out)
    return sorted(glob.glob(path))


def load_events(path: str) -> List[dict]:
    """Parse every record from the file set; corrupt lines are counted,
    not fatal (a crashed run may truncate its last record).  Each event
    gains ``_proc`` (from the ``telemetry.{i}.jsonl`` name, else 0)."""
    events = []
    bad = 0
    for fname in telemetry_files(path):
        m = re.search(r"\.(\d+)\.jsonl$", os.path.basename(fname))
        proc = int(m.group(1)) if m else 0
        with open(fname) as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    bad += 1
                    continue
                rec["_proc"] = proc
                events.append(rec)
    if bad:
        events.append({"event": "_parse_errors", "count": bad, "_proc": -1})
    return events


def summarize(events: List[dict]) -> dict:
    """Machine-readable digest of a merged event stream.

    Per-iteration rows come from process 0 (iteration records are
    emitted by every process and are near-identical — metrics/timings of
    replicated training); counters are summed across processes' final
    ``summary`` events (collective bytes et al. are per-process).
    Multi-process runs additionally get a cross-host phase-skew table
    (the straggler report: a phase whose wall time diverges across
    processes is where the collective waits pile up), and profile-mode
    runs get per-kernel roofline aggregates + the memory-census peak.
    """
    procs = sorted({e["_proc"] for e in events if e["_proc"] >= 0})
    iters0 = [e for e in events if e.get("event") == "iteration"
              and e["_proc"] == (procs[0] if procs else 0)]
    iters0.sort(key=lambda e: e.get("iteration", 0))

    phase_s = defaultdict(float)
    phase_calls = defaultdict(int)
    per_iteration = []
    for e in iters0:
        for k, v in (e.get("phase_s") or {}).items():
            phase_s[k] += float(v)
        row = {
            "iteration": e.get("iteration"),
            "iter_s": e.get("iter_s"),
            "leaves": e.get("leaves"),
            "waves": e.get("waves"),
            "recompiles": e.get("recompiles"),
            "phase_s": e.get("phase_s") or {},
            "metrics": e.get("metrics") or {},
            "cum_row_iters_per_s": e.get("cum_row_iters_per_s"),
        }
        for k in ("hist_mode", "wave_capacity", "fused_sibling",
                  "fused_grad", "overlap", "overlap_frac",
                  "grad_hbm_bytes_saved"):
            if e.get(k) is not None:
                row[k] = e[k]
        per_iteration.append(row)

    counters = defaultdict(float)
    summaries = [e for e in events if e.get("event") == "summary"]
    sum_phase = defaultdict(float)
    proc_phase = defaultdict(dict)   # proc -> {phase: seconds}
    for e in summaries:
        for k, v in (e.get("counters") or {}).items():
            if isinstance(v, (int, float)):
                counters[k] += v
        for k, v in (e.get("phase_s") or {}).items():
            sum_phase[k] += float(v)
            proc_phase[e["_proc"]][k] = float(v)
        for k, v in (e.get("phase_calls") or {}).items():
            phase_calls[k] += int(v)
    # the atexit summaries carry authoritative totals including phases
    # outside the iteration loop (binning, predict); per-iteration deltas
    # are the fallback for live/crashed runs with no summary yet
    if sum_phase:
        phase_s = sum_phase
    # live runs (no atexit summary yet): fall back to per-event counters
    if not summaries:
        for e in events:
            if e.get("event") == "collective":
                kind = e.get("kind", "?")
                tag = "traced_" if e.get("traced") else ""
                counters[f"collective/{kind}/{tag}calls"] += 1
                counters[f"collective/{kind}/{tag}bytes"] += e.get("bytes", 0)

    # waves-per-tree: kernel launches per grown tree, the CPU-measurable
    # wave-scheduling efficiency figure (packed lane pairs cut
    # it ~1.5x on deep trees); trees that failed to grow don't count
    waves_sum = trees_sum = 0
    for e in iters0:
        w = e.get("waves")
        if isinstance(w, (int, float)) and w >= 0:
            grown = sum(1 for x in (e.get("leaves") or [])
                        if isinstance(x, (int, float)) and x > 1)
            if grown:
                waves_sum += w
                trees_sum += grown

    last = per_iteration[-1] if per_iteration else {}
    wave_pipeline = {}
    if trees_sum:
        wave_pipeline["waves_per_tree"] = round(waves_sum / trees_sum, 3)
        wave_pipeline["waves_total"] = int(waves_sum)
        wave_pipeline["trees_grown"] = int(trees_sum)
    for k in ("hist_mode", "wave_capacity", "fused_sibling",
              "fused_grad", "overlap", "overlap_frac",
              "grad_hbm_bytes_saved"):
        if last.get(k) is not None:
            wave_pipeline[k] = last[k]
    out = {
        "processes": procs,
        "iterations": len(per_iteration),
        "per_iteration": per_iteration,
        "phase_s": {k: round(v, 4) for k, v in sorted(phase_s.items())},
        "phase_calls": dict(sorted(phase_calls.items())),
        "counters": {k: (int(v) if float(v).is_integer() else round(v, 4))
                     for k, v in sorted(counters.items())},
        "metrics_last": last.get("metrics", {}),
        "cum_row_iters_per_s": last.get("cum_row_iters_per_s"),
        "parse_errors": sum(e.get("count", 0) for e in events
                            if e.get("event") == "_parse_errors"),
    }
    if wave_pipeline:
        out["wave_pipeline"] = wave_pipeline
    skew = phase_skew(proc_phase)
    if skew:
        out["phase_skew"] = skew
    kernels = kernel_summary(events)
    if kernels:
        out["kernels"] = kernels
    xp = xprof_summary(events)
    if xp:
        out["xprof"] = xp
    comp = compile_summary(events)
    if comp:
        out["compile"] = comp
    mem = memory_summary(events)
    if mem:
        out["memory"] = mem
    health = health_summary(events)
    if health:
        out["health"] = health
    serve = serve_summary(events)
    if serve:
        out["serve"] = serve
    trace = trace_summary(events)
    if trace:
        out["trace"] = trace
    robust = robust_summary(events)
    if robust:
        out["robust"] = robust
    online = online_summary(events)
    if online:
        out["online"] = online
    ing = ingest_summary(events)
    if ing:
        out["ingest"] = ing
    drift = drift_summary(events)
    if drift:
        out["drift"] = drift
    recon = reconciliation_summary(events)
    if recon:
        out["reconciliation"] = recon
    stragglers = [{k: e.get(k) for k in ("rank", "phase", "iteration",
                                         "ratio", "median_s", "rank_s",
                                         "consecutive")}
                  for e in events if e.get("event") == "straggler"]
    if stragglers:
        out["stragglers"] = stragglers
    return out


def reconciliation_summary(events: List[dict]) -> dict:
    """Aggregate ``reconciliation`` events per cost-model unit: scored
    iterations, mean/last measured-over-modeled ratio, and the worst
    ratio with its iteration — the post-hoc companion of the live
    board's reconciliation row (a unit whose mean ratio drifts far
    above 1 is where the cost function is optimistic on this
    backend)."""
    per_unit: dict = {}
    for e in events:
        if e.get("event") != "reconciliation":
            continue
        for unit, u in (e.get("units") or {}).items():
            ratio = u.get("ratio")
            if ratio is None:
                continue
            agg = per_unit.setdefault(unit, {
                "iterations": 0, "ratio_sum": 0.0, "last_ratio": None,
                "worst_ratio": None, "worst_iteration": None})
            agg["iterations"] += 1
            agg["ratio_sum"] += float(ratio)
            agg["last_ratio"] = float(ratio)
            agg["last_measured_s"] = u.get("measured_s")
            agg["last_modeled_s"] = u.get("modeled_s")
            if (agg["worst_ratio"] is None
                    or float(ratio) > agg["worst_ratio"]):
                agg["worst_ratio"] = float(ratio)
                agg["worst_iteration"] = e.get("iteration")
    out = {}
    for unit, agg in per_unit.items():
        n = agg.pop("iterations")
        s = agg.pop("ratio_sum")
        out[unit] = dict(iterations=n, mean_ratio=round(s / n, 4),
                         **{k: (round(v, 4)
                                if isinstance(v, float) else v)
                            for k, v in agg.items()})
    return out


def phase_skew(proc_phase: dict) -> dict:
    """Cross-host straggler table from per-process phase totals: for each
    phase seen by >1 process, the min/max seconds and the spread as a
    fraction of the mean.  A phase with high spread_frac is where the
    slow host makes everyone else wait at the next collective
    (reference: the Network::Allreduce barrier in
    data_parallel_tree_learner.cpp)."""
    if len(proc_phase) < 2:
        return {}
    names = set()
    for d in proc_phase.values():
        names.update(d)
    out = {}
    for name in sorted(names):
        vals = [d[name] for d in proc_phase.values() if name in d]
        if len(vals) < 2:
            continue
        mean = sum(vals) / len(vals)
        out[name] = {
            "min_s": round(min(vals), 4),
            "max_s": round(max(vals), 4),
            "spread_s": round(max(vals) - min(vals), 4),
            "spread_frac": round((max(vals) - min(vals)) / mean, 4)
            if mean else 0.0,
        }
    return out


def kernel_summary(events: List[dict]) -> dict:
    """Aggregate ``kernel_profile`` events per kernel: call count, total
    achieved seconds, summed analytical roofline seconds, and the
    roofline fraction (roofline/achieved — 1.0 means running AT the
    analytical floor)."""
    agg = {}
    for e in events:
        if e.get("event") != "kernel_profile":
            continue
        k = e.get("kernel", "?")
        a = agg.setdefault(k, {"calls": 0, "achieved_s": 0.0,
                               "roofline_s": 0.0, "flops": 0.0,
                               "bytes": 0.0})
        a["calls"] += 1
        a["achieved_s"] += float(e.get("achieved_s", 0.0) or 0.0)
        a["roofline_s"] += float(e.get("roofline_s", 0.0) or 0.0)
        a["flops"] += float(e.get("flops", 0.0) or 0.0)
        a["bytes"] += float(e.get("bytes", 0.0) or 0.0)
    for a in agg.values():
        ach = a["achieved_s"]
        a["achieved_s"] = round(ach, 6)
        a["roofline_s"] = round(a["roofline_s"], 9)
        a["roofline_frac"] = round(a["roofline_s"] / ach, 6) if ach else 0.0
    return dict(sorted(agg.items()))


def xprof_summary(events: List[dict]) -> dict:
    """Aggregate ``kernel_measured`` events (obs/xprof.py) per kernel:
    attributed op count, trace-measured ms, and — for scopes with an
    cost function — the bound's ms, the fraction of it reached and
    whether bytes or operations bound it.  Unattributed residual rows
    keep their device label so multi-device windows stay
    distinguishable.  These are times the profiler measured on the
    device; ``kernel_summary`` above holds profile mode's CUDA-event
    times of each launch."""
    agg: dict = {}
    window = 0.0
    for e in events:
        if e.get("event") != "kernel_measured":
            continue
        key = e.get("kernel", "?")
        if key == "unattributed" and e.get("device"):
            key = "unattributed(%s)" % e["device"]
        a = agg.setdefault(key, {"ops": 0, "measured_ms": 0.0})
        a["ops"] += int(e.get("ops", 0) or 0)
        a["measured_ms"] += float(e.get("measured_ms", 0.0) or 0.0)
        for f in ("model_ms", "roofline_frac", "bound",
                  "occupancy", "model"):
            if e.get(f) is not None:
                a[f] = e[f]
        window = max(window, float(e.get("window_ms", 0.0) or 0.0))
    if not agg:
        return {}
    for a in agg.values():
        a["measured_ms"] = round(a["measured_ms"], 4)
    return {"window_ms": round(window, 3),
            "kernels": dict(sorted(agg.items()))}


def compile_summary(events: List[dict]) -> dict:
    """Fold ``compile`` events (obs/xprof.py) into the compile-plane
    digest.  The JAX package's keys stay (XLA backend compiles by jit,
    cache traffic, retraces: zero in a port run but for ``retraces``,
    which ``watch_jit`` stamps); the port's builds add
    ``kernel_builds``/``kernel_build_s`` (``nvcc`` builds of the CUDA
    kernels) and ``graph_captures`` by kind (one CUDA graph per serving
    bucket)."""
    out = {"compiles": 0, "wall_s": 0.0, "by_jit": {},
           "cache_hits": 0, "cache_misses": 0, "retraces": 0,
           "kernel_builds": 0, "kernel_build_s": 0.0,
           "graph_captures": {}}
    retrace_jits: dict = {}
    seen = False
    for e in events:
        if e.get("event") != "compile":
            continue
        seen = True
        kind = e.get("kind")
        if kind == "backend_compile":
            out["compiles"] += 1
            w = float(e.get("wall_s", 0.0) or 0.0)
            out["wall_s"] += w
            ent = out["by_jit"].setdefault(
                e.get("jit") or "<top>", {"count": 0, "wall_s": 0.0})
            ent["count"] += 1
            ent["wall_s"] += w
        elif kind == "kernel_build":
            out["kernel_builds"] += 1
            out["kernel_build_s"] += float(e.get("wall_s", 0.0) or 0.0)
        elif kind == "graph_capture":
            g = e.get("jit") or "?"
            out["graph_captures"][g] = out["graph_captures"].get(g, 0) + 1
        elif kind == "cache_hit":
            out["cache_hits"] += 1
        elif kind == "cache_miss":
            out["cache_misses"] += 1
        elif kind == "retrace":
            out["retraces"] += 1
            jit = e.get("jit") or "?"
            lst = retrace_jits.setdefault(jit, [])
            for c in (e.get("changed") or [])[:4]:
                if c not in lst:
                    lst.append(c)
    if not seen:
        return {}
    out["wall_s"] = round(out["wall_s"], 4)
    out["kernel_build_s"] = round(out["kernel_build_s"], 4)
    for ent in out["by_jit"].values():
        ent["wall_s"] = round(ent["wall_s"], 4)
    out["by_jit"] = dict(sorted(out["by_jit"].items()))
    out["graph_captures"] = dict(sorted(out["graph_captures"].items()))
    if retrace_jits:
        out["retrace_jits"] = dict(sorted(retrace_jits.items()))
    return out


def memory_summary(events: List[dict]) -> dict:
    """Fold ``memory_census`` + ``donation_audit`` events into the census
    digest: run peak, last per-buffer attribution, audit survivors."""
    peak = 0
    peak_phase = ""
    last_buffers = {}
    survivors = []
    n = 0
    for e in events:
        if e.get("event") == "memory_census":
            n += 1
            basis = max(int(e.get("peak_bytes", 0) or 0),
                        int(e.get("device_peak_bytes", 0) or 0),
                        int(e.get("live_bytes", 0) or 0))
            if basis > peak:
                peak = basis
                peak_phase = e.get("phase", "")
            if e.get("buffers"):
                last_buffers = e["buffers"]
        elif e.get("event") == "donation_audit":
            survivors.extend(e.get("survivors") or [])
    if not n:
        return {}
    out = {"peak_bytes": peak, "peak_phase": peak_phase, "snapshots": n,
           "buffers_last": last_buffers}
    if survivors:
        out["audit_survivors"] = sorted(set(survivors))
    return out


def health_summary(events: List[dict]) -> dict:
    """Fold ``health``/``fingerprint``/``divergence`` events (obs/health)
    into one digest section: failure count + first failure's attribution,
    fingerprint coverage, and the divergence audit's verdict.  Empty when
    the run had no health instrumentation."""
    fails = [e for e in events
             if e.get("event") == "health" and not e.get("ok", True)]
    fps = [e for e in events if e.get("event") == "fingerprint"]
    div = [e for e in events if e.get("event") == "divergence"]
    if not (fails or fps or div):
        return {}
    out = {
        "failures": len(fails),
        "fingerprints": len(fps),
        "divergence_checks": len(div),
        "divergence_failures": sum(1 for e in div
                                   if not e.get("ok", True)),
    }
    if fails:
        f = fails[0]
        out["first_failure"] = {k: f.get(k) for k in
                                ("check", "phase", "iteration", "detail")}
    if fps:
        out["last_fingerprint"] = {"iteration": fps[-1].get("iteration"),
                                   "digest": fps[-1].get("digest")}
    return out


def percentile(sorted_vals: List[float], p: float):
    """Nearest-rank percentile (rank ceil(p*n), 1-indexed) over a
    pre-sorted list (stdlib only).  THE latency-percentile definition
    for the serving stack: the digest here, the session's ``stats()``
    /health endpoint, and the serve bench all share it so p50/p99 can
    never silently diverge."""
    if not sorted_vals:
        return None
    n = len(sorted_vals)
    i = min(max(math.ceil(p * n) - 1, 0), n - 1)
    return round(sorted_vals[i], 3)


def serve_summary(events: List[dict]) -> dict:
    """Fold ``serve_*`` events (serve/session.py) into the serving
    digest: request latency percentiles, batch occupancy / pad waste,
    overloads, deadline misses, and whether the session degraded to the
    host predictor.  Empty when the run served nothing."""
    reqs = [e for e in events if e.get("event") == "serve_request"]
    batches = [e for e in events if e.get("event") == "serve_batch"]
    overloads = sum(1 for e in events if e.get("event") == "serve_overload")
    degraded = [e for e in events if e.get("event") == "serve_degraded"]
    if not (reqs or batches):
        return {}
    lat = sorted(float(e.get("total_ms", 0.0) or 0.0)
                 for e in reqs if e.get("ok", True))
    rows = sum(int(e.get("rows", 0) or 0) for e in batches)
    padded = sum(int(e.get("padded", 0) or 0) for e in batches)
    out = {
        "requests": len(reqs),
        "ok": sum(1 for e in reqs if e.get("ok", True)),
        "deadline_missed": sum(1 for e in reqs
                               if e.get("reason") == "deadline"),
        "overloads": overloads,
        "batches": len(batches),
        "rows": rows,
        "padded_rows": padded,
        "occupancy": round(rows / padded, 4) if padded else None,
        "pad_waste_rows": max(padded - rows, 0),
        "p50_ms": percentile(lat, 0.50),
        "p99_ms": percentile(lat, 0.99),
        "max_queue_rows": max((int(e.get("queue_rows", 0) or 0)
                               for e in batches), default=0),
        "degraded": bool(degraded),
    }
    if degraded:
        out["degraded_error"] = degraded[0].get("error")
    # fleet lifecycle (serve/registry.py): swaps / canary verdicts /
    # rollbacks / failovers beside the request numbers they governed
    swaps = [e for e in events if e.get("event") == "serve_swap"]
    rollbacks = [e for e in events if e.get("event") == "serve_rollback"]
    failovers = [e for e in events if e.get("event") == "serve_failover"]
    if swaps or rollbacks or failovers:
        out["fleet"] = {
            # initial deploys (add_model stamps initial=True) are not
            # hot-swaps — the registry's swaps counter and
            # tpu_serve_swaps_total exclude them, so the digest must too
            "swaps": sum(1 for e in swaps
                         if e.get("ok") and not e.get("initial")),
            "deploys": sum(1 for e in swaps
                           if e.get("ok") and e.get("initial")),
            "swaps_rejected": sum(1 for e in swaps if not e.get("ok")),
            "rollbacks": len(rollbacks),
            "failovers": len(failovers),
        }
        if rollbacks:
            out["fleet"]["last_rollback"] = {
                "model": rollbacks[-1].get("model"),
                "reason": rollbacks[-1].get("reason")}
    shed = [e for e in events if e.get("event") == "serve_overload"
            and e.get("priority")]
    if shed:
        by_class = defaultdict(int)
        for e in shed:
            by_class[e.get("priority", "?")] += 1
        out["shed_by_priority"] = dict(sorted(by_class.items()))
    xreqs = [e for e in events if e.get("event") == "explain_request"]
    xbatches = [e for e in events if e.get("event") == "explain_batch"]
    if xreqs or xbatches:
        xlat = sorted(float(e.get("total_ms", 0.0) or 0.0)
                      for e in xreqs if e.get("ok", True))
        xrows = sum(int(e.get("rows", 0) or 0) for e in xbatches)
        xpad = sum(int(e.get("padded", 0) or 0) for e in xbatches)
        out["explain"] = {
            "requests": len(xreqs),
            "ok": sum(1 for e in xreqs if e.get("ok", True)),
            "deadline_missed": sum(1 for e in xreqs
                                   if e.get("reason") == "deadline"),
            "batches": len(xbatches),
            "rows": xrows,
            "padded_rows": xpad,
            "occupancy": round(xrows / xpad, 4) if xpad else None,
            "p50_ms": percentile(xlat, 0.50),
            "p99_ms": percentile(xlat, 0.99),
        }
    return out


def robust_summary(events: List[dict]) -> dict:
    """Fold the fault-tolerance events (robust/: ``checkpoint`` /
    ``restore`` / ``retry`` / ``fault_injected`` / ``device_stall`` /
    ``serve_recovered``) into one recovery digest: how often the run
    checkpointed, what it recovered from, and what was injected.  Empty
    when the run saw no recovery activity."""
    cps = [e for e in events if e.get("event") == "checkpoint"]
    rst = [e for e in events if e.get("event") == "restore"]
    rets = [e for e in events if e.get("event") == "retry"]
    inj = [e for e in events if e.get("event") == "fault_injected"]
    stalls = [e for e in events if e.get("event") == "device_stall"]
    recov = [e for e in events if e.get("event") == "serve_recovered"]
    if not (cps or rst or rets or inj or stalls or recov):
        return {}
    by_point = defaultdict(lambda: {"retries": 0, "transient": 0,
                                    "fatal": 0})
    for e in rets:
        p = by_point[e.get("point", "?")]
        p["retries"] += 1
        p[e.get("classify", "fatal")] = p.get(e.get("classify", "fatal"),
                                              0) + 1
    out = {
        "checkpoints": len(cps),
        "restores": len(rst),
        "retries": len(rets),
        "faults_injected": len(inj),
        "stalls": len(stalls),
        "serve_recoveries": len(recov),
    }
    if by_point:
        out["retries_by_point"] = {k: dict(v)
                                   for k, v in sorted(by_point.items())}
    if inj:
        pts = defaultdict(int)
        for e in inj:
            pts[e.get("point", "?")] += 1
        out["faults_by_point"] = dict(sorted(pts.items()))
    if cps:
        last = cps[-1]
        out["last_checkpoint"] = {"iteration": last.get("iteration"),
                                  "reason": last.get("reason"),
                                  "path": last.get("path")}
    if rst:
        out["resumed_from_iteration"] = rst[-1].get("iteration")
    return out


def online_summary(events: List[dict]) -> dict:
    """Fold the online-learning events (``refit`` from
    boosting/gbdt.py's leaf re-estimation, ``online_refresh`` from
    online/loop.py's cadence firings) into one closed-loop digest: how
    many refreshed versions were produced/pushed, what was rejected or
    skipped, and what the refits cost.  Empty when the run neither
    refit nor ran the online loop."""
    refits = [e for e in events if e.get("event") == "refit"]
    refreshes = [e for e in events if e.get("event") == "online_refresh"]
    if not (refits or refreshes):
        return {}
    out = {
        "refits": len(refits),
        "refreshes": len(refreshes),
        "refreshes_ok": sum(1 for e in refreshes if e.get("ok")),
        "refreshes_failed": sum(1 for e in refreshes
                                if not e.get("ok", True)
                                and not e.get("skipped")),
        "refreshes_skipped": sum(1 for e in refreshes if e.get("skipped")),
        "rows_refreshed": sum(int(e.get("rows", 0) or 0)
                              for e in refreshes if e.get("ok")),
    }
    if refits:
        last = refits[-1]
        out["refit_rows"] = sum(int(e.get("rows", 0) or 0) for e in refits)
        out["refit_wall_s"] = round(sum(float(e.get("wall_s", 0.0) or 0.0)
                                        for e in refits), 4)
        out["last_refit"] = {k: last.get(k) for k in
                             ("trees", "rows", "decay", "mode")}
    if refreshes:
        lat = sorted(float(e.get("ms", 0.0) or 0.0)
                     for e in refreshes if e.get("ok"))
        out["refresh_p50_ms"] = percentile(lat, 0.50)
        versions = [int(e.get("version", 0) or 0) for e in refreshes
                    if e.get("ok")]
        if versions:
            out["last_version"] = max(versions)
        skips = defaultdict(int)
        for e in refreshes:
            if e.get("skipped"):
                skips[str(e["skipped"])] += 1
        if skips:
            out["skipped_by_reason"] = dict(sorted(skips.items()))
    return out


def ingest_summary(events: List[dict]) -> dict:
    """Fold the streaming-ingestion events (``ingest_chunk`` per
    streamed chunk, ``ingest_summary`` per constructed dataset —
    ingest/stream.py) into one digest section: rows/chunks/throughput
    of the LAST ingestion plus totals across the run.  Empty when
    nothing streamed."""
    chunks = [e for e in events if e.get("event") == "ingest_chunk"]
    sums = [e for e in events if e.get("event") == "ingest_summary"]
    if not (chunks or sums):
        return {}
    out = {
        "ingestions": len(sums),
        "chunk_events": len(chunks),
        "rows_total": sum(int(e.get("rows", 0) or 0) for e in sums),
    }
    if sums:
        last = sums[-1]
        out["last"] = {k: last.get(k) for k in
                       ("rows", "local_rows", "chunks", "sample_rows",
                        "shards", "shard_id", "memmap", "wall_s",
                        "rows_per_s", "source", "digest")
                       if last.get(k) is not None}
        out["rows_per_s"] = last.get("rows_per_s")
    return out


def drift_summary(events: List[dict]) -> dict:
    """Fold the drift/quality plane (``drift_snapshot`` cadence checks
    from obs/drift.py's serve-side monitor, ``quality_window`` rolling
    evaluations from serve/quality.py) into one digest section: score
    trajectory extremes, breach counts, and the last window per model.
    Empty when the run monitored nothing."""
    snaps = [e for e in events if e.get("event") == "drift_snapshot"]
    wins = [e for e in events if e.get("event") == "quality_window"]
    if not (snaps or wins):
        return {}
    out = {"snapshots": len(snaps), "quality_windows": len(wins),
           "drift_breaches": sum(1 for e in snaps if e.get("breach")),
           "quality_breaches": sum(1 for e in wins if e.get("breach"))}
    if snaps:
        last = snaps[-1]
        out["psi_max"] = round(max(float(e.get("psi_max", 0.0) or 0.0)
                                   for e in snaps), 6)
        out["pred_psi_max"] = round(
            max(float(e.get("pred_psi", 0.0) or 0.0) for e in snaps), 6)
        out["last_snapshot"] = {k: last.get(k) for k in
                                ("model", "version", "feat_rows",
                                 "pred_rows", "psi_max", "pred_psi",
                                 "worst_feature", "breach")}
    if wins:
        last = wins[-1]
        deltas = [float(e["auc_delta"]) for e in wins
                  if e.get("auc_delta") is not None]
        if deltas:
            out["auc_delta_max"] = round(max(deltas), 6)
        out["last_window"] = {k: last.get(k) for k in
                              ("model", "version", "rows", "auc",
                               "auc_delta", "cal_err", "ndcg", "breach")
                              if last.get(k) is not None}
    return out


def trace_summary(events: List[dict]) -> dict:
    """Fold ``span`` events (obs/spans.py) into the trace digest:
    span/trace counts and per-name call/duration aggregates.  Empty when
    the run traced nothing.  ``tools/trace_export.py`` turns the same
    events into a Perfetto-loadable timeline."""
    spans = [e for e in events if e.get("event") == "span"]
    if not spans:
        return {}
    by_name = {}
    traces = set()
    for e in spans:
        traces.add(e.get("trace_id"))
        a = by_name.setdefault(e.get("name", "?"),
                               {"calls": 0, "total_ms": 0.0})
        a["calls"] += 1
        a["total_ms"] += float(e.get("dur_ms", 0.0) or 0.0)
    for a in by_name.values():
        a["total_ms"] = round(a["total_ms"], 3)
    return {"spans": len(spans), "traces": len(traces),
            "by_name": dict(sorted(by_name.items()))}


# ---------------------------------------------------------------------------
# Event schemas — the CI smoke validates profile-mode streams against these
# ---------------------------------------------------------------------------

_NUM = (int, float)
EVENT_SCHEMAS = {
    # event name -> {field: (types..., required)}
    # per-iteration training record (boosting/gbdt.py).  Nullable fields
    # (waves, kernel_rows, partition_passes — None off the wave path) are
    # deliberately NOT listed: the validator type-checks listed fields
    # only, and a null would fail the int check on legitimate streams.
    "iteration": {
        "iteration": (int, True),
        "iter_s": (_NUM, True),
        "leaves": (list, False),
        "metrics": (dict, False),
        "phase_s": (dict, False),
        "recompiles": (int, False),
        "partition_batched": (bool, False),
        "cum_row_iters_per_s": (_NUM, False),
        # wave-pipeline mode stamps: emitted only on the wave
        # path, never null
        "hist_mode": (str, False),
        "wave_capacity": (int, False),
        "fused_sibling": (bool, False),
        # quantized/fused/overlap pipeline stamps:
        # fused_grad + grad_hbm_bytes_saved ride every iteration (the
        # fused pass applies on the XLA path too); overlap/overlap_frac
        # only on the wave path
        "fused_grad": (bool, False),
        "grad_hbm_bytes_saved": (_NUM, False),
        "overlap": (bool, False),
        "overlap_frac": (_NUM, False),
    },
    "kernel_profile": {
        "kernel": (str, True),
        "phase": (str, False),
        "flops": (_NUM, True),
        "bytes": (_NUM, True),
        "achieved_s": (_NUM, True),
        "roofline_s": (_NUM, True),
        "roofline_frac": (_NUM, True),
        "device": (str, True),
    },
    # measured-roofline rows (obs/xprof.py): trace-attributed device-op
    # time per lgbm/* scope joined against the analytic cost models.
    # Model fields (flops/bytes/model_ms/roofline_frac/bound/model) are
    # present only for scopes an analytic model covers; 'unattributed'
    # residual rows carry measured fields only.
    "kernel_measured": {
        "kernel": (str, True),
        "measured_ms": (_NUM, True),
        "window_ms": (_NUM, True),
        "ops": (int, True),
        "source": (str, True),
        "device": (str, False),
        "occupancy": (_NUM, False),
        "flops": (_NUM, False),
        "bytes": (_NUM, False),
        "model": (str, False),
        "model_ms": (_NUM, False),
        "roofline_frac": (_NUM, False),
        "bound": (str, False),
    },
    # compile-plane events (obs/xprof.py): kind is backend_compile
    # (per-jit wall), cache_hit / cache_miss (persistent compile
    # cache), or retrace (with the argument-signature diff that
    # forced it)
    "compile": {
        "kind": (str, True),
        "jit": (str, False),
        "wall_s": (_NUM, False),
        "changed": (list, False),
        "signatures": (int, False),
    },
    "memory_census": {
        "phase": (str, True),
        "buffers": (dict, True),
        "live_bytes": (int, True),
        "live_count": (int, True),
        "unattributed_bytes": (int, True),
        "peak_bytes": (int, True),
    },
    "donation_audit": {
        "phase": (str, True),
        "survivors": (list, True),
    },
    # training-health sentinels (obs/health.py)
    "health": {
        "check": (str, True),
        "phase": (str, True),
        "iteration": (int, True),
        "mode": (str, True),
        "ok": (bool, True),
        "detail": (dict, False),
    },
    "fingerprint": {
        "iteration": (int, True),
        "digest": (str, True),
        "stats": (list, True),
        "trees": (int, False),
    },
    "divergence": {
        "iteration": (int, True),
        "ok": (bool, True),
        "ranks": (int, True),
        "digests": (list, True),
        "spread": (list, False),
    },
    # serving engine (serve/session.py)
    "serve_request": {
        "rows": (int, True),
        "total_ms": (_NUM, True),
        "ok": (bool, True),
        "reason": (str, False),
    },
    "serve_batch": {
        "rows": (int, True),
        "padded": (int, True),
        "requests": (int, True),
        "queue_rows": (int, True),
        "exec_ms": (_NUM, True),
        "degraded": (bool, True),
    },
    "serve_degraded": {
        "error": (str, True),
        "plane": (str, False),   # absent = predict, "explain" = TreeSHAP
    },
    # explanation serving (serve/session.py explain path + explain/)
    "explain_request": {
        "rows": (int, True),
        "total_ms": (_NUM, True),
        "ok": (bool, True),
        "reason": (str, False),
    },
    "explain_batch": {
        "rows": (int, True),
        "padded": (int, True),
        "requests": (int, True),
        "queue_rows": (int, True),
        "exec_ms": (_NUM, True),
        "degraded": (bool, True),
    },
    "serve_overload": {
        "rows": (int, True),
        "queue_rows": (int, True),
        "priority": (str, False),   # shedding class of the rejected
                                    # request (low sheds first)
    },
    # serving fleet (serve/registry.py + serve/router.py)
    "serve_swap": {
        "model": (str, True),
        "ok": (bool, True),
        "from_version": (int, False),
        "to_version": (int, True),
        "ms": (_NUM, False),
        "initial": (bool, False),
    },
    "serve_canary": {
        "model": (str, True),
        "version": (int, True),
        "ok": (bool, True),
        "checks": (dict, True),
        "p99_ms": (_NUM, False),
    },
    "serve_rollback": {
        "model": (str, True),
        "from_version": (int, True),
        "to_version": (int, True),
        "reason": (str, True),
    },
    "serve_failover": {
        "replica": (int, True),
        "classify": (str, True),
        "breaker": (str, True),
        "error": (str, False),
    },
    "serve_drain": {
        "replica": (int, True),
        "draining": (bool, True),
    },
    # zero-cold-start plane (serve/aot.py): a present-but-untrusted
    # store entry fell back to a JIT compile — the loud part of the
    # "never crash" contract
    "aot_fallback": {
        "kind": (str, True),
        "entry": (str, True),
        "reason": (str, True),
    },
    "serve_replica_restart": {
        "replica": (int, True),
        "boot_ms": (_NUM, True),
        "boot_compiles": (int, True),
        "aot": (bool, True),
    },
    # multi-tenant arena plane (serve/arena.py): residency transitions
    "arena_admit": {
        "model": (str, True),
        "tenants": (int, True),
        "resident": (int, True),
        "bytes": (int, True),
        "readmit": (bool, True),
    },
    "arena_evict": {
        "model": (str, True),
        "reason": (str, True),
        "bytes": (int, False),
    },
    "arena_repack": {
        "generation": (int, True),
        "tenants": (int, True),
        "trees": (int, True),
        "bytes": (int, True),
        "ms": (_NUM, True),
    },
    "arena_swap": {
        "model": (str, True),
        "ok": (bool, True),
        "version": (int, False),
        "generation": (int, False),
        "error": (str, False),
    },
    # trace plane (obs/spans.py) + the HTTP access log (serve/server.py)
    "span": {
        "name": (str, True),
        "trace_id": (str, True),
        "span_id": (str, True),
        "parent_id": (str, False),
        "dur_ms": (_NUM, True),
        "attrs": (dict, False),
    },
    "serve_access": {
        "method": (str, True),
        "path": (str, True),
        "status": (int, True),
        "latency_ms": (_NUM, True),
        "trace_id": (str, True),
    },
    # fault tolerance (robust/checkpoint.py + robust/watchdog.py +
    # robust/faults.py)
    "checkpoint": {
        "iteration": (int, True),
        "path": (str, True),
        "bytes": (int, False),
        "ms": (_NUM, False),
        "reason": (str, False),
    },
    "restore": {
        "iteration": (int, True),
        "path": (str, True),
    },
    "retry": {
        "point": (str, True),
        "attempt": (int, True),
        "classify": (str, True),
        "action": (str, True),
        "error": (str, False),
        "delay_ms": (_NUM, False),
        "iteration": (int, False),
    },
    "fault_injected": {
        "point": (str, True),
        "action": (str, True),
        "call": (int, True),
        "iteration": (int, False),
    },
    "device_stall": {
        "point": (str, True),
        "elapsed_s": (_NUM, True),
        "deadline_s": (_NUM, True),
        "iteration": (int, False),
    },
    "serve_probe": {
        "ok": (bool, True),
        "error": (str, False),
        "plane": (str, False),
    },
    "serve_recovered": {
        "plane": (str, False),
    },
    # online learning (boosting/gbdt.py refit_models + online/loop.py)
    "refit": {
        "trees": (int, True),
        "rows": (int, True),
        "decay": (_NUM, True),
        "wall_s": (_NUM, True),
        "mode": (str, True),       # device (the jitted kernel) | host
                                   # (the retained bincount oracle)
        "iterations": (int, False),
    },
    "online_refresh": {
        "mode": (str, True),       # refit | continue
        "ok": (bool, True),
        "rows": (int, False),
        "ms": (_NUM, False),
        "version": (int, False),   # successful pushes only
        "skipped": (str, False),   # e.g. "ingest_stall" — the cadence
                                   # fired but no fresh rows arrived
        "error": (str, False),
    },
    # streaming ingestion (ingest/stream.py)
    "ingest_chunk": {
        "pass": (int, True),       # 1 = count/sample, 2 = binarize
        "chunk": (int, True),
        "rows": (int, True),
        "stream_row0": (int, True),
    },
    "ingest_summary": {
        "rows": (int, True),       # whole-stream rows
        "local_rows": (int, True),  # this shard's binned rows
        "chunks": (int, True),
        "sample_rows": (int, True),
        "shards": (int, True),
        "shard_id": (int, True),
        "memmap": (bool, True),
        "wall_s": (_NUM, True),
        "rows_per_s": (_NUM, True),
        "source": (str, True),
        "digest": (str, False),    # dataset content digest (recorded
                                   # when telemetry/flight is armed —
                                   # crash-resume re-streams must match)
    },
    # drift/quality plane (obs/drift.py + serve/quality.py)
    "drift_snapshot": {
        "model": (str, True),
        "version": (int, True),
        "feat_rows": (int, True),   # sampled feature rows in the sketch
        "pred_rows": (int, True),   # scored responses in the sketch
        "psi_max": (_NUM, True),    # worst per-feature PSI vs reference
        "psi_mean": (_NUM, True),
        "ks_max": (_NUM, True),
        "pred_psi": (_NUM, True),   # prediction-histogram PSI
        "pred_ks": (_NUM, True),
        "worst_feature": (str, True),
        "breach": (bool, True),
    },
    "quality_window": {
        "model": (str, True),
        "version": (int, True),     # served version the window scored
        "rows": (int, True),
        "auc": (_NUM, False),       # absent for single-class windows
        "auc_ref": (_NUM, False),   # training AUC from the profile
        "auc_delta": (_NUM, False),  # ref - live (positive = worse)
        "cal_err": (_NUM, False),
        "ndcg": (_NUM, False),
        "breach": (bool, True),
    },
    # live introspection plane (obs/ranks.py)
    "straggler": {
        "rank": (int, True),        # the offending process index
        "phase": (str, True),       # which phase lagged (ranks.PHASES)
        "iteration": (int, True),
        "ratio": (_NUM, True),      # rank wall over fleet median
        "median_s": (_NUM, True),   # per-iteration fleet median wall
        "rank_s": (_NUM, True),     # per-iteration offender wall
        "consecutive": (int, True),  # iterations the streak lasted
        "breach": (bool, False),
    },
    "reconciliation": {
        "iteration": (int, True),
        "units": (dict, True),      # unit -> {measured_s, modeled_s,
                                    #          ratio}
    },
}


def validate_events(events: List[dict], kinds=None) -> List[str]:
    """Schema-check every event whose name is in ``EVENT_SCHEMAS`` (or in
    ``kinds`` when given).  Returns human-readable problem strings —
    empty means the stream is well-formed.  Pure structural validation;
    semantic checks (nonzero FLOPs etc.) belong to the caller."""
    problems = []
    for i, e in enumerate(events):
        name = e.get("event")
        if name not in EVENT_SCHEMAS or (kinds and name not in kinds):
            continue
        for field, (types, required) in EVENT_SCHEMAS[name].items():
            if field not in e:
                if required:
                    problems.append(f"event {i} ({name}): missing {field!r}")
                continue
            v = e[field]
            types_t = types if isinstance(types, tuple) else (types,)
            # bool is an int subclass; only fields that SAY bool take one
            bad = (bool not in types_t if isinstance(v, bool)
                   else not isinstance(v, types))
            if bad:
                problems.append(
                    f"event {i} ({name}): {field!r} has type "
                    f"{type(v).__name__}, wanted {types}")
    return problems


def render(digest: dict) -> str:
    """Human-readable table for the digest."""
    out = []
    out.append(f"processes: {len(digest['processes'])}  "
               f"iterations: {digest['iterations']}")
    if digest["phase_s"]:
        total = sum(digest["phase_s"].values()) or 1.0
        calls = digest.get("phase_calls") or {}
        out.append("")
        out.append(f"{'phase':<28}{'seconds':>10}{'share':>8}{'calls':>8}")
        for name, s in sorted(digest["phase_s"].items(),
                              key=lambda kv: -kv[1]):
            c = calls.get(name)
            out.append(f"{name:<28}{s:>10.3f}{100.0 * s / total:>7.1f}%"
                       f"{c if c is not None else '-':>8}")
    rows = digest["per_iteration"]
    if rows:
        out.append("")
        out.append(f"{'iter':>5}{'iter_s':>9}{'leaves':>10}{'waves':>7}"
                   f"{'recomp':>7}  metrics")
        for r in rows:
            leaves = r.get("leaves")
            leaves_s = ",".join(str(x) for x in leaves) if leaves else "-"
            metr = " ".join(f"{k}={v:.6g}"
                            for k, v in (r.get("metrics") or {}).items())
            waves = r.get("waves")
            out.append(f"{r.get('iteration', '?'):>5}"
                       f"{(r.get('iter_s') or 0.0):>9.3f}"
                       f"{leaves_s:>10}"
                       f"{'-' if waves in (None, -1) else waves:>7}"
                       f"{r.get('recompiles') if r.get('recompiles') is not None else '-':>7}"
                       f"  {metr}")
        if digest.get("cum_row_iters_per_s"):
            out.append(f"cumulative row-iterations/s: "
                       f"{digest['cum_row_iters_per_s']:,}")
    if digest.get("wave_pipeline"):
        w = digest["wave_pipeline"]
        parts = []
        if w.get("waves_per_tree") is not None:
            parts.append(f"{w['waves_per_tree']} waves/tree "
                         f"({w['waves_total']} waves / "
                         f"{w['trees_grown']} trees)")
        if w.get("hist_mode"):
            parts.append(f"hist_mode={w['hist_mode']}")
        if w.get("wave_capacity") is not None:
            parts.append(f"capacity={w['wave_capacity']}")
        if w.get("fused_sibling") is not None:
            parts.append(f"fused_sibling={'on' if w['fused_sibling'] else 'off'}")
        if w.get("fused_grad") is not None:
            parts.append(f"fused_grad={'on' if w['fused_grad'] else 'off'}")
        if w.get("overlap") is not None:
            txt = "on" if w["overlap"] else "off"
            if w.get("overlap_frac") is not None:
                txt += f" ({w['overlap_frac']:.0%} of waves)"
            parts.append(f"overlap={txt}")
        if w.get("grad_hbm_bytes_saved"):
            parts.append(
                f"grad_hbm_saved={w['grad_hbm_bytes_saved'] / 1e6:.1f}MB/it")
        out.append("")
        out.append("wave pipeline: " + ", ".join(parts))
    if digest.get("phase_skew"):
        out.append("")
        out.append(f"{'phase skew (cross-process)':<28}{'min_s':>9}"
                   f"{'max_s':>9}{'spread':>9}{'frac':>7}")
        for name, s in sorted(digest["phase_skew"].items(),
                              key=lambda kv: -kv[1]["spread_frac"]):
            out.append(f"{name:<28}{s['min_s']:>9.3f}{s['max_s']:>9.3f}"
                       f"{s['spread_s']:>9.3f}{s['spread_frac']:>6.1%}")
    if digest.get("kernels"):
        out.append("")
        out.append(f"{'kernel':<28}{'calls':>6}{'achieved':>10}"
                   f"{'roofline':>10}{'frac':>8}")
        for name, k in sorted(digest["kernels"].items(),
                              key=lambda kv: -kv[1]["achieved_s"]):
            out.append(f"{name:<28}{k['calls']:>6}"
                       f"{k['achieved_s']:>9.3f}s"
                       f"{k['roofline_s']:>9.4f}s"
                       f"{k['roofline_frac']:>8.4f}")
    if digest.get("xprof"):
        xp = digest["xprof"]
        out.append("")
        out.append(f"measured roofline (xprof window "
                   f"{xp.get('window_ms', 0):.1f} ms):")
        out.append(f"{'kernel':<28}{'ops':>6}{'measured':>11}"
                   f"{'model':>11}{'frac':>8}{'bound':>7}")
        for name, k in sorted(xp.get("kernels", {}).items(),
                              key=lambda kv: -kv[1]["measured_ms"]):
            model_ms = k.get("model_ms")
            frac = k.get("roofline_frac")
            out.append(
                f"{name:<28}{k['ops']:>6}"
                f"{k['measured_ms']:>9.3f}ms"
                + (f"{model_ms:>9.3f}ms" if model_ms is not None
                   else f"{'—':>11}")
                + (f"{frac:>8.4f}" if frac is not None else f"{'—':>8}")
                + f"{k.get('bound', '—'):>7}")
    if digest.get("compile"):
        c = digest["compile"]
        out.append("")
        out.append(f"compile plane: {c.get('kernel_builds', 0)} kernel "
                   f"build(s) ({c.get('kernel_build_s', 0.0):.2f} s), "
                   f"{sum((c.get('graph_captures') or {}).values())} CUDA "
                   f"graph capture(s), {c['retraces']} retrace(s)")
        for g, n in (c.get("graph_captures") or {}).items():
            out.append(f"  graph captures {g:<18} {n:>4}")
        for jit, ent in sorted((c.get("by_jit") or {}).items(),
                               key=lambda kv: -kv[1]["wall_s"]):
            out.append(f"  {jit:<26} {ent['count']:>4} compile(s)"
                       f"{ent['wall_s']:>9.3f}s")
        for jit, changed in (c.get("retrace_jits") or {}).items():
            out.append(f"  retrace {jit}: {'; '.join(changed[:3])}")
    if digest.get("memory"):
        m = digest["memory"]
        out.append("")
        out.append(f"memory census: peak {m['peak_bytes']:,} bytes "
                   f"(phase {m.get('peak_phase', '?')!r}, "
                   f"{m.get('snapshots', 0)} snapshots)")
        for name, b in sorted((m.get("buffers_last") or {}).items(),
                              key=lambda kv: -kv[1]):
            out.append(f"  {name:<26} {b:>14,}")
        if m.get("audit_survivors"):
            out.append(f"  RELEASE-AUDIT SURVIVORS: "
                       f"{', '.join(m['audit_survivors'])}")
    if digest.get("health"):
        h = digest["health"]
        out.append("")
        verdict = ("DIVERGED" if h.get("divergence_failures")
                   else "FAILED" if h.get("failures") else "healthy")
        out.append(f"training health: {verdict} — {h['failures']} check "
                   f"failure(s), {h['fingerprints']} fingerprint(s), "
                   f"{h['divergence_checks']} divergence audit(s)")
        if h.get("first_failure"):
            f = h["first_failure"]
            out.append(f"  first failure: {f.get('check')} at iteration "
                       f"{f.get('iteration')} in phase {f.get('phase')!r} "
                       f"{f.get('detail')}")
        if h.get("last_fingerprint"):
            lf = h["last_fingerprint"]
            out.append(f"  last fingerprint: iteration "
                       f"{lf.get('iteration')} digest {lf.get('digest')}")
    if digest.get("serve"):
        s = digest["serve"]
        out.append("")
        verdict = "DEGRADED (host fallback)" if s.get("degraded") else "ok"
        out.append(f"serving: {verdict} — {s['requests']} request(s), "
                   f"{s['batches']} batch(es), "
                   f"p50 {s.get('p50_ms')}ms p99 {s.get('p99_ms')}ms")
        if s.get("padded_rows"):
            out.append(f"  batch occupancy {s.get('occupancy'):.1%} "
                       f"({s['rows']:,} rows / {s['padded_rows']:,} padded, "
                       f"{s['pad_waste_rows']:,} pad-waste rows), "
                       f"queue peak {s.get('max_queue_rows', 0)} rows")
        if s.get("overloads") or s.get("deadline_missed"):
            out.append(f"  overloads {s.get('overloads', 0)}, deadline "
                       f"misses {s.get('deadline_missed', 0)}")
        if s.get("explain"):
            x = s["explain"]
            occ = x.get("occupancy")
            out.append(f"  explain: {x['requests']} request(s), "
                       f"{x['batches']} batch(es), "
                       f"p50 {x.get('p50_ms')}ms p99 {x.get('p99_ms')}ms"
                       + (f", occupancy {occ:.1%}" if occ else "")
                       + (f", deadline misses {x['deadline_missed']}"
                          if x.get("deadline_missed") else ""))
        if s.get("fleet"):
            f = s["fleet"]
            line = (f"  fleet: {f['swaps']} swap(s), "
                    f"{f['swaps_rejected']} rejected by canary, "
                    f"{f['rollbacks']} rollback(s), "
                    f"{f['failovers']} replica failover(s)")
            if f.get("last_rollback"):
                lr = f["last_rollback"]
                line += (f" — last rollback: {lr.get('model')} "
                         f"({lr.get('reason')})")
            out.append(line)
        if s.get("shed_by_priority"):
            out.append("  shed by priority: " + ", ".join(
                f"{k}={v}" for k, v in s["shed_by_priority"].items()))
    if digest.get("robust"):
        r = digest["robust"]
        out.append("")
        out.append(f"recovery: {r['checkpoints']} checkpoint(s), "
                   f"{r['restores']} restore(s), {r['retries']} device "
                   f"retr{'y' if r['retries'] == 1 else 'ies'}, "
                   f"{r['stalls']} stall(s), {r['serve_recoveries']} "
                   f"serve recover(ies), {r['faults_injected']} injected "
                   f"fault(s)")
        if r.get("resumed_from_iteration") is not None:
            out.append(f"  resumed from iteration "
                       f"{r['resumed_from_iteration']}")
        if r.get("last_checkpoint"):
            lc = r["last_checkpoint"]
            out.append(f"  last checkpoint: iteration {lc.get('iteration')}"
                       f" ({lc.get('reason')})")
        for point, v in (r.get("retries_by_point") or {}).items():
            out.append(f"  retries at {point:<20} {v.get('retries', 0)} "
                       f"({v.get('transient', 0)} transient, "
                       f"{v.get('fatal', 0)} fatal)")
    if digest.get("online"):
        o = digest["online"]
        out.append("")
        line = (f"online loop: {o.get('refreshes_ok', 0)} refresh(es) "
                f"pushed, {o.get('refreshes_failed', 0)} failed, "
                f"{o.get('refreshes_skipped', 0)} skipped, "
                f"{o['refits']} refit(s)")
        if o.get("last_version"):
            line += f" — live at v{o['last_version']}"
        out.append(line)
        if o.get("last_refit"):
            lr = o["last_refit"]
            out.append(f"  last refit: {lr.get('trees')} tree(s) over "
                       f"{lr.get('rows')} row(s), decay "
                       f"{lr.get('decay')}, {lr.get('mode')} path "
                       f"({o.get('refit_wall_s', 0)}s total)")
        if o.get("skipped_by_reason"):
            out.append("  skipped: " + ", ".join(
                f"{k}={v}" for k, v in o["skipped_by_reason"].items()))
    if digest.get("ingest"):
        g = digest["ingest"]
        out.append("")
        last = g.get("last") or {}
        line = (f"ingest: {g.get('ingestions', 0)} ingestion(s), "
                f"{g.get('rows_total', 0):,} row(s) streamed")
        if last.get("rows_per_s"):
            line += f" — last at {last['rows_per_s']:,.0f} rows/s"
        if last.get("shards", 1) and last.get("shards", 1) > 1:
            line += (f", shard {last.get('shard_id')}/"
                     f"{last.get('shards')} "
                     f"({last.get('local_rows'):,} local rows)")
        if last.get("memmap"):
            line += ", memmap-backed"
        out.append(line)
        if last.get("digest"):
            out.append(f"  dataset digest {last['digest']}")
    if digest.get("drift"):
        d = digest["drift"]
        out.append("")
        verdict = ("BREACHED" if (d.get("drift_breaches")
                                  or d.get("quality_breaches"))
                   else "quiet")
        out.append(f"drift/quality: {verdict} — {d['snapshots']} "
                   f"snapshot(s) ({d.get('drift_breaches', 0)} drift "
                   f"breach(es)), {d['quality_windows']} quality "
                   f"window(s) ({d.get('quality_breaches', 0)} quality "
                   f"breach(es))")
        if d.get("last_snapshot"):
            ls = d["last_snapshot"]
            out.append(f"  last snapshot: {ls.get('model')} "
                       f"v{ls.get('version')} psi_max "
                       f"{ls.get('psi_max')} pred_psi "
                       f"{ls.get('pred_psi')} "
                       f"(worst {ls.get('worst_feature') or '-'}, "
                       f"{ls.get('feat_rows')}/{ls.get('pred_rows')} "
                       f"feat/pred rows)")
        if d.get("last_window"):
            lw = d["last_window"]
            parts = [f"{lw.get('rows')} row(s)"]
            if lw.get("auc") is not None:
                parts.append(f"auc {lw['auc']}")
            if lw.get("auc_delta") is not None:
                parts.append(f"delta {lw['auc_delta']}")
            if lw.get("cal_err") is not None:
                parts.append(f"cal_err {lw['cal_err']}")
            if lw.get("ndcg") is not None:
                parts.append(f"ndcg {lw['ndcg']}")
            out.append(f"  last window: {lw.get('model')} "
                       f"v{lw.get('version')} " + ", ".join(parts))
    if digest.get("stragglers"):
        out.append("")
        out.append(f"{'straggler breaches':<28}{'rank':>6}{'iter':>7}"
                   f"{'ratio':>8}{'median_s':>10}{'rank_s':>10}")
        for s in digest["stragglers"]:
            out.append(f"{(s.get('phase') or '?'):<28}"
                       f"{(s.get('rank') if s.get('rank') is not None else '?'):>6}"
                       f"{(s.get('iteration') if s.get('iteration') is not None else '?'):>7}"
                       f"{(s.get('ratio') or 0.0):>8.2f}"
                       f"{(s.get('median_s') or 0.0):>10.4f}"
                       f"{(s.get('rank_s') or 0.0):>10.4f}")
    if digest.get("reconciliation"):
        out.append("")
        out.append(f"{'reconciliation (meas/model)':<28}{'iters':>6}"
                   f"{'mean':>8}{'last':>8}{'worst':>8}{'@iter':>7}")
        for unit, u in sorted(digest["reconciliation"].items(),
                              key=lambda kv: -(kv[1]["mean_ratio"] or 0)):
            worst_it = u.get("worst_iteration")
            out.append(f"{unit:<28}{u['iterations']:>6}"
                       f"{u['mean_ratio']:>8.2f}"
                       f"{(u.get('last_ratio') or 0.0):>8.2f}"
                       f"{(u.get('worst_ratio') or 0.0):>8.2f}"
                       f"{(worst_it if worst_it is not None else '-'):>7}")
    if digest.get("trace"):
        t = digest["trace"]
        out.append("")
        out.append(f"trace plane: {t['spans']} span(s) across "
                   f"{t['traces']} trace(s) — export with "
                   f"tools/trace_export.py")
        for name, a in sorted(t["by_name"].items(),
                              key=lambda kv: -kv[1]["total_ms"])[:8]:
            out.append(f"  {name:<28} {a['calls']:>6} calls "
                       f"{a['total_ms']:>10.1f} ms")
    if digest["counters"]:
        out.append("")
        out.append("counters:")
        for k, v in digest["counters"].items():
            out.append(f"  {k:<40} {v}")
    if digest.get("parse_errors"):
        out.append(f"\n(parse errors skipped: {digest['parse_errors']})")
    return "\n".join(out)


def main(argv=None) -> int:
    """CLI entry: ``python -m lightgbm_tpu_torch.obs.report <path>
    [--json]``."""
    import argparse
    import sys

    ap = argparse.ArgumentParser(
        prog="python -m lightgbm_tpu_torch.obs.report",
        description="Summarize lightgbm_tpu_torch telemetry JSONL files")
    ap.add_argument("path", help="telemetry dir, one .jsonl file, or a "
                                 "glob")
    ap.add_argument("--json", action="store_true",
                    help="print the machine-readable digest instead of "
                         "the table")
    args = ap.parse_args(argv)

    files = telemetry_files(args.path)
    if not files:
        print(f"no telemetry files under {args.path!r}", file=sys.stderr)
        return 1
    digest = summarize(load_events(args.path))
    if args.json:
        print(json.dumps(digest))
    else:
        print(f"merged {len(files)} file(s)")
        print(render(digest))
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
