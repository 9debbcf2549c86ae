"""The port's suite runner (counterpart of tools/run_suite.py): each tier
in a process of its own, timed, its counts parsed, one JSON record.

- ``quick``: ``pytest tests/test_torch_*.py -m 'not slow'`` with the
  tier-1 flags (``--select`` narrows it to a file or node id);
- one tier for each twin of ``tools/``, under the JAX runner's tier
  names: ``faults`` (``fault_matrix``), ``chaos`` (``chaos_serve``),
  ``online`` (``online_smoke``), ``ingest`` (``ingest_bench``), ``drift``
  (``drift_report --smoke``), ``board`` (``board_smoke``), ``xprof``
  (``xprof_smoke``), ``arena`` (``arena_smoke``) and ``fleet``
  (``fleet_smoke``).  A twin's last JSON line is its verdict map; its
  checks become the tier's counts.

The JAX runner's ``serve`` tier (``bench_serve.py``) has no twin here:
it is a benchmark.  ``NO_TWIN`` lists every tool of ``tools/`` left
without a twin, with the reason.

The tool tiers run on ``--device`` (default ``cuda``; with no card they
fail loudly unless ``--device cpu`` is given).  The record
(``SUITE.json``) and each tier's whole output (``<tier>.log``) go to
``--out`` (default: a new temporary directory), never into the
repository.

    python -m lightgbm_tpu_torch.tools.run_suite --device cpu
    python -m lightgbm_tpu_torch.tools.run_suite --tiers faults,chaos
    python -m lightgbm_tpu_torch.tools.run_suite --tiers quick \\
        --select tests/test_torch_config.py
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import re
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# the tier-1 flags (ROADMAP.md "Tier-1 verify") but the marker, which the
# tier sets
_PYTEST_FLAGS = ["-q", "--continue-on-collection-errors",
                 "-p", "no:cacheprovider"]

_COUNT_RE = re.compile(
    r"(\d+)\s+(passed|failed|error(?:s)?|skipped|deselected|xfailed|"
    r"xpassed|warning(?:s)?)")

# tier -> the twin's module under lightgbm_tpu_torch/tools and its
# arguments
TOOL_TIERS = {
    "faults": ["fault_matrix"],
    "chaos": ["chaos_serve"],
    "online": ["online_smoke"],
    "ingest": ["ingest_bench"],
    "drift": ["drift_report", "--smoke"],
    "board": ["board_smoke"],
    "xprof": ["xprof_smoke"],
    "arena": ["arena_smoke"],
    "fleet": ["fleet_smoke"],
}

DEFAULT_TIERS = ("quick",) + tuple(TOOL_TIERS)

# the tools of tools/ that import the JAX package and have no twin here
NO_TWIN = {
    "bench_serve.py": "a benchmark: the port's benchmark is ROADMAP.md "
                      "item 12 (the JAX runner's 'serve' tier)",
    "prof_kernels.py": "a kernel benchmark: waits for ROADMAP.md item 12",
    "tpu_window.py": "watches a TPU lease; the card has none",
    "bench_history.py": "reads the round files (BENCH_r*, ONLINE_r*, ...) "
                        "of any package; it imports no training code",
    "gen_param_docs.py": "renders the JAX package's Config; the port's "
                         "parameter docs are queued in ROADMAP.md",
    "telemetry_report.py": "already reads the port's events "
                           "(lightgbm_tpu_torch/obs/report.py)",
    "trace_export.py": "already reads the port's span events",
    "train_watch.py": "already reads the port's train board",
}


def parse_counts(output: str) -> dict:
    """The counts of pytest's summary line (the last line with a
    '<n> passed/failed/...' token)."""
    counts = {}
    for line in reversed((output or "").splitlines()):
        found = _COUNT_RE.findall(line)
        if found:
            for n, kind in found:
                counts[kind.rstrip("s") if kind != "passed" else kind] = \
                    int(n)
            break
    return counts


def _env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _tail(out: str, err: str, log_path: str = "") -> list:
    """The output's last lines; the whole of it to ``log_path`` if
    given."""
    text = out + ("\n" + err if err else "")
    if log_path:
        with open(log_path, "w") as fh:
            fh.write(text)
    return text.splitlines()[-5:]


def run_quick(select: str, timeout: int, log_dir: str = "") -> dict:
    """The port's tests but the slow ones, in one pytest process."""
    targets = ([select] if select else
               sorted(glob.glob(os.path.join(REPO, "tests",
                                             "test_torch_*.py"))))
    argv = [sys.executable, "-m", "pytest", *targets, "-m",
            "not slow"] + _PYTEST_FLAGS
    t0 = time.time()
    try:
        r = subprocess.run(argv, env=_env(), cwd=REPO, timeout=timeout,
                           capture_output=True, text=True)
        rc, out, err = r.returncode, r.stdout or "", r.stderr or ""
    except subprocess.TimeoutExpired:
        rc, out, err = -1, "", f"timed out after {timeout} s"
    counts = parse_counts(out)
    # pytest's 5: nothing collected, an empty tier and not a failure
    return {"tier": "quick", "cmd": " ".join(argv[2:]), "rc": rc,
            "ok": rc in (0, 5), "empty": rc == 5,
            "wall_s": round(time.time() - t0, 1), "counts": counts,
            "tail": _tail(out, err, log_dir and os.path.join(
                log_dir, "quick.log"))}


def run_tool(tier: str, device: str, timeout: int,
             log_dir: str = "") -> dict:
    """A twin's tier: one process; its last JSON line's checks are the
    tier's counts."""
    mod, *rest = TOOL_TIERS[tier]
    argv = [sys.executable, "-m", f"lightgbm_tpu_torch.tools.{mod}", *rest,
            "--device", device, "--json"]
    t0 = time.time()
    try:
        r = subprocess.run(argv, env=_env(), cwd=REPO, timeout=timeout,
                           capture_output=True, text=True)
        rc, out, err = r.returncode, r.stdout or "", r.stderr or ""
    except subprocess.TimeoutExpired:
        rc, out, err = -1, "", f"timed out after {timeout} s"
    parsed = None
    for line in reversed(out.splitlines()):
        if line.strip().startswith("{"):
            try:
                parsed = json.loads(line)
                break
            except ValueError:
                continue
    checks = (parsed or {}).get("checks") or {}
    return {"tier": tier, "cmd": " ".join(argv[2:]), "rc": rc,
            "ok": rc == 0 and bool((parsed or {}).get("ok")),
            "empty": False, "wall_s": round(time.time() - t0, 1),
            "counts": {"passed": sum(1 for x in checks.values() if x),
                       "failed": sum(1 for x in checks.values() if not x)},
            "checks": checks,
            "k1_launches": (parsed or {}).get("k1_launches"),
            "tail": _tail(out, err, log_dir and os.path.join(
                log_dir, f"{tier}.log"))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="The port's suite: the quick test tier and the tools' "
                    "tiers")
    ap.add_argument("--tiers", default=",".join(DEFAULT_TIERS),
                    help="comma list of tiers: quick and "
                         + ", ".join(TOOL_TIERS)
                         + f" (default {','.join(DEFAULT_TIERS)})")
    ap.add_argument("--select", default="",
                    help="pytest target (file or node id) for the quick "
                         "tier instead of tests/test_torch_*.py")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="device of the tool tiers (default cuda)")
    ap.add_argument("--timeout", type=int, default=3600,
                    help="a tier's time limit in seconds (default 3600)")
    ap.add_argument("--out", default="",
                    help="directory of the SUITE.json record (default: a "
                         "new temporary directory)")
    args = ap.parse_args(argv)

    tiers = [t.strip() for t in args.tiers.split(",") if t.strip()]
    unknown = [t for t in tiers if t != "quick" and t not in TOOL_TIERS]
    if unknown:
        ap.error(f"unknown tier(s) {unknown}")
    if args.select and len(tiers) > 1:
        # --select narrows the pytest tier; the tool tiers are dropped,
        # unless one is the only tier asked for
        tiers = [t for t in tiers if t not in TOOL_TIERS]
    if any(t in TOOL_TIERS for t in tiers):
        from ._verdict import resolve_device
        if resolve_device(args.device) is None:
            return 2
    out_dir = args.out or tempfile.mkdtemp(prefix="suite_")
    os.makedirs(out_dir, exist_ok=True)
    record = {"kind": "suite", "t": round(time.time(), 1),
              "device": args.device, "tiers": {}}
    for tier in tiers:
        print(f"# tier {tier} ...", flush=True)
        res = (run_quick(args.select, args.timeout, log_dir=out_dir)
               if tier == "quick"
               else run_tool(tier, args.device, args.timeout,
                             log_dir=out_dir))
        record["tiers"][tier] = res
        print(f"# tier {tier}: rc={res['rc']} {res['counts']} "
              f"({res['wall_s']} s)", flush=True)
    record["wall_s"] = round(sum(t["wall_s"]
                                 for t in record["tiers"].values()), 1)
    record["ok"] = all(t["ok"] for t in record["tiers"].values())
    record["failed"] = sum(t["counts"].get("failed", 0)
                           + t["counts"].get("error", 0)
                           for t in record["tiers"].values())
    path = os.path.join(out_dir, "SUITE.json")
    with open(path, "w") as fh:
        json.dump(record, fh, indent=1)
    print(f"# wrote {path}", flush=True)
    print(json.dumps({k: record[k] for k in ("ok", "failed", "wall_s")}
                     | {"record": path}), flush=True)
    return 0 if record["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
