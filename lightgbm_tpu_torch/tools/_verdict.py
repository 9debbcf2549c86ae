"""What every matrix and smoke of ``lightgbm_tpu_torch/tools/`` shares:
the verdict map, the device rule and K1's launch count.

A tool records each check with :meth:`Verdict.check` under the JAX tool's
name (or the port's, through its ``DEPARTURES`` table), prints one JSON
line ``{"kind": ..., "ok": ..., "checks": {...}, ...}`` and exits 0 only
when every check is true.  It runs on ``cuda`` unless ``--device cpu`` is
given; asked for ``cuda`` with no card, it exits 2 with a message and
never carries on on the CPU.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Any, Dict, Optional


class Verdict:
    """A tool's named checks, each true or false."""

    def __init__(self, kind: str, quiet: bool = False):
        self.kind = kind
        self.checks: Dict[str, bool] = {}
        self.t0 = time.time()
        self.quiet = quiet
        self.leg_s: Dict[str, float] = {}

    def leg(self, name: str, t0: float) -> None:
        """Note the seconds a leg took since ``t0`` (``time.time()``)."""
        self.leg_s[name] = round(time.time() - t0, 2)

    def check(self, name: str, ok: Any, detail: Any = "") -> bool:
        self.checks[name] = bool(ok)
        if not self.quiet:
            print(f"# {'ok ' if ok else 'FAIL'} {name}"
                  + (f" — {detail}" if detail != "" and not ok else ""),
                  flush=True)
        return bool(ok)

    def fail_missing(self, *names: str) -> None:
        """Record as false each of ``names`` a failed leg did not reach."""
        for name in names:
            self.checks.setdefault(name, False)

    def record(self, **extra: Any) -> Dict[str, Any]:
        return {"kind": self.kind, "t": round(time.time(), 1),
                "wall_s": round(time.time() - self.t0, 1),
                "checks": dict(self.checks),
                "ok": bool(self.checks) and all(self.checks.values()),
                "leg_s": dict(self.leg_s), **extra}


def device_parser(description: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--json", action="store_true",
                    help="print the verdict as one JSON line")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where to train and serve (default cuda; cpu only "
                         "when asked)")
    return ap


def resolve_device(device: str) -> Optional[str]:
    """``device``, or None after a message when ``cuda`` is asked for and
    there is no card."""
    import torch
    if device == "cuda" and not torch.cuda.is_available():
        print("error: --device cuda but torch.cuda.is_available() is False;"
              " pass --device cpu to run on the CPU", file=sys.stderr)
        return None
    return device


def k1_launches() -> int:
    """K1's launches so far in this process (``ops/hist_wave.py``)."""
    from ..ops import hist_wave
    return int(hist_wave.hist_wave.launches)


def emit(record: Dict[str, Any], as_json: bool) -> int:
    """Print the verdict (a summary line first unless ``as_json``; the
    JSON line last); the exit code: 0 when every check held."""
    if not as_json:
        checks = record["checks"]
        k1 = record.get("k1_launches")
        print(f"# {record['kind']}: {sum(checks.values())}/{len(checks)} "
              f"checks passed ({record['wall_s']} s"
              + ("" if k1 is None else f", K1 launches {k1}") + ")",
              flush=True)
    print(json.dumps(record, default=str), flush=True)
    return 0 if record["ok"] else 1


def post(url: str, payload: Dict[str, Any], timeout: float = 120):
    """``(status, JSON body, headers)`` of a JSON POST (raises
    ``urllib.error.HTTPError`` for a 4xx/5xx answer)."""
    import urllib.request
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, json.loads(resp.read()), dict(resp.headers)


def fetch(url: str, timeout: float = 3.0) -> bytes:
    """The body of a GET."""
    import urllib.request
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.read()


def get(url: str, timeout: float = 30):
    """``(status, JSON body)`` of a GET."""
    import urllib.request
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.status, json.loads(resp.read())


def write_round(record: Dict[str, Any], out_dir: str, prefix: str) -> str:
    """``record`` as ``<out_dir>/<prefix>_rNN.json``, N the next free
    round; returns the path."""
    import glob
    import os
    import re
    n = 0
    for f in glob.glob(os.path.join(out_dir, f"{prefix}_r*.json")):
        m = re.search(rf"{prefix}_r(\d+)\.json$", os.path.basename(f))
        if m:
            n = max(n, int(m.group(1)))
    path = os.path.join(out_dir, f"{prefix}_r{n + 1:02d}.json")
    with open(path, "w") as fh:
        json.dump(record, fh, indent=1)
    print(f"# wrote {path}", flush=True)
    return path


def tree_text(text: str) -> str:
    """A model text's trees: everything before its parameter block."""
    return text.split("\nparameters:")[0]


def declared_checks(path: str):
    """The check names a tool's source declares, read with ``ast`` (the
    module is not imported): ``(names, patterns)``.  Names are the string
    literals that are the first argument of a ``check(...)`` or
    ``CHECKS.setdefault(...)`` call, or the key of a ``checks["..."] = ``
    assignment; an f-string first argument becomes a regular expression
    with each replacement field as ``.+``."""
    import ast
    import re
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    names, patterns = set(), set()

    def take(node):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            names.add(node.value)
        elif isinstance(node, ast.JoinedStr):
            patterns.add("".join(
                re.escape(part.value) if isinstance(part, ast.Constant)
                else ".+" for part in node.values))

    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and node.args:
            fn = node.func
            called = (fn.id if isinstance(fn, ast.Name) else
                      fn.attr if isinstance(fn, ast.Attribute) else "")
            if called == "check" or (
                    called == "setdefault" and isinstance(fn.value, ast.Name)
                    and fn.value.id == "CHECKS"):
                take(node.args[0])
        elif isinstance(node, ast.Assign):
            for tgt in node.targets:
                if (isinstance(tgt, ast.Subscript)
                        and isinstance(tgt.value, ast.Name)
                        and tgt.value.id.lower() == "checks"):
                    take(tgt.slice)
    return names, patterns
