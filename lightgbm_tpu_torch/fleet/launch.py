"""Gang launcher and rendezvous of the elastic training fleet
(counterpart of lightgbm_tpu/fleet/launch.py).

``task=train tpu_fleet=N`` in the CLI (``app.py``) comes here: the
launcher builds the CUDA kernels once (so that no two ranks build into
``build/`` together), spawns N ranks (``python -m
lightgbm_tpu_torch.fleet <the same key=value pairs>``), watches them and,
with ``tpu_fleet_heal``, starts a lost rank again as a joiner that the
survivors take in at their next resize.  Rendezvous is a file, then TCP:
rank 0 starts the hub (``fleet/transport.FleetHub``) on a free port and
writes ``<fleet_dir>/rendezvous.json`` atomically; the other ranks poll
the file and connect (the reference reads a machine list instead,
network.cpp:24-74; here the list is found, so a joiner needs no edits).

``LGBM_TPU_FLEET_*`` variables win over the config knobs;
``LGBM_TPU_FLEET_RANK`` stamps a spawned rank and keeps it from
launching a fleet of its own.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass
from typing import Dict, Optional

from ..utils import log

RENDEZVOUS = "rendezvous.json"
EVENTS = "fleet_events.jsonl"
DONE = "done.json"


def write_done(fleet_dir: str, rc: int = 0) -> None:
    """The completion marker: a healed joiner that arrives after the
    fleet finished finds it and exits clean instead of retrying a hub
    that is gone."""
    path = os.path.join(fleet_dir, DONE)
    tmp = path + f".tmp-{os.getpid()}"
    with open(tmp, "w") as fh:
        json.dump({"rc": int(rc), "t": round(time.time(), 3)}, fh)
    os.replace(tmp, path)


def run_done(fleet_dir: str) -> bool:
    return os.path.exists(os.path.join(fleet_dir, DONE))


@dataclass
class FleetSettings:
    world: int
    heartbeat_s: float
    transport: str
    fleet_dir: str
    port: int
    min_ranks: int
    heal: bool
    max_recoveries: int


def _env_float(name: str, fallback: float) -> float:
    v = os.environ.get(name, "").strip()
    try:
        return float(v) if v else fallback
    except ValueError:
        log.warning("ignoring non-numeric %s=%r", name, v)
        return fallback


def _env_int(name: str, fallback: int) -> int:
    v = os.environ.get(name, "").strip()
    try:
        return int(v) if v else fallback
    except ValueError:
        log.warning("ignoring non-numeric %s=%r", name, v)
        return fallback


def resolve_fleet(config) -> FleetSettings:
    """The fleet's settings: ``LGBM_TPU_FLEET_*`` over ``tpu_fleet_*``."""
    transport = (os.environ.get("LGBM_TPU_FLEET_TRANSPORT", "").strip()
                 or str(getattr(config, "tpu_fleet_transport", "auto")))
    if transport not in ("auto", "jax", "host"):
        log.warning("unknown fleet transport %r; using auto", transport)
        transport = "auto"
    return FleetSettings(
        world=_env_int("LGBM_TPU_FLEET",
                       int(getattr(config, "tpu_fleet", 0) or 0)),
        heartbeat_s=_env_float(
            "LGBM_TPU_FLEET_HEARTBEAT_S",
            float(getattr(config, "tpu_fleet_heartbeat_s", 30.0))),
        transport=transport,
        fleet_dir=(os.environ.get("LGBM_TPU_FLEET_DIR", "").strip()
                   or str(getattr(config, "tpu_fleet_dir", "") or "")),
        port=int(getattr(config, "tpu_fleet_port", 0) or 0),
        min_ranks=int(getattr(config, "tpu_fleet_min_ranks", 1) or 1),
        heal=bool(getattr(config, "tpu_fleet_heal", True)),
        max_recoveries=int(getattr(config, "tpu_fleet_max_recoveries", 2)),
    )


def device_collective_support() -> bool:
    """Can the ranks run the device-collective transport?  True where
    CUDA is present: the ranks then form a ``torch.distributed`` group
    and train with ``parallel/``'s data-parallel learner (NCCL, or gloo
    with host copies when ranks share a card).  On the CPU it is False,
    as it is for the JAX package's CPU backend, and ``auto`` takes the
    host transport."""
    try:
        import torch
        return bool(torch.cuda.is_available())
    except Exception:  # noqa: BLE001 — no usable torch, no collectives
        return False


def should_gang_launch(config) -> bool:
    """True in the parent invocation of a fleet run: a fleet is asked for
    and this process is not a spawned rank."""
    return (resolve_fleet(config).world > 1
            and not os.environ.get("LGBM_TPU_FLEET_RANK"))


# ---------------------------------------------------------------------------
# rendezvous file
# ---------------------------------------------------------------------------

def write_rendezvous(fleet_dir: str, addr, world: int) -> str:
    path = os.path.join(fleet_dir, RENDEZVOUS)
    tmp = path + f".tmp-{os.getpid()}"
    with open(tmp, "w") as fh:
        json.dump({"addr": [addr[0], int(addr[1])], "world": int(world),
                   "t": round(time.time(), 3)}, fh)
    os.replace(tmp, path)
    return path


def wait_rendezvous(fleet_dir: str, timeout: float = 60.0):
    """Poll for rank 0's rendezvous file; ``(host, port)``."""
    path = os.path.join(fleet_dir, RENDEZVOUS)
    deadline = time.time() + timeout
    while time.time() < deadline:
        try:
            with open(path) as fh:
                rec = json.load(fh)
            return rec["addr"][0], int(rec["addr"][1])
        except (OSError, ValueError, KeyError, IndexError):
            time.sleep(0.05)
    from .transport import FleetCoordinatorLost
    raise FleetCoordinatorLost(
        f"fleet: no rendezvous file at {path} after {timeout:.0f}s")


# ---------------------------------------------------------------------------
# gang launcher
# ---------------------------------------------------------------------------

def _worker_argv(params: Dict[str, str], overrides: Dict[str, str]):
    merged = dict(params)
    merged.update(overrides)
    return [sys.executable, "-m", "lightgbm_tpu_torch.fleet",
            *[f"{k}={v}" for k, v in merged.items()]]


def _build_kernels(config) -> None:
    """Build the CUDA kernels in the launcher, before any rank starts:
    the ranks load the library from ``build/`` and never race to build
    it.  Nothing to do on the CPU."""
    if str(getattr(config, "device_type", "cuda")) == "cpu":
        return
    import torch
    if not torch.cuda.is_available():
        return
    from ..ops import build
    t0 = time.perf_counter()
    lib = build.build()
    log.info("fleet: kernels ready in %.1fs (%s)", time.perf_counter() - t0,
             lib.name)


def launch_fleet(config, params: Dict[str, str],
                 per_rank_env: Optional[Dict[int, Dict[str, str]]] = None,
                 poll_s: float = 0.2) -> dict:
    """Spawn, watch and (optionally) heal an N-rank training fleet.

    Returns ``rc`` (rank 0's exit code), each member's ``rcs``, the
    ``heals`` made, ``fleet_dir`` and ``ok``: rank 0 finished clean and
    every seat was filled in the end by a member that exited 0 (a killed
    rank that was healed does not spoil it).  ``per_rank_env`` adds
    variables by launch id (fault specs)."""
    fs = resolve_fleet(config)
    n = int(fs.world)
    if n <= 1:
        raise ValueError("launch_fleet needs tpu_fleet >= 2")
    fleet_dir = fs.fleet_dir or tempfile.mkdtemp(prefix="lgbm_torch_fleet_")
    os.makedirs(fleet_dir, exist_ok=True)
    for name in (RENDEZVOUS, DONE):
        stale = os.path.join(fleet_dir, name)
        if os.path.exists(stale):
            os.unlink(stale)
    _build_kernels(config)

    overrides = {"tpu_fleet": str(n), "tpu_fleet_dir": fleet_dir,
                 "task": "train"}
    argv = _worker_argv(params, overrides)

    # the ranks import the package by name; where the parent found it on
    # a path of its own rather than an install, they need that root too
    pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    child_pp = os.pathsep.join(
        p for p in [pkg_root, os.environ.get("PYTHONPATH", "")] if p)

    def spawn(mid: int, join: bool):
        env = os.environ.copy()
        env["PYTHONPATH"] = child_pp
        # a rank's log must survive a SIGKILL mid-write
        env["PYTHONUNBUFFERED"] = "1"
        env.update({
            "LGBM_TPU_FLEET": str(n),
            "LGBM_TPU_FLEET_RANK": str(mid),
            "LGBM_TPU_FLEET_DIR": fleet_dir,
            # telemetry and shard identity key off the rank
            "LGBM_TPU_RANK": str(mid),
            "LGBM_TPU_FLEET_JOIN": "1" if join else "",
            # the rank's start-up time is measured from here
            "LGBM_TPU_FLEET_SPAWN_T": repr(time.time()),
        })
        env.update((per_rank_env or {}).get(mid, {}))
        logf = open(os.path.join(fleet_dir, f"rank{mid}.log"), "ab")
        proc = subprocess.Popen(argv, env=env, stdout=logf, stderr=logf)
        logf.close()
        log.info("fleet: %s rank %d (pid %d)",
                 "healed" if join else "launched", mid, proc.pid)
        return proc

    members = {mid: {"proc": spawn(mid, False), "rc": None,
                     "healed_by": None} for mid in range(n)}
    next_mid, heals = n, 0
    rc0 = None
    try:
        while True:
            running = 0
            for mid, m in list(members.items()):
                if m["rc"] is not None:
                    continue
                rc = m["proc"].poll()
                if rc is None:
                    running += 1
                    continue
                m["rc"] = rc
                if mid == 0:
                    rc0 = rc
                elif rc != 0 and rc0 is None:
                    log.warning("fleet: rank %d exited %d", mid, rc)
                    if fs.heal and heals < fs.max_recoveries:
                        heals += 1
                        m["healed_by"] = next_mid
                        members[next_mid] = {"proc": spawn(next_mid, True),
                                             "rc": None, "healed_by": None}
                        next_mid += 1
            if rc0 is not None:
                # the coordinator is done (or dead): a bounded grace for
                # the others to drain, then stop waiting
                deadline = time.time() + max(4.0 * fs.heartbeat_s, 30.0)
                for m in members.values():
                    if m["rc"] is None:
                        try:
                            m["rc"] = m["proc"].wait(
                                timeout=max(deadline - time.time(), 1.0))
                        except subprocess.TimeoutExpired:
                            m["proc"].kill()
                            m["rc"] = m["proc"].wait()
                break
            if running == 0:
                break
            time.sleep(poll_s)
    finally:
        # no rank outlives its launcher
        for m in members.values():
            if m["proc"].poll() is None:
                m["proc"].kill()
                m["rc"] = m["proc"].wait()

    rcs = {mid: m["rc"] for mid, m in members.items()}
    seats_ok = all(
        m["rc"] == 0 or (m["healed_by"] is not None
                         and rcs.get(m["healed_by"]) == 0)
        for m in members.values())
    out = {"rc": int(rc0 or 0), "rcs": rcs, "heals": heals,
           "fleet_dir": fleet_dir, "ok": bool(rc0 == 0 and seats_ok)}
    log.info("fleet: run finished rc=%s heals=%d rcs=%s",
             out["rc"], heals, rcs)
    return out
