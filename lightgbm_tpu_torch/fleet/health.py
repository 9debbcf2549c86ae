"""Fleet liveness on the fingerprint cadence (counterpart of
lightgbm_tpu/fleet/health.py).

The healthy path gets no new sync point: the heartbeat is one gather a
``tpu_fingerprint_freq`` tick, carrying this rank's iteration and newest
checkpoint and bringing back the coordinator's view (each rank's
progress, pending joiners, stall stamps).  The gather's deadline is the
detector: a rank missing from a collective its peers stand in is dead;
one that arrives late inside the deadline is stamped ``fleet_stall``.
(The JAX package also hands ``FleetSession.snapshot`` to its train
board; the port has no board yet, ROADMAP item 8B.)
"""
from __future__ import annotations

import os
import time

from ..utils import log
from .transport import FleetClient, FleetResize

_HB_KEY = "hb"


def newest_ckpt_iter(ckpt_dir: str) -> int:
    """The newest checkpoint iteration under ``ckpt_dir`` (0: none):
    what the heartbeat advertises and recovery takes the minimum of."""
    if not ckpt_dir or not os.path.isdir(ckpt_dir):
        return 0
    from ..robust.checkpoint import _CKPT_RE, CheckpointManager
    newest = CheckpointManager(ckpt_dir).list_checkpoints()
    if not newest:
        return 0
    m = _CKPT_RE.search(os.path.basename(newest[0]))
    return int(m.group(1)) if m else 0


class FleetSession:
    """One rank's fleet state, shared by the heartbeat callback and the
    elastic loop: the client, the host collectives, this rank's
    checkpoint directory and the coordinator's last view."""

    def __init__(self, client: FleetClient, collectives, settings,
                 ckpt_dir: str, hub=None):
        self.client = client
        self.collectives = collectives
        self.settings = settings
        self.ckpt_dir = ckpt_dir
        self.hub = hub                   # rank 0 only
        self.view: dict = {}
        self.recoveries = 0
        self.epoch_runs = 0

    def snapshot(self) -> dict:
        """The fleet as this rank sees it."""
        v = dict(self.view)
        return {
            "world": self.client.world,
            "rank": self.client.shard,
            "member": self.client.mid,
            "epoch": self.client.epoch,
            "recoveries": self.recoveries,
            "dead": v.get("dead", []),
            "pending_join": v.get("pending_join", 0),
            "members": v.get("members", {}),
        }


class FleetHeartbeatCallback:
    """After-iteration callback: the fault hooks and the gather on the
    fingerprint cadence."""

    order = 35                   # after eval recording, before snapshots
    before_iteration = False

    def __init__(self, session: FleetSession, fp_freq: int):
        self.session = session
        # a cadence of 0 would silence liveness: every iteration instead
        self.fp_freq = max(int(fp_freq), 1)

    def __call__(self, env) -> None:
        from ..robust import faults

        it = int(env.iteration) + 1
        # chaos hooks: ``fleet_die`` kills this rank mid-iteration as a
        # preempted host dies (no clean-up, no goodbye); ``fleet_hb``
        # (a sleep) delays its heartbeat into the stall window
        try:
            faults.check("fleet_die", iteration=int(env.iteration))
        except faults.FaultInjected:
            log.warning("fleet: injected death at iteration %d "
                        "(exiting 137)", it)
            os._exit(137)
        faults.check("fleet_hb", iteration=int(env.iteration))

        if it % self.fp_freq != 0:
            return
        s = self.session
        payload = {"iteration": it,
                   "ckpt_iter": newest_ckpt_iter(s.ckpt_dir),
                   "t": round(time.time(), 3)}
        _, view = s.client.gather(_HB_KEY, payload)
        s.view = view
        pending = int(view.get("pending_join", 0) or 0)
        if pending:
            # every live rank sees this view at the same heartbeat, so
            # every rank raises here and meets in the barrier
            raise FleetResize(pending)


def make_heartbeat(session: FleetSession, config) -> FleetHeartbeatCallback:
    return FleetHeartbeatCallback(
        session, int(getattr(config, "tpu_fingerprint_freq", 1) or 1))
