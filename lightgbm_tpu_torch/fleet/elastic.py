"""One rank of the elastic fleet: ingest a shard, assemble, train, and
survive the fleet changing size (counterpart of
lightgbm_tpu/fleet/elastic.py).

Host transport (replicate mode): every rank streams the same input file
but bins only its row shard (``ingest/stream.py`` with a query-aligned
``RowShardPlan``); one ``assemble`` gather swaps the binned shards, so
every rank holds the identical whole dataset and trains a full replica
with the serial tree learner, on its device.  The model does not depend
on the world size: a fleet of 3, one shrunk to 2 mid-run and one process
grow byte-equal trees, which lets recovery promise exactness.

Failures, on the ``robust/`` checkpoint stack:

- a peer dies (``FleetPeerLost`` out of a gather): the survivors agree on
  the newest common checkpoint, trim to it
  (``CheckpointManager.trim_to``), meet in the resize barrier, re-ingest
  their new shards and resume through the engine's auto-resume;
- a healed rank waits to join (``FleetResize`` out of the heartbeat): the
  same rollback, and the joiner fetches the common checkpoint from rank
  0 first;
- the coordinator dies (``FleetCoordinatorLost``): no recovery is
  possible; flight dump and exit 143, never a hang.

Device transport (``tpu_fleet_transport=jax``, the JAX package's name for
it, or ``auto`` where CUDA is present): the ranks form a
``torch.distributed`` group over the same rendezvous file, ingest their
shards, swap them in one all-gather (the port's learners across ranks
hold every row on every rank, ``parallel/mesh.py``) and train with the
data-parallel learner (``tree_learner=data``): each rank histograms its
block of the rows with K1 and the histograms are summed across ranks.
It has no hub and no recovery, as in the JAX package.

Each rank writes ``<fleet_dir>/rank<N>.stats.json``: its start-up and
ingest seconds, the seconds of each iteration and the hand kernels'
launches.
"""
from __future__ import annotations

import copy
import json
import os
import sys
import time
from typing import Dict, List, Optional

import numpy as np

from ..utils import log
from .health import FleetSession, make_heartbeat, newest_ckpt_iter
from .launch import (EVENTS, FleetSettings, device_collective_support,
                     resolve_fleet, run_done, wait_rendezvous, write_done,
                     write_rendezvous)
from .transport import (FleetClient, FleetCoordinatorLost, FleetError,
                        FleetHub, FleetPeerLost, FleetResize,
                        HostCollectives)


class _RankClock:
    """An after-iteration callback keeping each iteration's seconds, and
    the rank's start-up and ingest seconds, for ``rank<N>.stats.json``."""

    order = 34                       # just before the heartbeat
    before_iteration = False
    skip_on_resume = True

    def __init__(self):
        spawn = os.environ.get("LGBM_TPU_FLEET_SPAWN_T", "")
        self.spawn_t = float(spawn) if spawn else time.time()
        self.startup_s: Optional[float] = None
        self.ingest_s = 0.0
        self.iter_s: List[float] = []
        self._t = None

    def started(self) -> None:
        self.startup_s = time.time() - self.spawn_t

    def start_training(self) -> None:
        self._t = time.perf_counter()

    def __call__(self, env) -> None:
        now = time.perf_counter()
        if self._t is not None:
            self.iter_s.append(now - self._t)
        self._t = now

    def write(self, fleet_dir: str, mid: int, **extra) -> None:
        from ..ops import hist_channels, hist_wave
        rec = {"member": int(mid), "startup_s": self.startup_s,
               "ingest_s": self.ingest_s, "iter_s": self.iter_s,
               "k1_launches": int(hist_wave.hist_wave.launches),
               "k2_launches": int(hist_channels.hist_channels.launches),
               **extra}
        path = os.path.join(fleet_dir, f"rank{mid}.stats.json")
        tmp = path + f".tmp-{os.getpid()}"
        with open(tmp, "w") as fh:
            json.dump(rec, fh)
        os.replace(tmp, path)


def _start_device(cfg, mid: int) -> str:
    """This rank's device, its context created now (a rank that cannot
    reach the card fails here: it never trains on the CPU)."""
    import torch

    from ..basic import resolve_device
    dev = resolve_device(cfg.device_type)
    if dev.type == "cuda":
        dev = torch.device("cuda", mid % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        torch.zeros(1, device=dev)
    return str(dev)


def run_rank(argv: Optional[List[str]] = None) -> int:
    """``python -m lightgbm_tpu_torch.fleet <key=value ...>``: one rank."""
    from ..app import _parse_args
    from ..config import Config

    argv = sys.argv[1:] if argv is None else argv
    params = _parse_args(argv)
    cfg = Config.from_params(params)
    if cfg.tpu_telemetry:
        from .. import obs
        obs.enable(cfg.tpu_telemetry)
    fs = resolve_fleet(cfg)
    mid = int(os.environ.get("LGBM_TPU_FLEET_RANK", "0") or 0)
    join = bool(os.environ.get("LGBM_TPU_FLEET_JOIN", "").strip())
    transport = fs.transport
    if transport == "auto":
        transport = "jax" if device_collective_support() else "host"
    log.info("fleet: rank %d starting (world %d, transport %s%s)",
             mid, fs.world, "device" if transport == "jax" else transport,
             ", joiner" if join else "")
    clock = _RankClock()
    if transport == "jax":
        if join:
            log.warning("fleet: the device transport takes no joiners "
                        "(its group is fixed at start); rank %d exits", mid)
            return 1
        return _run_device_rank(cfg, params, fs, mid, clock)
    return run_host_rank(cfg, params, fs, mid, join=join, clock=clock)


# ---------------------------------------------------------------------------
# the dataset: sharded ingest, then the shards swapped
# ---------------------------------------------------------------------------

def _cat(parts: List[Optional[np.ndarray]]) -> Optional[np.ndarray]:
    if all(p is None for p in parts):
        return None
    if any(p is None for p in parts):
        raise FleetError("fleet: ranks disagree on metadata sidecars "
                         "(some shards carry weights/queries, some not)")
    return (np.asarray(parts[0]) if len(parts) == 1
            else np.concatenate([np.asarray(p) for p in parts]))


def _shard_payload(handle, label, weight, group) -> dict:
    lo, hi = getattr(handle, "ingest_row_range", (0, handle.num_data))
    return {
        "lo": int(lo), "hi": int(hi),
        "rows": int(getattr(handle, "ingest_num_rows", handle.num_data)),
        "xbin": np.ascontiguousarray(handle.X_bin),
        "label": None if label is None else np.asarray(label),
        "weight": None if weight is None else np.asarray(weight),
        "qsizes": None if group is None else np.asarray(group),
    }


def _whole(handle, parts):
    """The whole dataset from every shard's payload, in shard order (the
    mappers are one: every rank sampled the same whole stream).  Returns
    ``(full_handle, label, weight, group)``."""
    from ..io.dataset import BinnedDataset

    n_global = int(parts[0]["rows"])
    covered = sum(int(p["hi"]) - int(p["lo"]) for p in parts)
    if (covered != n_global or int(parts[0]["lo"]) != 0
            or any(int(a["hi"]) != int(b["lo"])
                   for a, b in zip(parts, parts[1:]))):
        raise FleetError(
            f"fleet: assembled shards cover {covered} of {n_global} rows "
            f"(ranges {[(int(p['lo']), int(p['hi'])) for p in parts]})")
    full = BinnedDataset._like(handle, n_global, handle.num_total_features)
    full.X_bin = (parts[0]["xbin"] if len(parts) == 1 else
                  np.concatenate([p["xbin"] for p in parts], axis=0))
    label_f = _cat([p["label"] for p in parts])
    weight_f = _cat([p["weight"] for p in parts])
    group_f = _cat([p["qsizes"] for p in parts])
    if label_f is not None:
        full.metadata.set_label(label_f)
    if weight_f is not None:
        full.metadata.set_weights(weight_f)
    if group_f is not None:
        full.metadata.set_query(group_f)
    full.ingest_row_range = (0, n_global)
    full.ingest_num_rows = n_global
    return full, label_f, weight_f, group_f


def _assemble(client: FleetClient, handle, label, weight, group):
    """The binned-shard swap over the hub: every rank sends its
    ``[lo, hi)`` rows and leaves with the whole dataset."""
    payload = _shard_payload(handle, label, weight, group)
    parts = ([payload] if client.world <= 1
             else client.gather("assemble", payload)[0])
    return _whole(handle, parts)


def _assemble_group(handle, label, weight, group):
    """The same swap as one all-gather of the process group (gloo)."""
    import torch.distributed as dist

    from ..parallel import distributed
    payload = _shard_payload(handle, label, weight, group)
    parts = [None] * distributed.world_size()
    dist.all_gather_object(parts, payload)
    return _whole(handle, parts)


def _sharded_ingest(cfg, world: int, shard: int, clock: _RankClock):
    """This rank's shard of ``cfg.data`` through ``ingest/``."""
    from ..basic import parse_categorical_spec
    from ..ingest.stream import ingest_file
    icfg = copy.copy(cfg)
    icfg.tpu_ingest = True
    icfg.tpu_ingest_shards = int(world)
    icfg.tpu_ingest_shard_id = int(shard)
    t0 = time.perf_counter()
    out = ingest_file(cfg.data, icfg, categorical_features=
                      parse_categorical_spec(cfg.categorical_feature))
    clock.ingest_s += time.perf_counter() - t0
    return out


def _train_params(params: Dict[str, str], **over) -> Dict:
    """The booster's parameters: the same on every rank and those of a
    fleet-less run.  Fleet, launcher and shard keys are dropped (not
    zeroed), so the model file does not tell the world size."""
    tp = dict(params)
    for k in list(tp):
        if (k.startswith("tpu_fleet")
                or k in ("task", "tpu_ingest_shards", "tpu_ingest_shard_id",
                         "num_machines", "num_machine", "machines",
                         "machine_list_filename", "local_listen_port")):
            tp.pop(k)
    tp.update(over)
    return tp


def _fit(cfg, tp: Dict, full, label, weight, group, names, callbacks,
         collectives=None):
    """Train on the assembled dataset, valid sets loaded whole in its
    bin space."""
    from contextlib import nullcontext

    from .. import callback
    from ..app import _dataset_from_file
    from ..basic import Dataset
    from ..engine import train as train_api
    from ..io.text_loader import load_init_scores

    ds = Dataset(None, params=tp, feature_name=names)
    ds._handle = full
    ds.label, ds.weight, ds.group = label, weight, group
    init_score = load_init_scores(cfg.data, cfg.initscore_filename)
    if init_score is not None:
        ds.set_init_score(init_score)
    vcfg = copy.copy(cfg)
    vcfg.tpu_ingest_shards = 0
    vcfg.tpu_ingest_shard_id = -1
    valid_sets, valid_names = [], []
    with (collectives.pause() if collectives is not None else nullcontext()):
        for i, vpath in enumerate(cfg.valid):
            vinit = (cfg.valid_data_initscores[i]
                     if i < len(cfg.valid_data_initscores) else "")
            valid_sets.append(_dataset_from_file(
                vpath, vcfg, tp, reference=ds, initscore_path=vinit))
            valid_names.append(f"valid_{i + 1}" if len(cfg.valid) > 1
                               else "valid")
    cbs = list(callbacks)
    if cfg.metric_freq > 0 and (valid_sets or cfg.is_provide_training_metric):
        cbs.append(callback.print_evaluation(period=cfg.metric_freq))
    if cfg.is_provide_training_metric:
        valid_sets = [ds] + valid_sets
        valid_names = ["training"] + valid_names
    return train_api(tp, ds, num_boost_round=int(cfg.num_iterations),
                     valid_sets=valid_sets or None,
                     valid_names=valid_names or None,
                     init_model=cfg.input_model or None,
                     early_stopping_rounds=(cfg.early_stopping_round
                                            if cfg.early_stopping_round > 0
                                            else None),
                     verbose_eval=False, callbacks=cbs)


# ---------------------------------------------------------------------------
# device-collective rank
# ---------------------------------------------------------------------------

def _run_device_rank(cfg, params: Dict[str, str], fs: FleetSettings,
                     mid: int, clock: _RankClock) -> int:
    """Bring a ``torch.distributed`` group up over the rendezvous file,
    ingest this rank's shard, swap the shards and train with the
    data-parallel learner."""
    import socket

    from ..parallel import distributed

    fleet_dir = fs.fleet_dir or os.getcwd()
    os.makedirs(fleet_dir, exist_ok=True)
    device = _start_device(cfg, mid)
    clock.started()
    if mid == 0:
        port = fs.port
        if not port:
            s = socket.socket()
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
            s.close()
        write_rendezvous(fleet_dir, ("127.0.0.1", port), fs.world)
    else:
        _, port = wait_rendezvous(
            fleet_dir, timeout=max(2.0 * fs.heartbeat_s, 60.0))
    distributed.init_distributed(
        num_machines=fs.world, rank=mid,
        init_method=f"tcp://127.0.0.1:{port}",
        time_out=max(int(cfg.time_out), 1))
    try:
        handle, label, weight, group, names = _sharded_ingest(
            cfg, fs.world, mid, clock)
        full, label_f, weight_f, group_f = _assemble_group(
            handle, label, weight, group)
        learner = (cfg.tree_learner if cfg.tree_learner != "serial"
                   else "data")
        tp = _train_params(params, tree_learner=learner)
        clock.start_training()
        bst = _fit(cfg, tp, full, label_f, weight_f, group_f, names,
                   [clock])
        bst.save_model(f"{cfg.output_model}.rank{mid}")
        if mid == 0:
            bst.save_model(cfg.output_model)
        clock.write(fleet_dir, mid, shard=mid, world=fs.world,
                    transport="device", device=device,
                    backend=distributed.device_backend(device))
        log.info("fleet: rank %d finished training (device transport); "
                 "model saved to %s", mid, cfg.output_model)
    finally:
        distributed.shutdown()
    return 0


# ---------------------------------------------------------------------------
# host-transport rank
# ---------------------------------------------------------------------------

def run_host_rank(cfg, params: Dict[str, str], fs: FleetSettings,
                  mid: int, join: bool = False,
                  clock: Optional[_RankClock] = None) -> int:
    """One rank of the host-TCP fleet: rendezvous, the epoch loop and
    elastic recovery; returns the exit code."""
    from .. import obs
    from ..parallel.distributed import set_host_collectives

    clock = clock or _RankClock()
    fleet_dir = fs.fleet_dir
    if not fleet_dir:
        log.fatal("fleet: the host transport needs tpu_fleet_dir "
                  "(the gang launcher always sets it)")
    os.makedirs(fleet_dir, exist_ok=True)
    base_ckpt = cfg.tpu_checkpoint_dir or os.path.join(fleet_dir, "ckpt")
    device = _start_device(cfg, mid)
    clock.started()

    hub = None
    if mid == 0 and not join:
        # the hub lives in this rank: "coordinator killed" and "rank 0
        # killed" are one failure, and its checkpoints serve joiners
        rank_ckpt = os.path.join(base_ckpt, "rank0")
        os.makedirs(rank_ckpt, exist_ok=True)
        hub = FleetHub(fs.world, heartbeat_s=fs.heartbeat_s, port=fs.port,
                       ckpt_dir=rank_ckpt,
                       events_path=os.path.join(fleet_dir, EVENTS))
        addr = hub.start()
        write_rendezvous(fleet_dir, addr, fs.world)
    else:
        if join and run_done(fleet_dir):
            log.info("fleet: run already completed before this healed "
                     "rank came up; nothing to rejoin")
            return 0
        addr = wait_rendezvous(
            fleet_dir, timeout=max(2.0 * fs.heartbeat_s, 60.0))

    deadline = time.time() + max(2.0 * fs.heartbeat_s, 60.0)
    client = None
    while client is None:
        try:
            # a joiner connects in short bursts and looks for the done
            # marker between them: a run that ended while it started must
            # not be retried into a grace kill
            client = FleetClient(addr, mid, heartbeat_s=fs.heartbeat_s,
                                 join=join,
                                 connect_timeout=2.0 if join else 60.0)
        except FleetCoordinatorLost as exc:
            if join and run_done(fleet_dir):
                log.info("fleet: run completed while this healed rank "
                         "was starting; exiting clean")
                return 0
            if time.time() >= deadline:
                log.warning("%s", exc)
                return 143
    mid = client.mid                 # the hub gives a joiner a fresh id
    rank_ckpt = os.path.join(base_ckpt, f"rank{mid}")
    os.makedirs(rank_ckpt, exist_ok=True)
    collectives = HostCollectives(client)
    set_host_collectives(collectives)
    session = FleetSession(client, collectives, fs, rank_ckpt, hub=hub)

    rc = 0
    try:
        try:
            if client.pending:
                # a joiner meets the survivors in the resize barrier and
                # pulls the common checkpoint before it trains
                rep = client.resize()
                if rep.get("done"):
                    log.info("fleet: run completed while this healed "
                             "rank waited to join; exiting clean")
                    client.bye()
                    return 0
                it = client.fetch_checkpoint(rank_ckpt)
                log.info("fleet: joined as shard %d/%d at epoch %d "
                         "(checkpoint iteration %d)", client.shard,
                         client.world, client.epoch, it)
            while True:
                try:
                    session.epoch_runs += 1
                    _train_replica(cfg, params, session, clock)
                    break
                except FleetResize as exc:
                    log.warning("fleet: %s; meeting the resize barrier",
                                exc)
                    _recover(session)
                except FleetPeerLost as exc:
                    session.recoveries += 1
                    survivors = client.world - len(exc.lost)
                    log.warning("fleet: %s; recovery %d (max %d), %d "
                                "survivor(s)", exc, session.recoveries,
                                fs.max_recoveries, survivors)
                    if obs.flight_enabled():
                        obs.flight_dump("fleet_peer_lost")
                    if survivors < fs.min_ranks:
                        log.warning("fleet: %d survivor(s) below "
                                    "tpu_fleet_min_ranks=%d; aborting",
                                    survivors, fs.min_ranks)
                        rc = 1
                        break
                    if session.recoveries > fs.max_recoveries:
                        log.warning("fleet: recovery budget spent "
                                    "(tpu_fleet_max_recoveries=%d); "
                                    "aborting", fs.max_recoveries)
                        rc = 1
                        break
                    _recover(session)
        except FleetCoordinatorLost as exc:
            # no coordinator, no recovery: dump what a post-mortem needs
            # and exit loudly, never hang
            log.warning("fleet: %s; exiting 143", exc)
            if obs.flight_enabled():
                obs.flight_dump("fleet_coordinator_lost")
            raise SystemExit(143)
        clock.write(fleet_dir, mid, shard=client.shard, world=client.world,
                    transport="host", device=device,
                    recoveries=session.recoveries)
        client.bye()
        if hub is not None:
            # the marker before the drain: a joiner still starting finds
            # it instead of a silent socket
            write_done(fleet_dir, rc)
            hub.wait_drain(timeout=max(2.0 * fs.heartbeat_s, 30.0))
            hub.stop()
    finally:
        set_host_collectives(None)
    return rc


def _train_replica(cfg, params: Dict[str, str], session: FleetSession,
                   clock: _RankClock) -> None:
    """One epoch: sharded ingest, the swap, a full-replica training (the
    engine resumes from this rank's newest checkpoint)."""
    client = session.client
    log.info("fleet: epoch %d, ingesting shard %d/%d of %s",
             client.epoch, client.shard, client.world, cfg.data)
    # every rank streams the whole file (its sample is global and one on
    # every rank), so the pooling of pre-sharded samples stands down
    with session.collectives.pause():
        handle, label, weight, group, names = _sharded_ingest(
            cfg, client.world, client.shard, clock)
    full, label_f, weight_f, group_f = _assemble(
        client, handle, label, weight, group)
    # every rank trains the same full replica: the serial learner (the
    # default, so it never shows in the saved parameters)
    tp = _train_params(params, tree_learner="serial",
                       tpu_checkpoint_dir=session.ckpt_dir)
    clock.start_training()
    bst = _fit(cfg, tp, full, label_f, weight_f, group_f, names,
               [clock, make_heartbeat(session, cfg)],
               collectives=session.collectives)
    # every rank writes its copy (the witnesses of exactness); shard 0
    # owns the canonical path
    bst.save_model(f"{cfg.output_model}.rank{client.mid}")
    if client.shard == 0:
        bst.save_model(cfg.output_model)
    log.info("fleet: rank %d (shard %d) finished training; model saved "
             "to %s", client.mid, client.shard, cfg.output_model)


def _recover(session: FleetSession) -> int:
    """Coordinated rollback: the survivors agree on the newest common
    checkpoint, trim to it and meet (with any joiner) in the resize
    barrier.  Returns the iteration every rank resumes from."""
    from .. import obs
    from ..robust.checkpoint import CheckpointManager

    client = session.client
    parts, _ = client.gather("recover_ckpt",
                             {"ckpt_iter": newest_ckpt_iter(session.ckpt_dir)},
                             phase="recover")
    common = min(int(p["ckpt_iter"]) for p in parts)
    CheckpointManager(session.ckpt_dir).trim_to(common)
    if session.hub is not None:
        # what a joiner's fetch serves, stamped before the barrier
        session.hub.serve_iteration = common
    client.resize()
    log.warning("fleet: recovered, rolled back to iteration %d, resuming "
                "as shard %d/%d (epoch %d)", common, client.shard,
                client.world, client.epoch)
    obs.event("fleet_recover", iteration=int(common),
              world=int(client.world), epoch=int(client.epoch),
              member=int(client.mid))
    return common
