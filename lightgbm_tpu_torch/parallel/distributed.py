"""Process bootstrap and the host collectives (counterpart of
lightgbm_tpu/parallel/distributed.py, ``torch.distributed`` in jax's
place).

The reference brings up its own TCP mesh (reference:
src/network/network.cpp:24-74 Network::Init, linkers.cpp).  Here every
rank is one process: ``init_distributed`` gives
``torch.distributed.init_process_group`` the address of the machine
list's first entry, the world size and this process's rank, and the
tree learners of ``parallel/mesh.py`` run their collectives in that
group.  Config mapping (reference: config.h "Network Parameters"):

- ``machines`` ("ip1:port1,ip2:port2,...") or ``machine_list_filename``
  (one host per line, "ip port" or "ip:port"): the FIRST entry is the
  rendezvous (``tcp://ip1:port1``), as rank 0 is the reference's;
- ``num_machines``: the world size; it must equal the list's length;
- ``local_listen_port``: the port of an entry that names none;
- ``time_out``: minutes (config.h:845), the group's time-out.

The rank comes from ``set_network``'s record, ``LGBM_TPU_RANK`` or
``RANK``, else from this host's address in the machine list.  With no
machine list, ``WORLD_SIZE`` > 1 in the environment takes torch's own
``env://`` rendezvous (``MASTER_ADDR``/``MASTER_PORT``); tests pass
``init_method="file://..."``.

Backends.  The default group is gloo: the host collectives (bin-sample
pooling, the divergence audit's stats) and every CPU run use it.  On the
card the tree learners' collectives take NCCL when each rank has its own
card, and gloo when two ranks share one (found at the first
``device_group`` call by an all-gather of the ranks' device UUIDs): NCCL
refuses two ranks on one GPU.  A gloo collective of a CUDA tensor copies
it to the host and back, explicitly, in ``parallel/mesh.py``.

``set_host_collectives`` / ``host_collectives`` keep the JAX package's
interface for a host transport (the fleet's); with one installed, the
host collectives here ride its ``allgather``.
"""
from __future__ import annotations

import datetime
import os
import socket
from typing import List, Optional

import numpy as np

from ..utils import log
from . import mesh as _mesh

_initialized = False        # this module brought the group up
_HOST_COLLECTIVES = None
# device -> the process group of the tree learners' collectives on it
# (None: the default gloo group)
_device_groups: dict = {}


def set_host_collectives(handle) -> None:
    """Install (or clear, with None) a host-collective backend.  The
    handle needs ``world_size``/``rank`` properties, ``active()`` and
    ``allgather(arr) -> [world, *arr.shape]`` in rank order."""
    global _HOST_COLLECTIVES
    _HOST_COLLECTIVES = handle


def host_collectives():
    """The ACTIVE host-collective backend, or None."""
    h = _HOST_COLLECTIVES
    if h is not None and h.active():
        return h
    return None


def _dist():
    import torch.distributed as dist
    return dist if dist.is_available() else None


def _group_up() -> bool:
    dist = _dist()
    return dist is not None and dist.is_initialized()


def world_size() -> int:
    """Ranks of whichever runtime is up: the host transport's world when
    installed, else the process group's; 1 in a single process."""
    h = host_collectives()
    if h is not None:
        return int(h.world_size)
    return int(_dist().get_world_size()) if _group_up() else 1


def rank() -> int:
    h = host_collectives()
    if h is not None:
        return int(h.rank)
    return int(_dist().get_rank()) if _group_up() else 0


def parse_machine_list(machines: str = "",
                       machine_list_filename: str = "",
                       default_port: int = 12400) -> List[str]:
    """Both machine-list forms as ["host:port", ...] (reference:
    Network::Init's two sources, config.h machines /
    machine_list_filename)."""
    entries: List[str] = []
    if machines:
        entries = [tok.strip() for tok in machines.replace("\n", ",").split(",")
                   if tok.strip()]
    elif machine_list_filename:
        if not os.path.exists(machine_list_filename):
            log.fatal(f"Machine list file {machine_list_filename} "
                      "does not exist")
        with open(machine_list_filename) as fh:
            entries = [ln.strip().replace(" ", ":") for ln in fh
                       if ln.strip()]
    return [e if ":" in e else f"{e}:{default_port}" for e in entries]


def process_id(hosts=()) -> Optional[int]:
    """This process's rank, or None when nothing names it.  Order: the
    rank recorded by ``set_network``, ``LGBM_TPU_RANK``, ``RANK``, then
    this host's addresses in the machine list (the reference finds the
    local machine in the list, network.cpp:50-60)."""
    if _mesh.NETWORK.get("rank"):
        return int(_mesh.NETWORK["rank"])
    for var in ("LGBM_TPU_RANK", "RANK"):
        if os.environ.get(var):
            return int(os.environ[var])
    if hosts:
        local = {socket.gethostname()}
        try:
            name, aliases, addrs = socket.gethostbyname_ex(
                socket.gethostname())
            local |= {name, *aliases, *addrs, "localhost", "127.0.0.1"}
        except OSError:
            pass
        for i, h in enumerate(hosts):
            if h.rsplit(":", 1)[0] in local:
                return i
    return None


def init_distributed(config=None, *, machines: str = "",
                     machine_list_filename: str = "",
                     num_machines: int = 1,
                     local_listen_port: int = 12400,
                     rank: Optional[int] = None,
                     time_out: Optional[int] = None,
                     init_method: Optional[str] = None) -> bool:
    """Bring up the process group; True when running distributed.

    Call on EVERY rank before training (the script runs once a rank,
    like the reference CLI under mpirun).  A single-machine setting
    returns False and touches nothing.  Idempotent: a group already up
    (this call's or the caller's own ``init_process_group``) is kept."""
    global _initialized
    if config is not None:
        machines = machines or getattr(config, "machines", "")
        machine_list_filename = (machine_list_filename
                                 or getattr(config, "machine_list_filename",
                                            ""))
        num_machines = max(num_machines,
                           int(getattr(config, "num_machines", 1)))
        local_listen_port = int(getattr(config, "local_listen_port",
                                        local_listen_port))
        if time_out is None:
            time_out = int(getattr(config, "time_out", 120))
    hosts = parse_machine_list(machines, machine_list_filename,
                               local_listen_port)
    env_world = int(os.environ.get("WORLD_SIZE", "1") or 1)
    if (num_machines <= 1 and len(hosts) <= 1 and init_method is None
            and env_world <= 1):
        return False
    if hosts and num_machines > 1 and len(hosts) != num_machines:
        log.fatal(f"num_machines={num_machines} but the machine list has "
                  f"{len(hosts)} entries")
    num_machines = max(num_machines, len(hosts), env_world)
    if _group_up():
        _record(hosts, local_listen_port)
        return True
    pid = process_id(hosts) if rank is None else int(rank)
    if pid is None:
        log.fatal("cannot tell this process's rank: set LGBM_TPU_RANK or "
                  "RANK, or run on a host named in the machine list")
    if init_method is None:
        init_method = f"tcp://{hosts[0]}" if hosts else "env://"
    log.info("Initializing the process group: %d ranks, rank %d, %s",
             num_machines, pid, init_method)
    _dist().init_process_group(
        "gloo", init_method=init_method, world_size=num_machines, rank=pid,
        timeout=datetime.timedelta(minutes=int(time_out or 120)))
    _initialized = True
    _record(hosts, local_listen_port)
    return True


def _record(hosts, local_listen_port) -> None:
    _mesh.NETWORK.update(machines=",".join(hosts),
                         num_machines=world_size(), rank=rank(),
                         local_listen_port=int(local_listen_port))


def _device_uuid(device) -> str:
    import torch
    props = torch.cuda.get_device_properties(device)
    uid = getattr(props, "uuid", None)
    return (str(uid) if uid is not None
            else f"{socket.gethostname()}:{props.name}:{device.index}")


def device_group(device):
    """The process group of the tree learners' collectives on ``device``
    (None: the default gloo group).  On the card: a new NCCL group when
    every rank's card differs, else None (two ranks on one card).
    Collective: every rank calls it, in the same order."""
    import torch
    device = torch.device(device)
    if device.type != "cuda" or not _group_up() or world_size() <= 1:
        return None
    key = str(device)
    if key not in _device_groups:
        dist = _dist()
        uuids = [None] * world_size()
        dist.all_gather_object(uuids, _device_uuid(device))
        shared = len(set(uuids)) < len(uuids)
        group = None
        if not shared and dist.is_nccl_available():
            group = dist.new_group(backend="nccl")
        log.info("tree learner collectives on %s: %s", key,
                 "nccl" if group is not None else
                 "gloo (ranks share a card)" if shared else "gloo")
        _device_groups[key] = group
    return _device_groups[key]


def device_backend(device) -> str:
    """"nccl" or "gloo": the backend ``device_group`` chose."""
    return "nccl" if device_group(device) is not None else "gloo"


def shutdown() -> None:
    """Network::Dispose (reference: network.cpp:76-84): the group this
    module brought up is destroyed; the topology record is reset."""
    global _initialized
    if _initialized and _group_up():
        _dist().destroy_process_group()
    _initialized = False
    _device_groups.clear()
    _mesh.NETWORK.update(machines="", num_machines=1, rank=0)


def _runtime_active() -> bool:
    return host_collectives() is not None or _group_up()


def _allgather_exact(arr) -> np.ndarray:
    """All ranks' ``arr`` (equal shapes), bit-exact, with a leading rank
    axis: through the host transport when installed, else a gloo
    all-gather of a CPU tensor (any width travels as it is)."""
    import torch

    from .. import obs
    from ..robust import faults

    a = np.ascontiguousarray(arr)
    # the fault point of a cross-rank gather (robust/faults.py)
    faults.check("collective")
    host = host_collectives()
    if host is not None:
        g = host.allgather(a)
        obs.record_collective_host("host_allgather", g.nbytes)
        return g
    t = torch.from_numpy(a.copy())
    out = [torch.empty_like(t) for _ in range(world_size())]
    _dist().all_gather(out, t)
    g = np.stack([o.numpy() for o in out])
    obs.record_collective_host("process_allgather", g.nbytes)
    return g


def global_bin_sample(sample, num_local_rows=None):
    """Distributed bin finding: every rank's bin-finding sample pooled, so
    each derives the same mappers (the reference syncs bin bounds over
    Network::Allgather, dataset_loader.cpp:807-1042).  Returns
    ``(pooled_sample, global_num_rows)``; the identity outside a
    multi-rank runtime.  Unequal sample sizes are padded to the largest
    and cut back after the gather."""
    if num_local_rows is None:
        num_local_rows = len(sample)
    if not _runtime_active() or world_size() <= 1:
        return sample, int(num_local_rows)
    n, f = sample.shape
    counts = _allgather_exact(
        np.asarray([n, int(num_local_rows)], np.int64)).reshape(-1, 2)
    m = int(counts[:, 0].max())
    dt = (sample.dtype if np.issubdtype(sample.dtype, np.floating)
          else np.float64)
    padded = np.full((m, f), np.nan, dtype=dt)
    padded[:n] = sample
    gathered = _allgather_exact(padded).reshape(len(counts), m, f)
    pooled = np.concatenate([gathered[p, :counts[p, 0]]
                             for p in range(len(counts))])
    return pooled.astype(sample.dtype), int(counts[:, 1].sum())


def global_bin_sample_sparse(sample_csc, num_local_rows: int):
    """Sparse ``global_bin_sample``: every rank's sample pooled as COO
    triplets (rows offset by the ranks before it).  Returns
    ``(pooled_csc, global_num_rows)``."""
    if not _runtime_active() or world_size() <= 1:
        return sample_csc, int(num_local_rows)
    import scipy.sparse as sp

    coo = sample_csc.tocoo()
    n, f = coo.shape
    meta = _allgather_exact(np.asarray(
        [n, coo.nnz, int(num_local_rows), f], np.int64)).reshape(-1, 4)
    log.check(int(meta[:, 3].max()) == int(meta[:, 3].min()),
              "ranks disagree on the sparse sample's feature count")
    m = int(meta[:, 1].max())
    buf = np.zeros((3, m), np.float64)
    buf[0, :coo.nnz] = coo.row
    buf[1, :coo.nnz] = coo.col
    buf[2, :coo.nnz] = coo.data
    g = _allgather_exact(buf).reshape(len(meta), 3, m)
    row_off = np.concatenate([[0], np.cumsum(meta[:-1, 0])])
    rows, cols, vals = [], [], []
    for p in range(len(meta)):
        k = int(meta[p, 1])
        rows.append(g[p, 0, :k].astype(np.int64) + row_off[p])
        cols.append(g[p, 1, :k].astype(np.int64))
        vals.append(g[p, 2, :k])
    pooled = sp.coo_matrix(
        (np.concatenate(vals),
         (np.concatenate(rows), np.concatenate(cols))),
        shape=(int(meta[:, 0].sum()), f)).tocsc()
    return pooled, int(meta[:, 2].sum())


def rank_allgather_stats(vec):
    """One small f64 stats vector from every rank, bit-exact:
    ``[world, len(vec)]`` in rank order (the divergence audit's
    collective, obs/health.py); None in a single process."""
    if not _runtime_active() or world_size() <= 1:
        return None
    v = np.ascontiguousarray(np.asarray(vec, np.float64).reshape(-1))
    return _allgather_exact(v).reshape(world_size(), -1)


def train_stats_exchange(vec):
    """The straggler detector's per-iteration exchange (obs/ranks.py):
    ``rank_allgather_stats`` on the fingerprint cadence; None in a single
    process."""
    return rank_allgather_stats(vec)
