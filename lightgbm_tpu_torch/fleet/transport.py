"""Host-TCP fleet transport: the rendezvous hub and the per-rank client
(counterpart of lightgbm_tpu/fleet/transport.py; the same frames and
ops, so the two packages' tools read each other's event trails).

The reference links its workers pairwise over sockets (reference:
src/network/linkers_socket.cpp, network.cpp Allgather).  Here the links
form a star, because the hub is also the coordinator: the one place that
knows which ranks live, which gather still misses a part, and when a
silent rank crossed the ``tpu_fleet_heartbeat_s`` line.  The hub lives
inside the rank-0 worker, so "coordinator killed" and "rank 0 killed" are
one failure, and rank 0's checkpoint directory serves late joiners.

Wire format: an 8-byte big-endian length, then a pickled dict.  Frames
carry Python scalars, strings and numpy arrays only: a torch tensor is
turned into a host numpy array at the edge (``_to_wire``), so no CUDA
tensor is ever pickled onto the wire.  Ops:

- ``hello``: register (a first rank by its launch id; a joiner gets the
  next free id and waits in ``pending`` until a resize admits it);
- ``gather``: the one collective, which blocks until every live rank
  posted a part for the same ``(epoch, key, seq)`` and replies the parts
  in shard-rank order.  A rank that misses the deadline, or whose socket
  drops, is dead; every rank that arrived gets ``peer_lost`` and raises
  :class:`FleetPeerLost`;
- ``resize``: the epoch barrier: every live rank and pending joiner
  arrives, the hub hands out dense shard ranks (survivors keep their
  order, joiners follow), bumps the epoch and clears the dead-rank debt;
- ``fetch``: a tar of rank 0's rolled-back common checkpoint, for
  joiners;
- ``bye``: a graceful leave (never counted dead).

Liveness is relative: a gather's deadline runs from its first arrival, so
a stall of the whole fleet (slow ingest, CUDA start) kills no one; a rank
late against its peers but inside the deadline is stamped
``fleet_stall``.
"""
from __future__ import annotations

import io
import json
import os
import pickle
import socket
import struct
import tarfile
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..utils import log

_LEN = struct.Struct(">Q")
_MAX_FRAME = 1 << 33            # 8 GiB — bin shards, not arbitrary blobs


# ---------------------------------------------------------------------------
# exceptions
# ---------------------------------------------------------------------------

class FleetError(RuntimeError):
    """Base class for fleet transport failures."""


class FleetPeerLost(FleetError):
    """One or more peer ranks went silent past the heartbeat deadline
    (or dropped their socket).  Survivors catch this and run the
    elastic recovery (fleet/elastic.py)."""

    def __init__(self, lost, detail: str = ""):
        self.lost = sorted(int(r) for r in lost)
        super().__init__(f"fleet: peer rank(s) {self.lost} lost"
                         + (f" ({detail})" if detail else ""))


class FleetCoordinatorLost(FleetError):
    """The hub (rank 0) is unreachable: recovery is impossible — the
    worker flight-dumps and exits loudly (143), never hangs."""


class FleetResize(FleetError):
    """A healed rank is waiting to join: every live rank raises this at
    the same heartbeat and meets in the resize barrier."""

    def __init__(self, pending: int):
        self.pending = int(pending)
        super().__init__(f"fleet: {pending} rank(s) waiting to join")


# ---------------------------------------------------------------------------
# framing
# ---------------------------------------------------------------------------

def _to_wire(obj):
    """``obj`` with every torch tensor replaced by a host numpy array
    (dicts, lists and tuples walked): the frames hold no tensor."""
    if isinstance(obj, dict):
        return {k: _to_wire(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_wire(v) for v in obj)
    if type(obj).__module__.startswith("torch") and hasattr(obj, "detach"):
        return obj.detach().cpu().numpy()
    return obj


def _send_frame(sock: socket.socket, obj) -> None:
    blob = pickle.dumps(_to_wire(obj), protocol=pickle.HIGHEST_PROTOCOL)
    sock.sendall(_LEN.pack(len(blob)) + blob)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(min(n - len(buf), 1 << 20))
        if not chunk:
            raise EOFError("fleet transport: connection closed")
        buf += chunk
    return bytes(buf)


def _recv_frame(sock: socket.socket):
    (n,) = _LEN.unpack(_recv_exact(sock, _LEN.size))
    if n > _MAX_FRAME:
        raise FleetError(f"fleet transport: oversized frame ({n} bytes)")
    return pickle.loads(_recv_exact(sock, n))


# ---------------------------------------------------------------------------
# hub (coordinator, lives in the rank-0 worker)
# ---------------------------------------------------------------------------

class _Gather:
    __slots__ = ("parts", "arrive", "t0", "result", "replies_left")

    def __init__(self):
        self.parts: Dict[int, object] = {}     # mid -> payload
        self.arrive: Dict[int, float] = {}     # mid -> arrival time
        self.t0: Optional[float] = None        # first arrival
        self.result: Optional[dict] = None
        self.replies_left: Optional[set] = None


class FleetHub:
    """Coordinator: rendezvous, ordered gathers, liveness, resize."""

    def __init__(self, world_size: int, heartbeat_s: float = 30.0,
                 port: int = 0, host: str = "127.0.0.1",
                 ckpt_dir: str = "", events_path: str = "",
                 stall_frac: float = 0.5):
        self.heartbeat_s = max(float(heartbeat_s), 0.1)
        self.stall_frac = float(stall_frac)
        self.ckpt_dir = ckpt_dir
        self.events_path = events_path
        self._host = host
        self._port_req = int(port)
        self.addr: Optional[Tuple[str, int]] = None
        self._cond = threading.Condition()
        self._ev_lock = threading.Lock()
        self.epoch = 0
        # mid (stable member id) -> member record; initial ranks are
        # expected from the start so a rank that never shows up is
        # classified dead by the first gather deadline, not waited on
        # forever
        now = time.time()
        self.members: Dict[int, dict] = {
            m: {"shard": m, "alive": True, "pending": False,
                "byed": False, "last_seen": now, "iteration": -1,
                "ckpt_iter": -1}
            for m in range(int(world_size))}
        self.unrecovered: set = set()          # dead mids awaiting resize
        self._gathers: Dict[tuple, _Gather] = {}
        self._resize_waiting: set = set()
        self._resize_epoch_done = -1
        self._resize_t0: Optional[float] = None
        # the common checkpoint iteration the last recovery rolled back
        # to — what a joiner's ``fetch`` serves (rank 0 stamps it)
        self.serve_iteration: Optional[int] = None
        self._srv: Optional[socket.socket] = None
        self._accept_thread: Optional[threading.Thread] = None
        self._closing = False

    # -- lifecycle ------------------------------------------------------
    def start(self) -> Tuple[str, int]:
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind((self._host, self._port_req))
        srv.listen(64)
        self._srv = srv
        self.addr = (self._host, srv.getsockname()[1])
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="fleet-hub", daemon=True)
        self._accept_thread.start()
        self._event("hub_up", world=len(self.members), port=self.addr[1])
        return self.addr

    def stop(self) -> None:
        self._closing = True
        if self._srv is not None:
            try:
                self._srv.close()
            except OSError:
                pass
            self._srv = None

    def _accept_loop(self) -> None:
        while not self._closing and self._srv is not None:
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True).start()

    # -- event trail ----------------------------------------------------
    def _event(self, name: str, **fields) -> None:
        rec = dict(t=round(time.time(), 6), name=name, **fields)
        if self.events_path:
            try:
                with self._ev_lock, open(self.events_path, "a") as fh:
                    fh.write(json.dumps(rec) + "\n")
            except OSError:
                pass
        try:
            from .. import obs
            obs.event(f"fleet_{name}" if not name.startswith("fleet")
                      else name, **fields)
        except Exception:  # noqa: BLE001 — the trail never kills the hub
            pass

    # -- views ----------------------------------------------------------
    def _live_mids(self) -> List[int]:
        return [m for m, r in self.members.items()
                if r["alive"] and not r["pending"] and not r["byed"]]

    def _view(self, stalled=()) -> dict:
        now = time.time()
        live = self._live_mids()
        return {
            "epoch": self.epoch,
            "world": len(live),
            "dead": sorted(m for m, r in self.members.items()
                           if not r["alive"]),
            "pending_join": sum(1 for r in self.members.values()
                                if r["pending"]),
            "stalled": sorted(stalled),
            "members": {
                int(m): {"shard": self.members[m]["shard"],
                         "iteration": self.members[m]["iteration"],
                         "ckpt_iter": self.members[m]["ckpt_iter"],
                         "age_s": round(now - self.members[m]["last_seen"],
                                        3)}
                for m in live},
        }

    def snapshot(self) -> dict:
        """Coordinator-side fleet view (board provider on rank 0)."""
        with self._cond:
            return self._view()

    # -- liveness -------------------------------------------------------
    def _mark_dead(self, mid: int, why: str) -> None:
        """Caller holds the condition."""
        rec = self.members.get(mid)
        if rec is None or not rec["alive"] or rec["byed"]:
            return
        rec["alive"] = False
        self.unrecovered.add(mid)
        self._event("member_dead", mid=mid, shard=rec["shard"], why=why,
                    iteration=rec["iteration"])
        log.warning("fleet: rank %d (shard %d) classified DEAD (%s)",
                    mid, rec["shard"], why)
        self._cond.notify_all()

    # -- per-connection handler ----------------------------------------
    def _serve_conn(self, conn: socket.socket) -> None:
        mid = None
        try:
            while True:
                req = _recv_frame(conn)
                op = req.get("op")
                if op == "hello":
                    mid, rep = self._op_hello(req)
                elif op == "gather":
                    rep = self._op_gather(req)
                elif op == "resize":
                    rep = self._op_resize(req)
                elif op == "fetch":
                    rep = self._op_fetch(req)
                elif op == "bye":
                    rep = self._op_bye(req)
                    _send_frame(conn, rep)
                    return
                else:
                    rep = {"ok": False, "error": f"unknown op {op!r}"}
                _send_frame(conn, rep)
        except (EOFError, OSError, pickle.UnpicklingError):
            with self._cond:
                if mid is not None:
                    self._mark_dead(mid, "connection lost")
        finally:
            try:
                conn.close()
            except OSError:
                pass

    # -- ops ------------------------------------------------------------
    def _op_hello(self, req) -> Tuple[int, dict]:
        with self._cond:
            mid = req.get("mid")
            if req.get("join") or mid is None or mid not in self.members:
                mid = (max(self.members) + 1) if self.members else 0
                self.members[mid] = {
                    "shard": -1, "alive": True, "pending": True,
                    "byed": False, "last_seen": time.time(),
                    "iteration": -1, "ckpt_iter": -1}
                self._event("member_join_pending", mid=mid)
                self._cond.notify_all()
            else:
                self.members[mid]["last_seen"] = time.time()
            rec = self.members[mid]
            return mid, {"ok": True, "mid": mid, "shard": rec["shard"],
                         "epoch": self.epoch,
                         "world": len(self._live_mids()),
                         "pending": rec["pending"]}

    def _op_gather(self, req) -> dict:
        mid = int(req["mid"])
        key = (int(req.get("epoch", self.epoch)), str(req["key"]),
               int(req["seq"]))
        recovery = req.get("phase") == "recover"
        payload = req.get("payload")
        with self._cond:
            rec = self.members.get(mid)
            if rec is None or not rec["alive"]:
                return {"ok": False, "error": "unknown or dead member"}
            now = time.time()
            rec["last_seen"] = now
            if isinstance(payload, dict):
                if "iteration" in payload:
                    rec["iteration"] = int(payload["iteration"])
                if "ckpt_iter" in payload:
                    rec["ckpt_iter"] = int(payload["ckpt_iter"])
            g = self._gathers.get(key)
            if g is None:
                g = self._gathers[key] = _Gather()
            if g.t0 is None:
                g.t0 = now
            g.parts[mid] = payload
            g.arrive[mid] = now
            self._cond.notify_all()
            deadline = g.t0 + self.heartbeat_s
            while g.result is None:
                # dead-rank debt fails the gather for everyone on the
                # TRAIN path (a consistent signal every rank sees);
                # recovery-phase gathers run over the survivor set
                if self.unrecovered and not recovery:
                    lost = sorted(self.members[m]["shard"]
                                  for m in self.unrecovered)
                    self._finalize(key, g, ok=False, lost=lost)
                    break
                live = [m for m in self._live_mids()
                        if not recovery or m not in self.unrecovered]
                if set(live) <= set(g.parts):
                    self._finalize(key, g, ok=True)
                    break
                remaining = deadline - time.time()
                if remaining <= 0:
                    for m in set(live) - set(g.parts):
                        self._mark_dead(m, "heartbeat timeout "
                                        f"({self.heartbeat_s:.1f}s)")
                    continue
                self._cond.wait(timeout=min(remaining, 0.5))
            rep = dict(g.result)
            if g.replies_left is not None:
                g.replies_left.discard(mid)
                if not g.replies_left:
                    self._gathers.pop(key, None)
            return rep

    def _finalize(self, key, g: _Gather, ok: bool, lost=()) -> None:
        """Caller holds the condition."""
        if g.result is not None:
            return
        stalled = []
        if ok and len(g.arrive) > 1:
            t_first = min(g.arrive.values())
            allow = self.stall_frac * self.heartbeat_s
            stalled = [self.members[m]["shard"]
                       for m, t in g.arrive.items() if t - t_first > allow]
            if stalled:
                self._event("fleet_stall", key=key[1], seq=key[2],
                            ranks=sorted(stalled),
                            spread_s=round(max(g.arrive.values())
                                           - t_first, 3))
        view = self._view(stalled=stalled)
        if ok:
            order = sorted(g.parts, key=lambda m: self.members[m]["shard"])
            g.result = {"ok": True,
                        "parts": [g.parts[m] for m in order],
                        "view": view}
        else:
            g.result = {"ok": False, "peer_lost": sorted(lost),
                        "view": view}
        g.replies_left = set(g.parts)
        self._cond.notify_all()

    def _op_resize(self, req) -> dict:
        mid = int(req["mid"])
        with self._cond:
            rec = self.members.get(mid)
            if rec is None or not rec["alive"]:
                return {"ok": False, "error": "unknown or dead member"}
            rec["last_seen"] = time.time()
            epoch_in = self.epoch
            self._resize_waiting.add(mid)
            # the barrier deadline is RELATIVE to the first SURVIVOR
            # arrival: a pending joiner may legitimately park here for a
            # long time before the fleet's next heartbeat even notices
            # it — only once a survivor is standing in the barrier do
            # the missing ones start their 2-heartbeat clock
            if not rec["pending"] and self._resize_t0 is None:
                self._resize_t0 = time.time()
            self._cond.notify_all()
            while self._resize_epoch_done < epoch_in:
                # the run completed underneath a parked joiner (every
                # non-pending member byed): tell it so, instead of
                # resizing it into a solo world that would redo the
                # whole finished run
                if rec["pending"] and not self._live_mids() and any(
                        r["byed"] for r in self.members.values()):
                    self._resize_waiting.discard(mid)
                    return {"ok": True, "done": True, "mid": mid,
                            "shard": rec["shard"], "world": 0,
                            "epoch": self.epoch, "serve_iteration": None}
                expected = set(self._live_mids()) | {
                    m for m, r in self.members.items()
                    if r["alive"] and r["pending"]}
                if expected <= self._resize_waiting:
                    self._do_resize()
                    break
                if self._resize_t0 is None:
                    self._cond.wait(timeout=0.5)
                    continue
                remaining = (self._resize_t0 + 2.0 * self.heartbeat_s
                             - time.time())
                if remaining <= 0:
                    for m in expected - self._resize_waiting:
                        self._mark_dead(m, "missed resize barrier")
                    continue
                self._cond.wait(timeout=min(remaining, 0.5))
            rec = self.members[mid]
            return {"ok": True, "mid": mid, "shard": rec["shard"],
                    "world": len(self._live_mids()), "epoch": self.epoch,
                    "serve_iteration": self.serve_iteration}

    def _do_resize(self) -> None:
        """Caller holds the condition.  Survivors keep their relative
        order (old shard rank), joiners append — dense new ranks."""
        survivors = sorted(
            (m for m, r in self.members.items()
             if r["alive"] and not r["pending"] and not r["byed"]),
            key=lambda m: self.members[m]["shard"])
        joiners = sorted(m for m, r in self.members.items()
                         if r["alive"] and r["pending"])
        for shard, m in enumerate(survivors + joiners):
            self.members[m]["shard"] = shard
            self.members[m]["pending"] = False
        self.unrecovered.clear()
        self._gathers.clear()
        self._resize_waiting.clear()
        self._resize_t0 = None
        self._resize_epoch_done = self.epoch
        self.epoch += 1
        self._event("resize", epoch=self.epoch,
                    world=len(survivors) + len(joiners),
                    survivors=[self.members[m]["shard"] for m in survivors],
                    joiners=len(joiners))
        log.warning("fleet: resized to world %d (epoch %d, %d joiner(s))",
                    len(survivors) + len(joiners), self.epoch,
                    len(joiners))
        self._cond.notify_all()

    def _op_fetch(self, req) -> dict:
        """Tar the rolled-back common checkpoint for a joiner.  None
        when there is nothing to serve (fresh start)."""
        it = self.serve_iteration
        if not self.ckpt_dir or it is None or it <= 0:
            return {"ok": True, "data": None, "iteration": 0}
        src = os.path.join(self.ckpt_dir, f"ckpt_{it:08d}")
        if not os.path.isdir(src):
            return {"ok": True, "data": None, "iteration": 0}
        buf = io.BytesIO()
        with tarfile.open(mode="w:gz", fileobj=buf) as tar:
            tar.add(src, arcname=os.path.basename(src))
        self._event("ckpt_served", iteration=it,
                    bytes=buf.getbuffer().nbytes)
        return {"ok": True, "data": buf.getvalue(), "iteration": it}

    def _op_bye(self, req) -> dict:
        with self._cond:
            rec = self.members.get(int(req["mid"]))
            if rec is not None:
                rec["byed"] = True
                rec["alive"] = False
                self._cond.notify_all()
            return {"ok": True}

    def wait_drain(self, timeout: float = 30.0) -> bool:
        """Block until every member has byed or died (end of run)."""
        deadline = time.time() + timeout
        with self._cond:
            while any(r["alive"] for r in self.members.values()):
                remaining = deadline - time.time()
                if remaining <= 0:
                    return False
                self._cond.wait(timeout=min(remaining, 0.5))
        return True


# ---------------------------------------------------------------------------
# client (one per rank; rank 0 connects over loopback too)
# ---------------------------------------------------------------------------

class FleetClient:
    """One rank's persistent connection to the hub."""

    def __init__(self, addr: Tuple[str, int], mid: Optional[int],
                 heartbeat_s: float = 30.0, join: bool = False,
                 connect_timeout: float = 60.0):
        self.heartbeat_s = float(heartbeat_s)
        self._lock = threading.Lock()
        self._seq: Dict[str, int] = {}
        self.last_view: dict = {}
        self.sock = self._connect(tuple(addr), connect_timeout)
        rep = self._rpc({"op": "hello", "mid": mid, "join": bool(join)})
        self.mid = int(rep["mid"])
        self.shard = int(rep["shard"])
        self.world = int(rep["world"])
        self.epoch = int(rep["epoch"])
        self.pending = bool(rep.get("pending"))

    def _connect(self, addr, timeout: float) -> socket.socket:
        deadline = time.time() + timeout
        last = None
        while time.time() < deadline:
            try:
                s = socket.create_connection(addr, timeout=5.0)
                s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                # RPCs block server-side for up to ~2 heartbeats (resize
                # barrier); the socket deadline sits safely past that so
                # a hub DEATH, not a slow barrier, trips it
                s.settimeout(max(4.0 * self.heartbeat_s, 30.0))
                return s
            except OSError as exc:
                last = exc
                time.sleep(0.1)
        raise FleetCoordinatorLost(
            f"fleet: cannot reach coordinator {addr} ({last})")

    def _rpc(self, obj) -> dict:
        with self._lock:
            try:
                _send_frame(self.sock, obj)
                rep = _recv_frame(self.sock)
            except (OSError, EOFError) as exc:
                raise FleetCoordinatorLost(
                    f"fleet: coordinator unreachable ({exc})") from exc
        if not rep.get("ok") and "error" in rep:
            raise FleetError(f"fleet: hub refused {obj.get('op')!r}: "
                             f"{rep['error']}")
        return rep

    # -- collective -----------------------------------------------------
    def gather(self, key: str, payload, phase: str = "train"):
        """Post ``payload`` under ``key`` and block for every live
        rank's; returns ``(parts, view)`` with parts in shard-rank
        order.  Raises :class:`FleetPeerLost` when the fleet lost a
        member (train phase) — the elastic-recovery signal."""
        self._seq[key] = self._seq.get(key, 0) + 1
        rep = self._rpc({"op": "gather", "mid": self.mid, "key": key,
                         "seq": self._seq[key], "epoch": self.epoch,
                         "payload": payload, "phase": phase})
        self.last_view = rep.get("view", {})
        if not rep["ok"]:
            raise FleetPeerLost(rep.get("peer_lost", ()),
                                detail=f"key={key}")
        return rep["parts"], self.last_view

    def resize(self) -> dict:
        """Meet the fleet in the resize barrier; updates this rank's
        shard/world/epoch assignment and resets collective sequencing.
        The barrier can legitimately outlast any heartbeat multiple (a
        joiner parks until the fleet's next heartbeat notices it), so
        the socket deadline stands down for the duration — a hub DEATH
        still closes the connection and trips the recv."""
        self.sock.settimeout(None)
        try:
            rep = self._rpc({"op": "resize", "mid": self.mid})
        finally:
            self.sock.settimeout(max(4.0 * self.heartbeat_s, 30.0))
        if rep.get("done"):
            return rep
        self.shard = int(rep["shard"])
        self.world = int(rep["world"])
        self.epoch = int(rep["epoch"])
        self.pending = False
        self._seq.clear()
        return rep

    def fetch_checkpoint(self, dest_dir: str) -> int:
        """Pull the fleet's rolled-back common checkpoint into
        ``dest_dir``; returns its iteration (0 = nothing to fetch)."""
        rep = self._rpc({"op": "fetch", "mid": self.mid})
        data = rep.get("data")
        if not data:
            return 0
        os.makedirs(dest_dir, exist_ok=True)
        with tarfile.open(mode="r:gz",
                          fileobj=io.BytesIO(data)) as tar:
            tar.extractall(dest_dir, filter="data")
        return int(rep.get("iteration", 0))

    def bye(self) -> None:
        try:
            self._rpc({"op": "bye", "mid": self.mid})
        except FleetError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass


# ---------------------------------------------------------------------------
# host-collective adapter (parallel/distributed.py plug)
# ---------------------------------------------------------------------------

class HostCollectives:
    """The fleet's gathers as the host collectives of
    ``parallel/distributed.py`` (``set_host_collectives``): its
    ``_allgather_exact`` and what stands on it (bin-sample pooling, the
    divergence audit's stats) ride the hub."""

    def __init__(self, client: FleetClient):
        self.client = client
        self._paused = 0

    @property
    def world_size(self) -> int:
        return int(self.client.world)

    @property
    def rank(self) -> int:
        return int(self.client.shard)

    def active(self) -> bool:
        return self._paused == 0 and self.world_size > 1

    def allgather(self, arr: np.ndarray) -> np.ndarray:
        """Stacked ``[world, *arr.shape]`` gather in shard-rank order, the
        dtype kept; a torch tensor is gathered as its host copy."""
        a = np.ascontiguousarray(_to_wire(arr))
        parts, _ = self.client.gather("allgather", a)
        return np.stack([np.asarray(p, dtype=a.dtype).reshape(a.shape)
                         for p in parts])

    # replicate-mode ingest streams the same whole file on every rank (its
    # sample is global and identical), so the bin-sample pooling of
    # pre-sharded sources stands down for it
    def pause(self):
        from contextlib import contextmanager

        @contextmanager
        def _ctx():
            self._paused += 1
            try:
                yield
            finally:
                self._paused -= 1
        return _ctx()
