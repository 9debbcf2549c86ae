"""Multi-tenant forest arena: many small models, one stacked forest
(counterpart of lightgbm_tpu/serve/arena.py).

Every ``PredictorSession`` owns its forest and its batcher, so thousands
of small tenant models would cost thousands of each.  The arena packs
every resident tenant's trees into one stacked forest with a per-tree
``model_id`` lane (``core/forest.py arena_predict_fn``):

- **one walk serves every tenant** — per-model routing is a
  ``row_model == model_id[t]`` mask inside the walk;
- **cross-model microbatching** — requests for different tenants share
  one device batch (each ``Request`` carries its tenant; the execute
  callback builds the per-row model-id vector);
- **LRU residency under a byte budget** — ``tpu_serve_arena_bytes``
  bounds the packed forest (tensor ``nbytes``); an admission past the
  budget evicts the least recently used tenant, whose host trees are
  kept, so its next request re-admits it transparently.

Parity contract: an arena tenant predicts bit-identically to its own
``PredictorSession``.  The union bin space holds every resident model's
thresholds, so each node's compare stays exact, and the arena walk
freezes a row's Kahan (score, comp) state across other tenants' trees.
Tenants that type the same column differently (categorical in one,
numerical in another) get distinct physical columns.  One documented
collapse remains: a shared column's missing type is the widest across
all resident tenants.

Rebinning happens at execute time against an immutable state snapshot
(``_ArenaState``): a repack builds a new state and swaps it in, and a
batch in flight keeps its old state alive by reference.

No host fallback: a failed device batch fails its requests with
``DeviceFailed``.  ``_Tenant.host_predict`` survives only as the swap
canary's parity oracle.  Fault points: ``serve_arena_device`` (each
launch), ``serve_arena_swap``.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import obs
from ..utils import log
from ..robust import faults
from .batcher import (DeadlineExceeded, DeviceFailed, MicroBatcher, Request,
                      ServeOverloadError, normalize_priority)
from .metrics import percentile
from .packing import ServeBinSpace, collect_split_state
from .session import (Ticket, _env_num, _safe_resolve, _tensor_bytes,
                      as_rows, bucket_sweep, live_requests, load_serving_model,
                      model_feature_count, pow2_bucket)

_LAT_RESERVOIR = 8192
_CANARY_ROWS = 64      # pinned parity probe per admitted or swapped tenant
_CANARY_ATOL = 1e-5    # the registry canary's tolerance
_CANARY_SEED = 17


class ArenaTicket(Ticket):
    """A session ticket plus the tenant that owns the answer (conversion
    and the K-column slice are per model)."""

    __slots__ = ("model",)

    def __init__(self, parts, rows, raw_score, model, priority="normal"):
        super().__init__(parts, rows, raw_score, priority=priority)
        self.model = model


class _Tenant:
    """Host-side truth of one arena model: its value-space trees (kept
    across evictions, so re-admission repacks from here), its conversion
    state and its residency bookkeeping."""

    __slots__ = ("name", "trees", "num_tpi", "num_features", "objective",
                 "average_factor", "resident", "last_used", "version",
                 "mid")

    def __init__(self, name, trees, num_tpi, num_features, objective,
                 average_factor, version=1):
        self.name = name
        self.trees = trees
        self.num_tpi = int(num_tpi)
        self.num_features = int(num_features)
        self.objective = objective
        self.average_factor = float(average_factor)
        self.resident = False
        self.last_used = time.monotonic()
        self.version = int(version)
        self.mid = -1           # model-id lane value while resident

    def host_predict(self, X: np.ndarray) -> np.ndarray:
        """The value-space host walk: the swap canary's parity oracle,
        never a served answer."""
        K = self.num_tpi
        out = np.zeros((X.shape[0], K))
        for i, tree in enumerate(self.trees):
            out[:, i % K] += tree.predict(X[:, :self.num_features])
        if self.average_factor:
            out /= self.average_factor
        return out


def _load_tenant(name: str, model, device, version: int = 1) -> _Tenant:
    """A model surface (file path, Booster, GBDT) as a ``_Tenant``."""
    gbdt, _ = load_serving_model(model, device)
    trees = list(gbdt.models)
    if not trees:
        raise ValueError(f"cannot admit empty model {name!r}")
    K = int(gbdt.num_tpi)
    F = model_feature_count(gbdt)
    if F <= 0:
        raise ValueError(f"model {name!r} declares no feature space")
    avg = (float(len(trees) // K) if getattr(gbdt, "average_output", False)
           else 0.0)
    return _Tenant(name, trees, K, F, getattr(gbdt, "objective", None),
                   avg, version=version)


class _RemapTree:
    """Packing-only view of a host tree whose split features move to
    arena union columns; everything else delegates to the real tree."""

    __slots__ = ("_t", "split_feature")

    def __init__(self, tree, colmap):
        self._t = tree
        nn = max(tree.num_leaves - 1, 0)
        self.split_feature = [int(colmap[int(f)])
                              for f in tree.split_feature[:nn]]

    def __getattr__(self, name):
        return getattr(self._t, name)


class _ArenaState:
    """One immutable pack generation, swapped in whole on a repack."""

    __slots__ = ("generation", "space", "forest", "fn", "K", "F",
                 "order", "bytes", "colmaps")

    def __init__(self, generation, space, forest, fn, K, F, order,
                 nbytes, colmaps=None):
        self.generation = generation
        self.space = space
        self.forest = forest
        self.fn = fn
        self.K = K              # widest trees-an-iteration of the tenants
        self.F = F              # union feature width (+ conflict columns)
        self.order = order      # resident tenant names, pack order
        self.bytes = nbytes
        # tenant -> union column of each model feature (only tenants with
        # a categorical/numerical conflict)
        self.colmaps: dict = colmaps or {}


class ForestArena:
    """Pack-many, serve-as-one multi-tenant engine.  Duck-types the part
    of the session surface the HTTP edge consumes (``submit``/``result``/
    ``predict``/``stats``/``warmup``/``close``/``has``); every submit
    names its tenant with ``model=``."""

    def __init__(self, config=None, budget_bytes: Optional[int] = None,
                 max_batch: Optional[int] = None,
                 max_wait_ms: Optional[float] = None,
                 queue_depth: Optional[int] = None, device=None):
        from ..basic import resolve_device
        from ..config import Config
        if isinstance(config, dict):
            config = Config.from_params(config)
        cfg = config if config is not None else Config()
        self.config = config
        self.device = resolve_device(device if device is not None
                                     else cfg.device_type)
        self.budget_bytes = int(
            budget_bytes if budget_bytes is not None else _env_num(
                "LGBM_TPU_SERVE_ARENA_BYTES", int, cfg.tpu_serve_arena_bytes))
        self.max_batch = int(max_batch if max_batch is not None else _env_num(
            "LGBM_TPU_SERVE_MAX_BATCH", int, cfg.tpu_serve_max_batch))
        self.max_wait_ms = float(
            max_wait_ms if max_wait_ms is not None else _env_num(
                "LGBM_TPU_SERVE_MAX_WAIT_MS", float,
                cfg.tpu_serve_max_wait_ms))
        self.queue_depth = int(
            queue_depth if queue_depth is not None else _env_num(
                "LGBM_TPU_SERVE_QUEUE_DEPTH", int, cfg.tpu_serve_queue_depth))
        self._tenants: Dict[str, _Tenant] = {}
        self._state: Optional[_ArenaState] = None
        self._lock = threading.RLock()
        self._closed = False
        self._t_start = time.time()
        self._generation = 0
        self._evictions = 0
        self._readmissions = 0
        self._repacks = 0
        self._swaps = 0
        self._swap_rejects = 0
        self._batches = 0
        self._cross_model_batches = 0
        self._real_rows = 0
        self._padded_rows = 0
        self._n_req = 0
        self._n_ok = 0
        self._n_deadline = 0
        self._n_overload = 0
        self._n_failed = 0
        self._buckets: set = set()
        self._lat_ms: List[float] = []
        self.events: list = []
        self._batcher = MicroBatcher(
            self._execute_batch, max_batch=self.max_batch,
            max_wait_s=self.max_wait_ms / 1e3,
            max_queue_rows=self.queue_depth, name="lgbm-serve-arena")

    def _event(self, name: str, **fields) -> None:
        self.events.append(dict(fields, event=name, t=time.time()))
        obs.event(name, **fields)

    # ---- residency ----------------------------------------------------
    def has(self, name) -> bool:
        return name in self._tenants

    def tenant_names(self) -> List[str]:
        with self._lock:
            return sorted(self._tenants)

    def admit(self, name: str, model, version: Optional[int] = None) -> dict:
        """Load and make resident (a repack).  Admitting past the byte
        budget LRU-evicts cold tenants; admitting a known name is a hot
        swap (``swap``)."""
        with self._lock:
            if name in self._tenants:
                return self.swap(name, model)
            ten = _load_tenant(name, model, self.device,
                               version=version if version is not None else 1)
            ten.resident = True
            ten.last_used = time.monotonic()
            self._tenants[name] = ten
            try:
                self._repack(protect=name)
            except Exception:
                # a pack that cannot be built must not strand the tenant
                del self._tenants[name]
                self._repack(protect=None)
                raise
            st = self._state
            self._event("arena_admit", model=name, tenants=len(self._tenants),
                        resident=len(st.order), bytes=int(st.bytes),
                        readmit=False)
            return {"ok": True, "model": name, "resident": True,
                    "generation": st.generation, "bytes": int(st.bytes)}

    def evict(self, name: str, reason: str = "manual") -> bool:
        """Drop a tenant from the device pack (its host trees are kept,
        so its next request re-admits it)."""
        with self._lock:
            ten = self._tenants.get(name)
            if ten is None or not ten.resident:
                return False
            ten.resident = False
            self._evictions += 1
            self._event("arena_evict", model=name, reason=reason)
            self._repack(protect=None)
            return True

    def remove(self, name: str) -> bool:
        """Forget a tenant entirely (trees included)."""
        with self._lock:
            if name not in self._tenants:
                return False
            del self._tenants[name]
            self._repack(protect=None)
            return True

    def swap(self, name: str, model) -> dict:
        """Hot-swap one tenant behind a parity canary: the candidate is
        packed into a candidate generation and held against its own host
        walk on a pinned probe set before it serves; on failure the old
        trees are restored and keep serving."""
        with self._lock:
            faults.check("serve_arena_swap")
            old = self._tenants.get(name)
            if old is None:
                return self.admit(name, model)
            cand = _load_tenant(name, model, self.device,
                                version=old.version + 1)
            cand.resident = True
            cand.last_used = time.monotonic()
            self._tenants[name] = cand
            try:
                self._repack(protect=name)
                self._canary(cand)
            except Exception as exc:
                self._tenants[name] = old
                self._repack(protect=None)
                self._swap_rejects += 1
                self._event("arena_swap", model=name, ok=False,
                            error=f"{type(exc).__name__}: {exc}")
                raise
            self._swaps += 1
            st = self._state
            self._event("arena_swap", model=name, ok=True,
                        version=cand.version, generation=st.generation)
            return {"ok": True, "model": name, "to_version": cand.version,
                    "generation": st.generation}

    def _canary(self, ten: _Tenant) -> None:
        """Pinned-probe parity of one tenant against its host walk (the
        registry canary's arbiter and tolerance)."""
        rng = np.random.default_rng(_CANARY_SEED)
        X = rng.standard_normal((_CANARY_ROWS, ten.num_features))
        got = self._device_predict_sync(X, ten)
        want = ten.host_predict(X)
        if not np.all(np.isfinite(got)):
            raise RuntimeError("arena canary: non-finite predictions")
        err = float(np.max(np.abs(got - want))) if got.size else 0.0
        if err > _CANARY_ATOL:
            raise RuntimeError(
                f"arena canary: parity {err:.3g} > {_CANARY_ATOL}")

    def _repack(self, protect: Optional[str]) -> None:
        """Rebuild the device pack from the resident set, LRU-evicting
        under the byte budget (``protect``, the tenant being admitted,
        never evicts itself).  Called with the lock held."""
        while True:
            resident = [t for t in self._tenants.values() if t.resident]
            if not resident:
                self._generation += 1
                self._state = None
                for t in self._tenants.values():
                    t.mid = -1
                return
            state = self._build_state(resident)
            if (self.budget_bytes <= 0 or state.bytes <= self.budget_bytes
                    or len(resident) <= 1):
                break
            victims = sorted((t for t in resident if t.name != protect),
                             key=lambda t: t.last_used)
            if not victims:
                break
            v = victims[0]
            v.resident = False
            v.mid = -1
            self._evictions += 1
            log.info("arena: evicting %r (LRU, %d bytes over the budget of "
                     "%d)", v.name, state.bytes, self.budget_bytes)
            self._event("arena_evict", model=v.name, reason="budget",
                        bytes=int(state.bytes))
        self._state = state
        for t in self._tenants.values():
            if not t.resident:
                t.mid = -1      # a stale lane must never match a row
        self._repacks += 1

    def _build_state(self, resident: List[_Tenant]) -> _ArenaState:
        """Pack a resident set: the union bin space of every tenant's
        trees and one stacked forest with the model-id lane."""
        from ..core.forest import arena_predict_fn
        resident = sorted(resident, key=lambda t: t.name)
        F0 = max(t.num_features for t in resident)
        K = max(t.num_tpi for t in resident)
        # a column categorical in one model and numerical in another
        # cannot share a union column (category values vs threshold
        # ranks): the numerical side gets an appended column
        num_used, cat_used = {}, {}
        u_num = np.zeros(F0, bool)
        u_cat = np.zeros(F0, bool)
        for ten in resident:
            thr, _, ic, _, _ = collect_split_state(ten.trees,
                                                   ten.num_features)
            nu = np.array([bool(v) for v in thr], bool)
            num_used[ten.name], cat_used[ten.name] = nu, ic
            u_num[:nu.size] |= nu
            u_cat[:ic.size] |= ic
        conflict = {int(f): F0 + j
                    for j, f in enumerate(np.nonzero(u_num & u_cat)[0])}
        F = F0 + len(conflict)
        colmaps: Dict[str, np.ndarray] = {}
        all_trees, class_ids, model_ids = [], [], []
        for mid, ten in enumerate(resident):
            ten.mid = mid
            trees = ten.trees
            cm = np.arange(ten.num_features, dtype=np.int32)
            moved = False
            for f, dest in conflict.items():
                if (f < ten.num_features and num_used[ten.name][f]
                        and not cat_used[ten.name][f]):
                    cm[f] = dest
                    moved = True
            if moved:
                colmaps[ten.name] = cm
                trees = [_RemapTree(t, cm) for t in trees]
            for i, tree in enumerate(trees):
                all_trees.append(tree)
                class_ids.append(i % ten.num_tpi)
                model_ids.append(mid)
        space = ServeBinSpace(all_trees, F, self.device)
        forest = space.pack(all_trees, np.asarray(class_ids, np.int32),
                            model_ids=np.asarray(model_ids, np.int32))
        self._generation += 1
        return _ArenaState(self._generation, space, forest,
                           arena_predict_fn(space.meta, K), K, F,
                           [t.name for t in resident], _tensor_bytes(forest),
                           colmaps=colmaps)

    # ---- serving ------------------------------------------------------
    def _bucket(self, n: int) -> int:
        return pow2_bucket(n, self.max_batch)

    def warmup(self) -> int:
        """Run every bucket of the current generation once (pad rows
        only).  Returns the bucket count."""
        with self._lock:
            state = self._state
        if state is None:
            return 0
        n = 0
        for size in bucket_sweep(self.max_batch):
            self._dispatch(state, np.zeros((size, state.F), np.int32),
                           np.full(size, -1, np.int32))
            n += 1
        return n

    def _dispatch(self, state: _ArenaState, bins: np.ndarray,
                  row_model: np.ndarray):
        """Pad to the pow2 bucket and run one arena walk.  Pad rows carry
        model id -1, which matches no tree."""
        n = bins.shape[0]
        b = self._bucket(n)
        if b > n:
            bins = np.concatenate(
                [bins, np.zeros((b - n, bins.shape[1]), bins.dtype)])
            row_model = np.concatenate(
                [row_model, np.full(b - n, -1, np.int32)])
        with self._lock:
            self._buckets.add(b)
        faults.check("serve_arena_device")
        out = state.fn(state.forest, torch.from_numpy(bins).to(self.device),
                       torch.from_numpy(row_model).to(self.device))
        return out.cpu().numpy().astype(np.float64)[:n], b

    def _resolve(self, model: Optional[str]) -> _Tenant:
        """Tenant lookup with transparent re-admission: an evicted tenant
        repacks back in on its next request (LRU may push out a colder
        one)."""
        with self._lock:
            if model is None:
                if len(self._tenants) == 1:
                    model = next(iter(self._tenants))
                else:
                    raise KeyError("the arena holds several tenants; a "
                                   "request must name one (model=...)")
            ten = self._tenants.get(model)
            if ten is None:
                raise KeyError(f"unknown arena tenant {model!r}")
            ten.last_used = time.monotonic()
            if not ten.resident:
                ten.resident = True
                self._readmissions += 1
                self._repack(protect=ten.name)
                st = self._state
                self._event("arena_admit", model=ten.name,
                            tenants=len(self._tenants),
                            resident=len(st.order) if st else 0,
                            bytes=int(st.bytes) if st else 0, readmit=True)
            return ten

    def submit(self, X, model: Optional[str] = None,
               deadline_ms: Optional[float] = None, raw_score: bool = False,
               trace_id: Optional[str] = None,
               parent_id: Optional[str] = None,
               priority: str = "normal") -> ArenaTicket:
        """Queue rows for the next coalesced (possibly cross-model)
        batch.  The raw rows ride the request and are binned at execute
        time against the live pack generation."""
        if self._closed:
            raise RuntimeError("arena is closed")
        ten = self._resolve(model)
        X = as_rows(X, ten.num_features)
        priority = normalize_priority(priority)
        deadline = (time.monotonic() + float(deadline_ms) / 1e3
                    if deadline_ms is not None else None)
        parts = []
        try:
            for lo in range(0, max(X.shape[0], 1), self.max_batch):
                chunk = X[lo:lo + self.max_batch]
                req = Request(chunk, chunk, deadline=deadline,
                              trace_id=trace_id, parent_id=parent_id,
                              priority=priority, model=ten.name)
                parts.append((self._batcher.submit(req), chunk.shape[0]))
        except ServeOverloadError:
            with self._lock:
                self._n_overload += 1
            for fut, _ in parts:
                fut.cancel()
            raise
        return ArenaTicket(parts, int(X.shape[0]), raw_score, ten.name,
                           priority=priority)

    def result(self, ticket: ArenaTicket,
               timeout: Optional[float] = None) -> np.ndarray:
        end = None if timeout is None else time.monotonic() + timeout
        chunks = []
        try:
            for fut, _ in ticket.parts:
                left = (None if end is None
                        else max(end - time.monotonic(), 0.0))
                chunks.append(fut.result(left))
        except BaseException as exc:
            if not ticket.counted:
                ticket.counted = True
                with self._lock:
                    self._n_req += 1
                    if isinstance(exc, DeadlineExceeded):
                        self._n_deadline += 1
                    else:
                        self._n_failed += 1
            raise
        raw = chunks[0] if len(chunks) == 1 else np.concatenate(chunks)
        if not ticket.counted:
            ticket.counted = True
            total_ms = (time.perf_counter() - ticket.t0) * 1e3
            with self._lock:
                self._n_req += 1
                self._n_ok += 1
                self._lat_ms.append(total_ms)
                if len(self._lat_ms) > _LAT_RESERVOIR:
                    del self._lat_ms[:_LAT_RESERVOIR // 2]
        return self._convert(raw, self._tenants[ticket.model],
                             ticket.raw_score)

    @staticmethod
    def _convert(raw: np.ndarray, ten: _Tenant, raw_score: bool):
        out = raw[:, :ten.num_tpi]
        squeezed = out if ten.num_tpi > 1 else out[:, 0]
        if raw_score or ten.objective is None:
            return squeezed
        return np.asarray(ten.objective.convert_output(squeezed))

    def predict(self, X, model: Optional[str] = None,
                raw_score: bool = False) -> np.ndarray:
        """Synchronous path (bypasses the queue, shares the buckets)."""
        ten = self._resolve(model)
        raw = self._device_predict_sync(as_rows(X, ten.num_features), ten)
        return self._convert(raw, ten, raw_score)

    def _device_predict_sync(self, X: np.ndarray, ten: _Tenant
                             ) -> np.ndarray:
        with self._lock:
            state = self._state
            mid = ten.mid
        if state is None or mid < 0:
            raise DeviceFailed(f"arena tenant {ten.name!r} is not resident")
        out = np.zeros((X.shape[0], ten.num_tpi))
        for lo in range(0, X.shape[0], self.max_batch):
            chunk = X[lo:lo + self.max_batch]
            bins = state.space.bin_matrix(
                self._project(chunk, state, ten.name))
            try:
                raw, _ = self._dispatch(
                    state, bins, np.full(chunk.shape[0], mid, np.int32))
            except Exception as exc:  # noqa: BLE001 — the failure point
                raise DeviceFailed(f"arena device batch failed "
                                   f"({type(exc).__name__}: {exc})") from exc
            out[lo:lo + chunk.shape[0]] = raw[:, :ten.num_tpi]
        if ten.average_factor:
            out /= ten.average_factor
        return out

    @staticmethod
    def _project(X: np.ndarray, state: _ArenaState, name: str
                 ) -> np.ndarray:
        """A tenant's raw columns at their union positions: zero-padded
        to the union width (other tenants' columns, never read through
        this tenant's trees), or scattered through its colmap when it
        holds the numerical side of a categorical/numerical conflict."""
        cm = state.colmaps.get(name)
        if cm is None:
            if X.shape[1] >= state.F:
                return X
            return np.concatenate(
                [X, np.zeros((X.shape[0], state.F - X.shape[1]), X.dtype)],
                axis=1)
        out = np.zeros((X.shape[0], state.F), np.float64)
        out[:, cm] = X[:, :cm.size]
        return out

    # ---- batcher callback ---------------------------------------------
    def _walk(self, reqs, models):
        """One walk over ``reqs`` (tenants ``models``, resident first):
        ([rows, K] raw scores, bucket)."""
        with self._lock:
            for m in models:
                self._resolve(m)
            state = self._state
            mids = {m: self._tenants[m].mid for m in models}
        if state is None or any(v < 0 for v in mids.values()):
            return None, 0
        bins = np.concatenate(
            [state.space.bin_matrix(self._project(r.raw, state, r.model))
             for r in reqs])
        row_model = np.concatenate(
            [np.full(r.n, mids[r.model], np.int32) for r in reqs])
        try:
            return self._dispatch(state, bins, row_model)
        except Exception as exc:  # noqa: BLE001 — the failure point
            log.warning("arena device batch failed (%s: %s)",
                        type(exc).__name__, exc)
            self._event("serve_degraded", plane="arena",
                        error=f"{type(exc).__name__}: {exc}")
            raise DeviceFailed(f"arena device batch failed "
                               f"({type(exc).__name__}: {exc})") from exc

    def _execute_batch(self, reqs) -> None:
        """Coalesce a (possibly multi-tenant) batch into one walk.  A
        tenant evicted while its request waited is re-admitted first;
        when the byte budget cannot hold the batch's tenants together,
        each tenant's requests take a walk of their own.  A failed walk
        fails its requests."""
        live = live_requests(reqs)
        if not live:
            return
        models = list(dict.fromkeys(r.model for r in live))
        try:
            raw, bucket = self._walk(live, models)
            if raw is None:
                outs = []
                for m in models:
                    group = [r for r in live if r.model == m]
                    part, b = self._walk(group, [m])
                    if part is None:
                        raise DeviceFailed(f"arena tenant {m!r} could not "
                                           "be made resident")
                    outs.append((group, part))
                    bucket += b
                live = [r for group, _ in outs for r in group]
                raw = np.concatenate([part for _, part in outs])
        except DeviceFailed as exc:
            for r in live:
                _safe_resolve(r.future, error=exc)
            return
        off = 0
        for r in live:
            part = np.array(raw[off:off + r.n])
            avg = self._tenants[r.model].average_factor
            if avg:
                part /= avg
            _safe_resolve(r.future, result=part)
            off += r.n
        with self._lock:
            self._batches += 1
            self._cross_model_batches += len(models) > 1
            self._real_rows += sum(r.n for r in live)
            self._padded_rows += bucket

    # ---- introspection ------------------------------------------------
    def tenants(self) -> List[dict]:
        """Per-tenant residency rows (/models)."""
        with self._lock:
            now = time.monotonic()
            return [{"name": t.name, "resident": t.resident,
                     "version": t.version, "num_class": t.num_tpi,
                     "num_features": t.num_features,
                     "trees": len(t.trees),
                     "idle_s": round(now - t.last_used, 1)}
                    for t in sorted(self._tenants.values(),
                                    key=lambda t: t.name)]

    def stats(self) -> dict:
        with self._lock:
            state = self._state
            lat = sorted(self._lat_ms)
            resident = sum(1 for t in self._tenants.values() if t.resident)
            return {
                "tenants": len(self._tenants),
                "resident": resident,
                "generation": self._generation,
                "packed_bytes": int(state.bytes) if state else 0,
                "budget_bytes": self.budget_bytes,
                "evictions": self._evictions,
                "readmissions": self._readmissions,
                "repacks": self._repacks,
                "swaps": self._swaps,
                "swap_rejects": self._swap_rejects,
                "requests": self._n_req,
                "ok": self._n_ok,
                "failed": self._n_failed,
                "deadline_missed": self._n_deadline,
                "overloads": self._n_overload,
                "batches": self._batches,
                "cross_model_batches": self._cross_model_batches,
                "rows": self._real_rows,
                "padded_rows": self._padded_rows,
                "occupancy": (round(self._real_rows / self._padded_rows, 4)
                              if self._padded_rows else None),
                "p50_ms": percentile(lat, 0.50),
                "p99_ms": percentile(lat, 0.99),
                "buckets": sorted(self._buckets),
                "max_batch": self.max_batch,
                "device": str(self.device),
                "queue_rows": (0 if self._closed
                               else self._batcher.queue_rows),
                "uptime_s": round(time.time() - self._t_start, 1),
            }

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self._batcher.close()

    def __enter__(self) -> "ForestArena":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
