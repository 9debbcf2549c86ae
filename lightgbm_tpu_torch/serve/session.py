"""``PredictorSession``: pack a model once, serve it from the device
(counterpart of lightgbm_tpu/serve/session.py).

- the model (a ``Booster``, a bare ``GBDT``/``LoadedGBDT``, or a model
  file path) is packed once into a stacked bin-space ``ForestArrays`` on
  the session's device, in a bin space rebuilt from the model's own
  thresholds (``serve/packing.py``; no training data needed);
- ``predict(X)`` is the synchronous path (chunked to the batch cap);
  ``submit(X) -> ticket`` / ``result(ticket)`` the asynchronous one,
  coalesced by the microbatcher (``serve/batcher.py``);
- ``explain(X)`` / ``submit_explain(X)`` are their SHAP-contribution
  twins over the batched TreeSHAP pass (``explain/``), behind a second
  microbatcher with its own pow2 bucket family, packed on first use;
- every device call pads its rows to the next power of two up to the
  batch cap, so ``stats()`` reports the JAX package's buckets, occupancy
  and pad waste.  The port's walk is eager torch ops, so a bucket
  compiles nothing; on the card ``warmup`` captures each bucket's walk as
  one CUDA graph and a batch replays it (``serve/aot.py``), where the CPU
  walks eagerly;
- with ``tpu_serve_aot_dir`` armed, the packed forest and bin space come
  from the store when it holds this window, and are written to it when
  it does not (``serve/aot.py``);
- the bins of a batch go to the device in one copy; its scores come back
  in one ``.cpu()`` copy, which waits for that batch's work alone (no
  device-wide synchronize, so replicas on one card do not serialize).

**No host fallback.**  The JAX session degrades to the host numpy walk
when the device call fails.  The port never answers from the host (the
rule that refuses ``tpu_on_device_error=fallback``): a failed device
batch fails its requests with :class:`DeviceFailed`, and the session
turns ``degraded`` (``stats()``, ``/health``, the ``tpu_serve_degraded``
gauge and its transition counters).  While degraded it refuses new work
at submit with ``DeviceFailed`` (so a router fails over to a sibling),
and every ``tpu_serve_reprobe_s`` seconds it re-probes the device with a
one-row batch; a probe that succeeds ends the degradation.  A sticky CUDA
error poisons the whole context, so every session on that card fails its
probe as well.  ``_run_host`` survives only as the registry canary's
parity oracle: it checks an answer and never gives one.

Observability (``obs/``), as in the JAX session: state transitions,
requests and batches are telemetry events (and kept in ``events``);
with trace mode or the flight ring on, each request's batch phases are
spans (``serve/queue_wait``, ``serve/coalesce`` and
``serve/device_execute``) under its trace id; a degradation or an
overload storm dumps the flight ring.  A model file with a
``.quality.json`` sidecar arms a ``DriftMonitor`` (``tpu_drift``; a
router passes one shared by its replicas), which sees every batch's raw
rows and scores.
"""
from __future__ import annotations

import os
import threading
import time
from collections import deque
from concurrent.futures import InvalidStateError
from typing import Optional

import numpy as np
import torch

from .. import obs
from ..config import Config
from ..robust import faults
from ..utils import log
from .batcher import (DeadlineExceeded, DeviceFailed, MicroBatcher, Request,
                      ServeOverloadError, normalize_priority)
from .metrics import ServeMetrics, percentile
from .packing import ServeBinSpace

_LAT_RESERVOIR = 8192    # latency samples kept for the p50/p99 estimate
_EVENTS_KEPT = 1024      # state-transition events kept in ``events``

# an overload storm (_STORM_N rejects inside _STORM_WINDOW_S) dumps the
# flight ring at most once a _STORM_COOLDOWN_S
_STORM_N = 16
_STORM_WINDOW_S = 5.0
_STORM_COOLDOWN_S = 60.0


def _safe_resolve(future, result=None, error=None) -> None:
    """Resolve a request future, tolerating the overload-cancellation
    race: a submit that overloaded cancels its already-queued chunks, and
    cancel() can land between a done() check and the set_* call."""
    try:
        if error is not None:
            future.set_exception(error)
        else:
            future.set_result(result)
    except InvalidStateError:
        pass


def _env_num(name: str, cast, fallback):
    v = os.environ.get(name, "")
    if v:
        try:
            return cast(v)
        except ValueError:
            log.warning("ignoring non-numeric %s=%r", name, v)
    return fallback


def _tensor_bytes(obj) -> int:
    """Bytes of the tensors held by a NamedTuple of tensors."""
    return sum(int(v.nbytes) for v in obj if isinstance(v, torch.Tensor))


def load_serving_model(model, device):
    """(gbdt, config) of a model surface: a file path (loaded onto
    ``device``), a ``Booster`` or a bare ``GBDT``/``LoadedGBDT``; config
    is the booster's, else None."""
    if isinstance(model, str):
        from ..io.model_io import load_model_file
        return load_model_file(model, device), None
    if hasattr(model, "_gbdt"):             # a basic.Booster
        return model._gbdt, getattr(model, "config", None)
    return model, getattr(model, "config", None)


def as_rows(X, num_features: int) -> np.ndarray:
    """Request rows as a C-contiguous f64 [n, num_features] matrix (one
    row may come as a vector); another width raises ``ValueError``."""
    X = np.ascontiguousarray(np.asarray(X), dtype=np.float64)
    if X.ndim == 1:
        X = X[None, :]
    if X.ndim != 2 or X.shape[1] != num_features:
        raise ValueError(
            f"The number of features in data "
            f"({X.shape[1] if X.ndim == 2 else '?'}) is not the same "
            f"as it was in training data ({num_features})")
    return X


def live_requests(reqs):
    """The batch's requests still wanted: cancelled ones dropped, expired
    ones failed with ``DeadlineExceeded``."""
    now = time.monotonic()
    live = []
    for r in reqs:
        if r.future.cancelled():
            continue
        if r.deadline is not None and now > r.deadline:
            waited = (now - r.t_submit) * 1e3
            _safe_resolve(r.future, error=DeadlineExceeded(
                f"request expired after {waited:.1f}ms in queue"))
        else:
            live.append(r)
    return live


def model_feature_count(gbdt) -> int:
    if gbdt.train_ds is not None:
        return int(gbdt.train_ds.num_total_features)
    return int(getattr(gbdt, "num_features", 0)
               or len(getattr(gbdt, "feature_names", []) or []))


def bucket_sweep(cap: int):
    """Every bucket ``_bucket`` can produce, ascending: the pow2 ladder
    clamped at the batch cap (a non-power-of-two cap is the top bucket)."""
    b = 1
    while True:
        size = min(b, cap)
        yield size
        if size >= cap:
            return
        b *= 2


def pow2_bucket(n: int, cap: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return min(b, cap)


def _capture(graphs, bucket: int, plane: str) -> None:
    """Capture one bucket's CUDA graph at warm-up (no-op on the CPU); a
    failed capture raises ``DeviceFailed``: nothing walks in its place."""
    if graphs is None:
        return
    try:
        graphs.capture(bucket)
    except Exception as exc:  # noqa: BLE001 — the failure point
        raise DeviceFailed(f"{plane}: CUDA graph capture of bucket "
                           f"{bucket} failed ({type(exc).__name__}: "
                           f"{exc})") from exc


def _encode_pack(space, forest, max_batch: int) -> dict:
    """A store entry's payload: the bin space, the stacked forest and the
    bucket ladder, as numpy (``serve/aot.py``)."""
    from .aot import to_host
    return {"space": space.state(), "forest": to_host(forest),
            "ladder": list(bucket_sweep(max_batch))}


def _decode_pack(payload: dict, device, T: int, F: int, max_batch: int):
    """(space, forest) of a store entry on ``device``; raises when the
    entry does not fit the window (T trees, F features, the ladder)."""
    from ..core.forest import ForestArrays
    from .aot import from_host
    if payload.get("ladder") != list(bucket_sweep(max_batch)):
        raise ValueError("bucket ladder differs")
    space = ServeBinSpace.from_state(payload["space"], device)
    forest = from_host(ForestArrays, payload["forest"], device)
    if space.num_features != max(F, 1) or len(forest.depth) != T:
        raise ValueError("entry packs another window")
    return space, forest


class Ticket:
    """Handle of an asynchronous submission (one or more batcher requests:
    oversize submissions are chunked to the batch cap).  ``kind`` is
    ``"predict"`` or ``"explain"``."""

    __slots__ = ("parts", "rows", "raw_score", "t0", "counted", "kind",
                 "priority")

    def __init__(self, parts, rows: int, raw_score: bool,
                 kind: str = "predict", priority: str = "normal"):
        self.parts = parts          # [(future, n_rows), ...]
        self.rows = rows
        self.raw_score = raw_score
        self.t0 = time.perf_counter()
        self.counted = False        # request-level stats recorded once
        self.kind = kind
        self.priority = priority


class PredictorSession:
    """Device-resident inference over one packed model window."""

    def __init__(self, model, config=None, num_iteration: Optional[int] = None,
                 start_iteration: int = 0, max_batch: Optional[int] = None,
                 max_wait_ms: Optional[float] = None,
                 queue_depth: Optional[int] = None,
                 metrics: Optional[ServeMetrics] = None, device=None,
                 drift="auto"):
        from ..basic import resolve_device
        if isinstance(config, dict):
            config = Config.from_params(config)
        # fleet identity (serve/router.py and serve/registry.py stamp it)
        self.model_name: Optional[str] = None
        self.model_version: Optional[int] = None
        self.replica_id: Optional[str] = None
        if device is None:
            device = getattr(config, "device_type", None) or "cuda"
        self.device = resolve_device(device)
        gbdt, model_cfg = load_serving_model(model, self.device)
        config = config if config is not None else model_cfg
        self.config = config if config is not None else Config()
        self.gbdt = gbdt
        self.objective = getattr(gbdt, "objective", None)
        self.objective_error = getattr(gbdt, "objective_error", None)
        K = self.num_tpi = int(gbdt.num_tpi)

        start, stop = gbdt._iter_window(num_iteration, start_iteration)
        trees = list(gbdt.models)[start * K:stop * K]
        if not trees:
            raise ValueError("cannot serve an empty model")
        self._trees = trees
        self.num_trees = len(trees)
        # averaged (rf) forests divide the summed raw score by the window
        self.average_factor = (float(max(stop - start, 1))
                               if getattr(gbdt, "average_output", False)
                               else 0.0)
        F = model_feature_count(gbdt)
        if F <= 0:
            raise ValueError("model declares no feature space to bin into")
        self.num_features = F

        cfg = self.config
        self.max_batch = int(max_batch if max_batch is not None else _env_num(
            "LGBM_TPU_SERVE_MAX_BATCH", int, cfg.tpu_serve_max_batch))
        if self.max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.max_wait_ms = float(
            max_wait_ms if max_wait_ms is not None else _env_num(
                "LGBM_TPU_SERVE_MAX_WAIT_MS", float,
                cfg.tpu_serve_max_wait_ms))
        self.queue_depth = int(
            queue_depth if queue_depth is not None else _env_num(
                "LGBM_TPU_SERVE_QUEUE_DEPTH", int, cfg.tpu_serve_queue_depth))
        # ---- explanation serving (explain/ TreeSHAP) -------------------
        env_x = os.environ.get("LGBM_TPU_EXPLAIN", "").strip().lower()
        self.explain_enabled = (env_x not in ("0", "false", "off") if env_x
                                else bool(cfg.tpu_explain))
        self.explain_max_batch = max(int(_env_num(
            "LGBM_TPU_EXPLAIN_MAX_BATCH", int, cfg.tpu_explain_max_batch)), 1)
        self.explain_max_wait_ms = max(float(_env_num(
            "LGBM_TPU_EXPLAIN_MAX_WAIT_MS", float,
            cfg.tpu_explain_max_wait_ms)), 0.0)
        # packed on first explain()/submit_explain(): the path metadata
        # and a second batcher cost what a predict-only session must not
        self._explain = None
        self._explain_lock = threading.Lock()
        self._explain_buckets: set = set()
        self._explain_batches = 0
        self._explain_rows = 0
        self._explain_padded = 0
        self._n_explain = 0
        self._n_explain_ok = 0
        self._n_explain_deadline = 0
        self._xlat_ms: list = []
        # the explain plane degrades apart from predict's: the TreeSHAP
        # pass's working set can fail (out of memory) while 1-row predicts
        # still succeed
        self._explain_degraded = False
        self._last_explain_probe = 0.0

        # the port's early-stop spec reads the config it is given: the
        # session's, so a loaded model's pred_early_stop acts as in the
        # JAX session
        self.early_stop = gbdt._early_stop_spec(self.config)

        # ---- pack once: bin space + stacked forest --------------------
        # from the store (serve/aot.py) when it holds this window, else
        # from the trees (then written to the store)
        from ..core.forest import forest_predict_fn
        from .aot import AOTStore, resolve_aot_dir, trees_digest
        aot_dir = resolve_aot_dir(self.config)
        self._aot = AOTStore(aot_dir) if aot_dir else None
        self._aot_status = None
        packed = None
        if self._aot is not None:
            digest = trees_digest(trees, f"K={K}|F={F}|es="
                                  f"{self.early_stop!r}")
            key = self._aot.key("predict", self.max_batch, digest,
                                device=self.device)
            self._aot_status, packed = self._aot.load(
                "predict", key, self.device,
                decode=lambda p: _decode_pack(p, self.device, len(trees),
                                              F, self.max_batch))
        if packed is not None:
            self.space, self.forest = packed
        else:
            self.space = ServeBinSpace(trees, F, self.device)
            class_ids = np.asarray([i % K for i in range(len(trees))],
                                   np.int32)
            self.forest = self.space.pack(trees, class_ids)
            if self._aot is not None:
                self._aot.save("predict", key,
                               _encode_pack(self.space, self.forest,
                                            self.max_batch),
                               device=self.device,
                               note={"trees": len(trees), "K": K, "F": F})
        self._device_fn = forest_predict_fn(self.space.meta, K,
                                            self.early_stop)
        # on the card every bucket's walk is one CUDA graph (captured at
        # warm-up); the CPU walks eagerly
        self._graphs = None
        if self.device.type == "cuda":
            from .aot import BucketGraphs
            self._graphs = BucketGraphs(
                lambda bins: self._device_fn(self.forest, bins), self.device,
                "predict", [(lambda b: (b, F), torch.int32)])

        # ---- serving state ---------------------------------------------
        self._degraded = False
        self._degraded_error = ""
        self._closed = False
        self._lock = threading.Lock()
        self._lat_ms: list = []
        self._n_req = 0
        self._n_ok = 0
        self._n_deadline = 0
        self._n_overload = 0
        self._n_failed = 0
        self._batches = 0
        self._real_rows = 0
        self._padded_rows = 0
        self._buckets: set = set()
        self.events: deque = deque(maxlen=_EVENTS_KEPT)
        self._t_start = time.time()
        self.slo_p99_ms = float(_env_num(
            "LGBM_TPU_SERVE_SLO_P99_MS", float, cfg.tpu_serve_slo_p99_ms))
        # replicas of one version share one ServeMetrics (the router
        # passes it in), so the fleet's histogram aggregates
        self.metrics = (metrics if metrics is not None
                        else ServeMetrics(slo_p99_ms=self.slo_p99_ms))
        # while degraded, re-probe the device every reprobe_s (0 disables)
        self.reprobe_s = float(_env_num(
            "LGBM_TPU_SERVE_REPROBE_S", float, cfg.tpu_serve_reprobe_s))
        self._last_probe = 0.0
        # priority shedding: per-class queue budgets, low sheds first
        self._shed_fracs = {
            "low": float(_env_num("LGBM_TPU_SERVE_SHED_LOW_FRAC", float,
                                  cfg.tpu_serve_shed_low_frac)),
            "normal": float(_env_num("LGBM_TPU_SERVE_SHED_NORMAL_FRAC", float,
                                     cfg.tpu_serve_shed_normal_frac)),
        }
        # drift: "auto" arms for a model file with a quality sidecar
        # (and tpu_drift on); a router passes one monitor for its replicas
        if drift == "auto":
            from ..obs.drift import DriftMonitor
            self._drift = DriftMonitor.maybe_load(model, self.config)
        else:
            self._drift = drift or None
        if cfg.tpu_trace:
            obs.enable_trace()
        if not obs.flight_enabled():
            obs.enable_flight(obs.flight_len_from_env(cfg.tpu_flight_len))
        self._overload_times: deque = deque(maxlen=_STORM_N)
        self._last_flight_dump = None  # monotonic() of the last dump
        self._batcher = MicroBatcher(
            self._execute_batch, max_batch=self.max_batch,
            max_wait_s=self.max_wait_ms / 1e3,
            max_queue_rows=self.queue_depth, shed_fracs=self._shed_fracs)
        obs.event("serve_start", trees=self.num_trees, num_class=K,
                  num_features=F, max_batch=self.max_batch,
                  max_wait_ms=self.max_wait_ms, queue_depth=self.queue_depth)

    # ------------------------------------------------------------------
    _bucket_sweep = staticmethod(bucket_sweep)

    def _event(self, name: str, **fields) -> None:
        """A state transition: kept in ``events`` and sent to telemetry
        (and the flight ring)."""
        self.events.append(dict(fields, event=name, t=time.time()))
        obs.event(name, **fields)

    def _flight_dump(self, reason: str, force: bool = False) -> None:
        """A flight-ring dump at most once a cooldown (``force`` ignores
        it; no-op without the ring)."""
        now = time.monotonic()
        with self._lock:
            if (not force and self._last_flight_dump is not None
                    and now - self._last_flight_dump < _STORM_COOLDOWN_S):
                return
            self._last_flight_dump = now
        if obs.flight_enabled():
            obs.flight_dump(reason, extra={"stats": self.stats()})

    def _observe_drift(self, X, raw, check: bool = True) -> None:
        """Feed the drift monitor (raw rows, raw scores); a monitor
        failure never fails serving."""
        if self._drift is None:
            return
        try:
            if X is not None:
                self._drift.observe(X, raw)
            if check:
                self._drift.maybe_check()
        except Exception as exc:  # noqa: BLE001
            log.warning("drift observe failed: %s", exc)

    def warmup(self) -> int:
        """Run every bucket shape up to the batch cap once.  On the card
        each bucket's walk is captured as a CUDA graph first, so requests
        replay and never capture; a capture that fails raises
        ``DeviceFailed``.  One row goes through the host binning too, so
        its lazy loads (the native binning library) are not request #1's.
        Returns the bucket count."""
        self.space.bin_matrix(np.zeros((1, self.num_features)))
        n = 0
        for size in bucket_sweep(self.max_batch):
            _capture(self._graphs, size, "predict")
            self._run_device(np.zeros((size, self.num_features), np.int32))
            n += 1
        return n

    def _bucket(self, n: int) -> int:
        return pow2_bucket(n, self.max_batch)

    def _run_device(self, bins: np.ndarray, pad: bool = True):
        """Pad to the pow2 bucket, walk the forest on the device, slice
        the pad off.  Returns ([n, K] f64 raw scores, bucket).  On the card
        a bucket's walk is its CUDA graph's replay.  With ``pad=False``
        the rows are walked as they are, eagerly (bucket None): an input
        above the batch cap, a walk no bucket's graph covers."""
        n = bins.shape[0]
        b = self._bucket(n) if pad else None
        if pad:
            if b > n:
                bins = np.concatenate(
                    [bins, np.zeros((b - n, bins.shape[1]), bins.dtype)])
            with self._lock:
                self._buckets.add(b)
        faults.check("serve_device")
        if pad and self._graphs is not None:
            out = self._graphs.run(b, bins)
        else:
            from .aot import GATE
            with GATE.walk():
                out = self._device_fn(self.forest, torch.from_numpy(
                    bins).to(self.device)).cpu().numpy()
        raw = out.astype(np.float64)[:n]
        if self.average_factor:
            raw /= self.average_factor
        return raw, b

    def _run_host(self, X: np.ndarray) -> np.ndarray:
        """The value-space host walk: the canary gate's parity oracle
        (``serve/registry.py``), never a served answer."""
        K = self.num_tpi
        out = np.zeros((X.shape[0], K))
        for i, tree in enumerate(self._trees):
            out[:, i % K] += tree.predict(X)
        if self.average_factor:
            out /= self.average_factor
        return out

    # ---- degradation: fail, re-probe, recover -------------------------
    @staticmethod
    def _failed(plane: str, exc: BaseException) -> DeviceFailed:
        return DeviceFailed(f"{plane} device batch failed "
                            f"({type(exc).__name__}: {exc})")

    def _refusal(self, plane: str, error: str) -> DeviceFailed:
        wait = (f"next device re-probe within {self.reprobe_s:g} s"
                if self.reprobe_s > 0 else "device re-probing is off")
        return DeviceFailed(f"session is degraded ({plane}: {error}); {wait}")

    def _note_degraded(self, exc: BaseException) -> None:
        if not self._degraded:
            self._degraded = True
            self._degraded_error = f"{type(exc).__name__}: {exc}"
            self._last_probe = time.monotonic()
            self.metrics.set_degraded(True)
            log.warning("serve: device predictor failed (%s); its requests "
                        "fail until a device re-probe succeeds%s",
                        self._degraded_error,
                        (" (every %.3g s)" % self.reprobe_s
                         if self.reprobe_s > 0 else " (re-probing is off)"))
            self._event("serve_degraded", error=self._degraded_error)
            self._flight_dump("serve_degraded", force=True)

    def _maybe_reprobe(self) -> bool:
        """While degraded, run one one-row device batch every reprobe_s;
        success ends the degradation.  True when it recovered."""
        if not self._degraded or self.reprobe_s <= 0:
            return False
        now = time.monotonic()
        with self._lock:
            if now - self._last_probe < self.reprobe_s:
                return False
            self._last_probe = now
        try:
            self._run_device(np.zeros((1, self.num_features), np.int32))
        except Exception as exc:  # noqa: BLE001 — stay degraded
            self._event("serve_probe", ok=False,
                        error=f"{type(exc).__name__}: {exc}")
            return False
        self._degraded = False
        self.metrics.set_degraded(False)
        self._event("serve_probe", ok=True)
        self._event("serve_recovered")
        log.info("serve: device probe succeeded; device predictions resume")
        return True

    def _check_device(self) -> None:
        """Raise ``DeviceFailed`` while the predict plane is degraded and
        its re-probe (tried here when due) does not recover it."""
        if self._degraded:
            self._maybe_reprobe()
            if self._degraded:
                raise self._refusal("predict", self._degraded_error)

    def _note_degraded_explain(self, exc: BaseException) -> None:
        if not self._explain_degraded:
            self._explain_degraded = True
            self._explain_error = f"{type(exc).__name__}: {exc}"
            self._last_explain_probe = time.monotonic()
            log.warning("serve: device TreeSHAP pass failed (%s); explain "
                        "requests fail until a device re-probe succeeds",
                        self._explain_error)
            self._event("serve_degraded", plane="explain",
                        error=self._explain_error)
            self._flight_dump("serve_degraded", force=True)

    def _maybe_reprobe_explain(self) -> bool:
        """Explain twin of ``_maybe_reprobe``: the probe runs the TreeSHAP
        pass itself (a 1-row predict proves nothing about its working
        set)."""
        if not self._explain_degraded or self.reprobe_s <= 0:
            return False
        now = time.monotonic()
        with self._lock:
            if now - self._last_explain_probe < self.reprobe_s:
                return False
            self._last_explain_probe = now
        try:
            self._run_device_explain(
                np.zeros((1, self.num_features), np.int32))
        except Exception as exc:  # noqa: BLE001 — stay degraded
            self._event("serve_probe", plane="explain", ok=False,
                        error=f"{type(exc).__name__}: {exc}")
            return False
        self._explain_degraded = False
        self._event("serve_probe", plane="explain", ok=True)
        self._event("serve_recovered", plane="explain")
        log.info("serve: TreeSHAP probe succeeded; device explanations "
                 "resume")
        return True

    def _check_explain_device(self) -> None:
        self._check_device()
        if self._explain_degraded:
            self._maybe_reprobe_explain()
            if self._explain_degraded:
                raise self._refusal("explain", self._explain_error)

    def _note_overload(self, rows: int, queue_rows: int,
                       priority: str = "normal") -> None:
        """Overload accounting; a storm (``_STORM_N`` rejects inside
        ``_STORM_WINDOW_S``) dumps the flight ring."""
        now = time.monotonic()
        with self._lock:
            self._n_overload += 1
            self._overload_times.append(now)
            storm = (len(self._overload_times) == _STORM_N
                     and now - self._overload_times[0] <= _STORM_WINDOW_S)
        if self.replica_id is None:
            # sheds count client-visible rejections: inside a router a
            # sibling may still take the request, so the router counts
            self.metrics.count_shed(priority)
        self._event("serve_overload", rows=int(rows), queue_rows=queue_rows,
                    priority=priority)
        if storm:
            self._flight_dump("overload_storm")

    def _note_refused(self, exc: DeviceFailed, explain: bool) -> None:
        """A submit refused by a degraded plane: a failed request, unless
        a router may still place it on a sibling (the router counts)."""
        if self.replica_id is not None:
            return
        with self._lock:
            if explain:
                self._n_explain += 1
            else:
                self._n_req += 1
                self._n_failed += 1
        (self.metrics.observe_explain if explain
         else self.metrics.observe)(0.0, ok=False)

    def _convert(self, raw: np.ndarray, raw_score: bool) -> np.ndarray:
        squeezed = raw if self.num_tpi > 1 else raw[:, 0]
        if raw_score or self.objective is None:
            return squeezed
        return np.asarray(self.objective.convert_output(squeezed))

    # ------------------------------------------------------------------
    def predict(self, X, raw_score: bool = False) -> np.ndarray:
        """Synchronous prediction, bypassing the queue.  Up to
        ``max_batch`` rows pad to their pow2 bucket, as a queued batch
        does; a larger input is walked whole in one device call (the walk
        takes it in row spans, ``core/forest.py``), where the JAX package
        cuts it into ``max_batch`` buckets to bound its compile set: the
        port compiles nothing per shape, and each walk costs ~650
        launches whatever its rows.  Raises ``DeviceFailed`` when the
        device cannot answer."""
        X = self._check_input(X)
        if not raw_score and self.objective_error:
            log.fatal(self.objective_error)
        t0 = time.perf_counter()
        try:
            self._check_device()
            try:
                raw = (self._run_device(self.space.bin_matrix(X),
                                        pad=X.shape[0] <= self.max_batch)[0]
                       if X.shape[0] else np.zeros((0, self.num_tpi)))
            except Exception as exc:  # noqa: BLE001 — the failure point
                self._note_degraded(exc)
                raise self._failed("predict", exc) from exc
        except DeviceFailed:
            with self._lock:
                self._n_req += 1
                self._n_failed += 1
            self.metrics.observe((time.perf_counter() - t0) * 1e3, ok=False)
            raise
        self._note_request(X.shape[0], (time.perf_counter() - t0) * 1e3)
        self._observe_drift(X, raw)
        return self._convert(raw, raw_score)

    # ------------------------------------------------------------------
    # explanation serving: the batched TreeSHAP pass (explain/)
    # ------------------------------------------------------------------
    def _ensure_explain(self):
        """Pack the TreeSHAP state on first use: per-leaf path metadata
        (zero fractions from the trees' cover counts) and a second
        microbatcher with its own pow2 bucket family.  Raises on a model
        without cover counts or when explaining is disabled."""
        if not self.explain_enabled:
            raise RuntimeError(
                "explanation serving is disabled (tpu_explain=false)")
        got = self._explain
        if got is not None:
            return got
        with self._explain_lock:
            if self._explain is None:
                from ..explain import forest_shap_fn, stack_explain
                K, F = self.num_tpi, self.num_features
                trees_np = [self.space.tree_arrays_np(t, with_counts=True)
                            for t in self._trees]
                arrays = stack_explain(trees_np, F, self.device)
                # the pass reads the predict forest's decision arrays; the
                # counts ride only in the path metadata
                fn = forest_shap_fn(self.space.meta, K, F)
                batcher = MicroBatcher(
                    self._execute_explain_batch,
                    max_batch=self.explain_max_batch,
                    max_wait_s=self.explain_max_wait_ms / 1e3,
                    max_queue_rows=self.queue_depth,
                    name="lgbm-serve-explain", shed_fracs=self._shed_fracs)
                graphs = None
                if self.device.type == "cuda":
                    from .aot import BucketGraphs
                    forest = self.forest
                    graphs = BucketGraphs(
                        lambda bins: fn(forest, arrays, bins), self.device,
                        "explain", [(lambda b: (b, F), torch.int32)])
                self._explain = (self.forest, arrays, fn, batcher, graphs)
        return self._explain

    def warmup_explain(self) -> int:
        """Run every explain bucket shape once, each captured as a CUDA
        graph first on the card (``warmup``'s rule).  Returns the
        count."""
        graphs = self._ensure_explain()[4]
        n = 0
        for size in bucket_sweep(self.explain_max_batch):
            _capture(graphs, size, "explain")
            self._run_device_explain(
                np.zeros((size, self.num_features), np.int32))
            n += 1
        return n

    def _bucket_explain(self, n: int) -> int:
        return pow2_bucket(n, self.explain_max_batch)

    def _run_device_explain(self, bins: np.ndarray):
        """Pad to the explain pow2 bucket, run the TreeSHAP pass, slice
        the pad off.  Returns ([n, K, F+1] f64 contributions, bucket)."""
        forest, arrays, fn, _, graphs = self._ensure_explain()
        n = bins.shape[0]
        b = self._bucket_explain(n)
        if b > n:
            bins = np.concatenate(
                [bins, np.zeros((b - n, bins.shape[1]), bins.dtype)])
        with self._lock:
            self._explain_buckets.add(b)
        faults.check("serve_explain_device")
        if graphs is not None:
            out = graphs.run(b, bins)
        else:
            from .aot import GATE
            with GATE.walk():
                out = fn(forest, arrays, torch.from_numpy(bins).to(
                    self.device)).cpu().numpy()
        return out.astype(np.float64)[:n], b

    def _convert_explain(self, contrib: np.ndarray) -> np.ndarray:
        """[n, K, F+1] -> the ``predict_contrib`` layout: [n, F+1], or
        [n, K*(F+1)] for K trees an iteration (raw-score space)."""
        n, K = contrib.shape[0], self.num_tpi
        return (contrib.reshape(n, K * (self.num_features + 1))
                if K > 1 else contrib[:, 0, :])

    def explain(self, X) -> np.ndarray:
        """Synchronous SHAP contributions, bypassing the queue (still
        bucketed).  Raises ``DeviceFailed`` when the device cannot
        answer."""
        X = self._check_input(X)
        self._ensure_explain()
        t0 = time.perf_counter()
        K, F = self.num_tpi, self.num_features
        out = np.zeros((X.shape[0], K, F + 1))
        try:
            self._check_explain_device()
            for lo in range(0, X.shape[0], self.explain_max_batch):
                chunk = X[lo:lo + self.explain_max_batch]
                try:
                    out[lo:lo + chunk.shape[0]] = self._run_device_explain(
                        self.space.bin_matrix(chunk))[0]
                except Exception as exc:  # noqa: BLE001 — the failure point
                    self._note_degraded_explain(exc)
                    raise self._failed("explain", exc) from exc
        except DeviceFailed:
            with self._lock:
                self._n_explain += 1
            self.metrics.observe_explain((time.perf_counter() - t0) * 1e3,
                                         ok=False)
            raise
        self._note_explain_request(X.shape[0],
                                   (time.perf_counter() - t0) * 1e3)
        return self._convert_explain(out)

    def submit_explain(self, X, deadline_ms: Optional[float] = None,
                       trace_id: Optional[str] = None,
                       parent_id: Optional[str] = None,
                       priority: str = "normal") -> Ticket:
        """Queue rows for the next coalesced TreeSHAP batch: ``submit``'s
        chunking, deadline, backpressure and shedding, with its own queue
        and buckets.  ``trace_id``/``parent_id`` place its spans in a
        trace."""
        X = self._check_input(X)
        if self._closed:
            raise RuntimeError("session is closed")
        faults.check("serve_explain_submit")
        priority = normalize_priority(priority)
        batcher = self._ensure_explain()[3]
        try:
            self._check_explain_device()
        except DeviceFailed as exc:
            self._note_refused(exc, explain=True)
            raise
        deadline = (time.monotonic() + float(deadline_ms) / 1e3
                    if deadline_ms is not None else None)
        parts = []
        try:
            for lo in range(0, max(X.shape[0], 1), self.explain_max_batch):
                chunk = X[lo:lo + self.explain_max_batch]
                req = Request(self.space.bin_matrix(chunk), chunk,
                              deadline=deadline, trace_id=trace_id,
                              parent_id=parent_id, priority=priority)
                parts.append((batcher.submit(req), chunk.shape[0]))
        except ServeOverloadError:
            self._note_overload(X.shape[0], batcher.queue_rows,
                                priority=priority)
            for fut, _ in parts:    # a partly queued ticket must not leak
                fut.cancel()
            raise
        return Ticket(parts, int(X.shape[0]), False, kind="explain",
                      priority=priority)

    def _execute_explain_batch(self, reqs) -> None:
        """Explain batcher callback: expire, coalesce, pad, run the
        TreeSHAP pass, split; a failed pass fails the batch."""
        live = live_requests(reqs)
        if not live:
            return
        rows = sum(r.n for r in live)
        self._queue_spans(live, rows, "explain")
        bucket = 0
        t0 = time.perf_counter()
        try:
            self._check_explain_device()
            bins = (live[0].bins if len(live) == 1
                    else np.concatenate([r.bins for r in live]))
            try:
                contrib, bucket = self._run_device_explain(bins)
            except Exception as exc:  # noqa: BLE001 — the failure point
                self._note_degraded_explain(exc)
                raise self._failed("explain", exc) from exc
        except DeviceFailed as exc:
            for r in live:
                _safe_resolve(r.future, error=exc)
            return
        off = 0
        for r in live:
            _safe_resolve(r.future, result=contrib[off:off + r.n])
            off += r.n
        with self._lock:
            self._explain_batches += 1
            self._explain_rows += rows
            self._explain_padded += bucket
        obs.event("explain_batch", rows=rows, padded=int(bucket),
                  requests=len(live),
                  exec_ms=round((time.perf_counter() - t0) * 1e3, 3),
                  degraded=False)

    def _note_explain_request(self, rows: int, total_ms: float,
                              priority: str = "normal") -> None:
        with self._lock:
            self._n_explain += 1
            self._n_explain_ok += 1
            self._xlat_ms.append(total_ms)
            if len(self._xlat_ms) > _LAT_RESERVOIR:
                del self._xlat_ms[:_LAT_RESERVOIR // 2]
        self.metrics.observe_explain(total_ms, ok=True)
        self.metrics.count_served(priority)
        obs.event("explain_request", rows=int(rows),
                  total_ms=round(total_ms, 3), ok=True)

    # ------------------------------------------------------------------
    def submit(self, X, deadline_ms: Optional[float] = None,
               raw_score: bool = False, trace_id: Optional[str] = None,
               parent_id: Optional[str] = None,
               priority: str = "normal") -> Ticket:
        """Queue rows for the next coalesced batch.  Raises
        ``ServeOverloadError`` when the bounded queue (or this priority
        class's share of it) is full, and ``DeviceFailed`` while the
        session is degraded.  Oversize submissions are chunked to the
        batch cap; a chunk is never split across device batches."""
        X = self._check_input(X)
        if self._closed:
            raise RuntimeError("session is closed")
        if not raw_score and self.objective_error:
            log.fatal(self.objective_error)
        priority = normalize_priority(priority)
        try:
            self._check_device()
        except DeviceFailed as exc:
            self._note_refused(exc, explain=False)
            raise
        deadline = (time.monotonic() + float(deadline_ms) / 1e3
                    if deadline_ms is not None else None)
        parts = []
        try:
            for lo in range(0, max(X.shape[0], 1), self.max_batch):
                chunk = X[lo:lo + self.max_batch]
                req = Request(self.space.bin_matrix(chunk), chunk,
                              deadline=deadline, trace_id=trace_id,
                              parent_id=parent_id, priority=priority)
                parts.append((self._batcher.submit(req), chunk.shape[0]))
        except ServeOverloadError:
            self._note_overload(X.shape[0], self._batcher.queue_rows,
                                priority=priority)
            for fut, _ in parts:    # a partly queued ticket must not leak
                fut.cancel()
            raise
        return Ticket(parts, int(X.shape[0]), raw_score, priority=priority)

    def result(self, ticket: Ticket, timeout: Optional[float] = None
               ) -> np.ndarray:
        """Block for a ticket's predictions (converted like ``predict``).
        Raises what the batch raised: ``DeadlineExceeded`` for a request
        that outlived its deadline, ``DeviceFailed`` for a failed device
        batch.  Request-level accounting happens here, once a ticket."""
        end = None if timeout is None else time.monotonic() + timeout
        chunks = []
        try:
            for fut, _ in ticket.parts:
                left = (None if end is None
                        else max(end - time.monotonic(), 0.0))
                chunks.append(fut.result(left))
        except BaseException as exc:
            self._note_failure(ticket, exc)
            raise
        raw = chunks[0] if len(chunks) == 1 else np.concatenate(chunks)
        total_ms = (time.perf_counter() - ticket.t0) * 1e3
        if ticket.kind == "explain":
            if not ticket.counted:
                ticket.counted = True
                self._note_explain_request(ticket.rows, total_ms,
                                           priority=ticket.priority)
            return self._convert_explain(raw)
        if not ticket.counted:
            ticket.counted = True
            self._note_request(ticket.rows, total_ms,
                               priority=ticket.priority)
        return self._convert(raw, ticket.raw_score)

    def _note_failure(self, ticket: Ticket, exc: BaseException) -> None:
        if ticket.counted:
            return
        ticket.counted = True
        deadline = isinstance(exc, DeadlineExceeded)
        reason = "deadline" if deadline else type(exc).__name__
        total_ms = (time.perf_counter() - ticket.t0) * 1e3
        if ticket.kind == "explain":
            with self._lock:
                self._n_explain += 1
                self._n_explain_deadline += deadline
            self.metrics.observe_explain(total_ms, ok=False)
            obs.event("explain_request", rows=int(ticket.rows),
                      total_ms=round(total_ms, 3), ok=False,
                      reason=reason)
            return
        with self._lock:
            self._n_req += 1
            self._n_deadline += deadline
            self._n_failed += not deadline
        self.metrics.observe(total_ms, ok=False)
        obs.event("serve_request", rows=int(ticket.rows),
                  total_ms=round(total_ms, 3), ok=False, reason=reason)

    # ------------------------------------------------------------------
    def _execute_batch(self, reqs) -> None:
        """Batcher callback: expire, coalesce, pad, dispatch, split; a
        failed device call fails the batch's requests."""
        live = live_requests(reqs)
        if not live:
            return
        rows = sum(r.n for r in live)
        span_ctx = self._queue_spans(live, rows, "serve")
        bucket = 0
        t0 = time.perf_counter()
        t_exec0 = time.time()
        try:
            self._check_device()
            bins = (live[0].bins if len(live) == 1
                    else np.concatenate([r.bins for r in live]))
            try:
                raw, bucket = self._run_device(bins)
            except Exception as exc:  # noqa: BLE001 — the failure point
                self._note_degraded(exc)
                raise self._failed("predict", exc) from exc
        except DeviceFailed as exc:
            for r in live:
                _safe_resolve(r.future, error=exc)
            return
        exec_ms = (time.perf_counter() - t0) * 1e3
        for tid, pid in span_ctx or ():
            # padding, the device walk and the scores' copy back
            obs.emit_span("serve/device_execute", t_exec0, exec_ms, tid,
                          parent_id=pid, attrs={"rows": rows,
                                                "bucket": bucket})
        # before the futures resolve (a buffered append), so a caller that
        # saw its result can force a check with this batch in the sketch
        self._observe_drift([r.raw for r in live], raw, check=False)
        off = 0
        for r in live:
            _safe_resolve(r.future, result=raw[off:off + r.n])
            off += r.n
        self._observe_drift(None, None)
        with self._lock:
            self._batches += 1
            self._real_rows += rows
            self._padded_rows += bucket
        obs.event("serve_batch", rows=rows, padded=int(bucket),
                  requests=len(live), queue_rows=self._batcher.queue_rows,
                  exec_ms=round(exec_ms, 3), degraded=False)

    @staticmethod
    def _queue_spans(live, rows: int, plane: str):
        """Each request's queue-wait and coalesce spans; returns the
        (trace id, parent) of each for the batch's later spans, or None
        when no span is recorded."""
        if not obs.span_record_enabled():
            return None
        now = time.monotonic()
        t_dispatch = time.time()
        ctx = []
        for r in live:
            tid = r.trace_id or obs.new_trace_id()
            obs.emit_span(f"{plane}/queue_wait", r.t_submit_wall,
                          (now - r.t_submit) * 1e3, tid,
                          parent_id=r.parent_id, attrs={"rows": r.n})
            obs.emit_span(f"{plane}/coalesce", r.t_submit_wall,
                          max(t_dispatch - r.t_submit_wall, 0.0) * 1e3,
                          tid, parent_id=r.parent_id,
                          attrs={"requests": len(live), "rows": rows})
            ctx.append((tid, r.parent_id))
        return ctx

    def _check_input(self, X) -> np.ndarray:
        return as_rows(X, self.num_features)

    def _note_request(self, rows: int, total_ms: float,
                      priority: str = "normal") -> None:
        with self._lock:
            self._n_req += 1
            self._n_ok += 1
            self._lat_ms.append(total_ms)
            if len(self._lat_ms) > _LAT_RESERVOIR:
                del self._lat_ms[:_LAT_RESERVOIR // 2]
        self.metrics.observe(total_ms, ok=True)
        self.metrics.count_served(priority)
        obs.event("serve_request", rows=int(rows),
                  total_ms=round(total_ms, 3), ok=True)

    # ------------------------------------------------------------------
    def resident_bytes(self) -> int:
        """Device bytes of this session's packed model: the stacked forest
        and, once armed, the TreeSHAP path metadata (tensor ``nbytes``)."""
        total = _tensor_bytes(self.forest)
        if self._explain is not None:
            total += _tensor_bytes(self._explain[1])
        return total

    def stats(self) -> dict:
        """Serving counters and latency percentiles (``/health``,
        ``/stats``).  The JAX package's ``compile_count`` is left out (the
        port compiles nothing per bucket); ``graph_captures`` counts this
        session's CUDA graphs (none on the CPU) and ``aot`` is the store's
        counters with this session's load status, None when unarmed.
        ``drift`` is the monitor's status (None when unarmed)."""
        with self._lock:
            lat = sorted(self._lat_ms)
            xlat = sorted(self._xlat_ms)
            padded = self._padded_rows
            return {
                "explain_enabled": self.explain_enabled,
                "explain_armed": self._explain is not None,
                "explain_requests": self._n_explain,
                "explain_ok": self._n_explain_ok,
                "explain_batches": self._explain_batches,
                "explain_rows": self._explain_rows,
                "explain_padded_rows": self._explain_padded,
                "explain_occupancy": (
                    round(self._explain_rows / self._explain_padded, 4)
                    if self._explain_padded else None),
                "explain_p50_ms": percentile(xlat, 0.50),
                "explain_p99_ms": percentile(xlat, 0.99),
                "explain_buckets": sorted(self._explain_buckets),
                "explain_max_batch": self.explain_max_batch,
                "explain_deadline_missed": self._n_explain_deadline,
                "explain_degraded": self._explain_degraded,
                "requests": self._n_req,
                "ok": self._n_ok,
                "failed": self._n_failed,
                "deadline_missed": self._n_deadline,
                "overloads": self._n_overload,
                "batches": self._batches,
                "rows": self._real_rows,
                "padded_rows": padded,
                "occupancy": (round(self._real_rows / padded, 4)
                              if padded else None),
                "p50_ms": percentile(lat, 0.50),
                "p99_ms": percentile(lat, 0.99),
                "buckets": sorted(self._buckets),
                "queue_rows": (0 if self._closed
                               else self._batcher.queue_rows),
                "degraded": self._degraded,
                "trees": self.num_trees,
                "num_class": self.num_tpi,
                "num_features": self.num_features,
                "max_batch": self.max_batch,
                "device": str(self.device),
                "uptime_s": round(time.time() - self._t_start, 1),
                "slo_p99_ms": self.slo_p99_ms or None,
                "slo_burn": self.metrics.slo_burn(),
                "reprobe_s": self.reprobe_s or None,
                "degraded_transitions": self.metrics.degraded_transitions,
                "recoveries": self.metrics.recoveries,
                "model": self.model_name,
                "version": self.model_version,
                "replica": self.replica_id,
                "resident_bytes": self.resident_bytes(),
                "drift": (self._drift.status()
                          if self._drift is not None else None),
                "graph_captures": self._graph_captures(),
                "graph_buckets": ([] if self._graphs is None
                                  else self._graphs.buckets()),
                "aot": (None if self._aot is None else {
                    **self._aot.stats(), "status": self._aot_status}),
            }

    def _graph_captures(self) -> int:
        n = 0 if self._graphs is None else self._graphs.captures
        if self._explain is not None and self._explain[4] is not None:
            n += self._explain[4].captures
        return n

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self._batcher.close()
            if self._explain is not None:
                self._explain[3].close()
                if self._explain[4] is not None:
                    self._explain[4].free()
            if self._graphs is not None:
                self._graphs.free()

    def __enter__(self) -> "PredictorSession":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
