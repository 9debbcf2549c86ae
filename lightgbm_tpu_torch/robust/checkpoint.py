"""Atomic, versioned training checkpoints with bit-exact resume
(counterpart of lightgbm_tpu/robust/checkpoint.py, same layout).

One checkpoint is one directory ``ckpt_{iteration:08d}/`` holding:

- ``model.txt`` — the forest as model text (shortest round-trip floats:
  the f64 leaf and threshold values reload bit for bit);
- ``state.npz`` — what cannot be replayed without rounding drift: the
  f32 train and valid scores copied verbatim from the device, and the
  bagging mask;
- ``meta.json`` — the iteration, the trainer's RNG and weight state
  (``GBDT.checkpoint_state``; DART adds its drop RNG and tree weights),
  the recorded eval history (replayed through the stateful callbacks on
  resume), a digest of the training config (a mismatch refuses the
  resume) and sha256 checksums of the other two files.

Writes go to a temporary directory: every file fsynced, then
``os.rename`` (atomic on POSIX), then the parent directory fsynced.  A
crash mid-write leaves a ``.tmp-*`` orphan the next save sweeps; a
corrupt or truncated checkpoint fails its checksum and the loader takes
the next newest.  Each write and restore is a telemetry event
(``checkpoint``, ``restore``), also kept in ``events``.
"""
from __future__ import annotations

import dataclasses
import glob
import hashlib
import json
import os
import re
import shutil
import time
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from .. import obs
from ..utils import log
from . import faults

_CKPT_RE = re.compile(r"ckpt_(\d{8})$")
FORMAT_VERSION = 1

# config fields that may differ between the crashed and the resuming run
# without changing the trajectory (the JAX package's list)
_DIGEST_SKIP = frozenset((
    "config", "task", "output_model", "output_result", "input_model",
    "snapshot_freq", "verbosity", "convert_model",
    "tpu_checkpoint_dir", "tpu_checkpoint_freq", "tpu_checkpoint_keep",
    "tpu_telemetry", "tpu_profile", "tpu_trace", "tpu_flight_len",
    "tpu_health", "tpu_fingerprint_freq", "tpu_compile_cache_dir",
    "tpu_watchdog", "tpu_on_device_error", "tpu_device_retries",
    "tpu_wedge_timeout_s",
    # same trees either way (the oracles and the device NDCG)
    "tpu_fused_sibling", "tpu_batched_split_apply", "tpu_fused_grad",
    "tpu_rank_device_eval", "tpu_rank_sharded_grad",
    "tpu_ingest", "tpu_ingest_chunk_rows", "tpu_ingest_memmap",
    "is_parallel",
))

# world-shape knobs, neutralized (hashed at their defaults) when
# ``tpu_fleet`` is set: a fleet checkpoint resumes at any world size,
# world 1 included; outside a fleet they still refuse a resume, since
# they change the local rows
_DIGEST_SKIP_FLEET_WORLD = frozenset((
    "tpu_ingest_shards", "tpu_ingest_shard_id",
    "num_machines", "machines", "machine_list_filename",
    "local_listen_port", "time_out",
))


def config_digest(config) -> str:
    """Stable hash of the training-relevant config surface; the histogram
    mode hashes resolved, so its aliases never refuse a resume."""
    fleet = bool(getattr(config, "tpu_fleet", 0))
    items = {}
    for f in dataclasses.fields(config):
        if f.name in _DIGEST_SKIP or f.name.startswith("tpu_fleet"):
            continue
        v = getattr(config, f.name)
        if fleet and f.name in _DIGEST_SKIP_FLEET_WORLD:
            v = f.default
        if isinstance(v, (list, tuple)):
            v = list(v)
        if f.name == "tpu_hist_dtype":
            v = config.hist_mode()
        items[f.name] = v
    blob = json.dumps(items, sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def _world_size() -> int:
    """The world size stamped into a checkpoint's meta, for post-mortems
    of a fleet; never part of the digest (a shrunk-world resume is the
    point of the elastic fleet)."""
    from ..parallel.distributed import world_size
    return int(world_size())


def _sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        for chunk in iter(lambda: fh.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _fsync_write(path: str, data, binary: bool = False) -> None:
    with open(path, "wb" if binary else "w") as fh:
        fh.write(data)
        fh.flush()
        os.fsync(fh.fileno())


def _fsync_dir(path: str) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
    except OSError:  # platforms without directory fsync
        pass


@dataclass
class RestoreState:
    iteration: int
    path: str
    eval_history: List[Tuple] = field(default_factory=list)
    meta: dict = field(default_factory=dict)


class CheckpointManager:
    """One checkpoint directory: periodic save, prune, scan, validate,
    restore."""

    def __init__(self, ckpt_dir: str, freq: int = 100, keep: int = 3,
                 digest: Optional[str] = None):
        self.dir = ckpt_dir
        self.freq = max(int(freq), 0)
        self.keep = max(int(keep), 1)
        # taken from the pristine config: a learning-rate schedule
        # changes booster.config mid-run
        self.digest = digest
        self.events: List[dict] = []

    @classmethod
    def from_config(cls, config) -> Optional["CheckpointManager"]:
        if not config.tpu_checkpoint_dir:
            return None
        return cls(config.tpu_checkpoint_dir,
                   freq=config.tpu_checkpoint_freq,
                   keep=config.tpu_checkpoint_keep,
                   digest=config_digest(config))

    def should_save(self, iteration: int) -> bool:
        return self.freq > 0 and iteration > 0 and iteration % self.freq == 0

    def list_checkpoints(self) -> List[str]:
        """Checkpoint directories, newest iteration first."""
        out = []
        for d in glob.glob(os.path.join(self.dir, "ckpt_*")):
            m = _CKPT_RE.search(os.path.basename(d))
            if m and os.path.isdir(d):
                out.append((int(m.group(1)), d))
        return [d for _, d in sorted(out, reverse=True)]

    def trim_to(self, iteration: int) -> int:
        """Drop every checkpoint newer than ``iteration`` (the elastic
        rollback: survivors agree on the newest common iteration and trim
        to it, so the auto-resume lands there on every rank); returns the
        number removed."""
        removed = 0
        for d in self.list_checkpoints():
            m = _CKPT_RE.search(os.path.basename(d))
            if m and int(m.group(1)) > int(iteration):
                shutil.rmtree(d, ignore_errors=True)
                removed += 1
                log.info("checkpoint: trimmed %s (rollback to iteration "
                         "%d)", d, iteration)
        return removed

    def _sweep_orphans(self) -> None:
        for d in glob.glob(os.path.join(self.dir, ".tmp-*")):
            shutil.rmtree(d, ignore_errors=True)

    def save(self, booster, iteration: int, eval_history=(),
             reason: str = "periodic") -> Optional[str]:
        """Write one atomic checkpoint; its path, or None when the write
        failed (a checkpoint must never end training)."""
        from ..io.model_io import model_to_string
        t0 = time.perf_counter()
        gbdt = booster._gbdt
        try:
            faults.check("checkpoint_write", iteration=iteration)
            os.makedirs(self.dir, exist_ok=True)
            self._sweep_orphans()
            model_txt = model_to_string(gbdt, num_iteration=-1)
            state_meta, arrays = gbdt.checkpoint_state()
            tmp = os.path.join(self.dir, f".tmp-{os.getpid()}-{iteration}")
            os.makedirs(tmp, exist_ok=True)
            _fsync_write(os.path.join(tmp, "model.txt"), model_txt)
            with open(os.path.join(tmp, "state.npz"), "wb") as fh:
                np.savez(fh, **arrays)
                fh.flush()
                os.fsync(fh.fileno())
            meta = {
                "kind": "lgbm_tpu_checkpoint",
                "format": FORMAT_VERSION,
                "iteration": int(iteration),
                "t": round(time.time(), 6),
                "reason": reason,
                "config_digest": self.digest or config_digest(booster.config),
                "num_data": int(gbdt.train_ds.num_data),
                "world_size": _world_size(),
                "num_class": int(gbdt.num_tpi),
                "best_iteration": int(booster.best_iteration),
                "eval_history": [[int(it), [list(e) for e in entries]]
                                 for it, entries in eval_history],
                "state": state_meta,
                "sha256": {name: _sha256_file(os.path.join(tmp, name))
                           for name in ("model.txt", "state.npz")},
            }
            _fsync_write(os.path.join(tmp, "meta.json"),
                         json.dumps(meta, indent=1))
            final = os.path.join(self.dir, f"ckpt_{iteration:08d}")
            if os.path.isdir(final):   # a re-save of the same iteration
                shutil.rmtree(final)
            os.rename(tmp, final)
            _fsync_dir(self.dir)
            self._prune(meta["config_digest"])
            ms = (time.perf_counter() - t0) * 1e3
            self.events.append({"event": "checkpoint",
                                "iteration": int(iteration), "path": final,
                                "ms": ms, "reason": reason})
            obs.event("checkpoint", iteration=int(iteration), path=final,
                      ms=round(ms, 3), reason=reason)
            log.info("checkpoint: wrote %s (%.1f ms, %s)", final, ms, reason)
            return final
        except Exception as exc:  # noqa: BLE001 — never end training
            log.warning("checkpoint write failed at iteration %d (%s: %s)",
                        iteration, type(exc).__name__, exc)
            return None

    def _prune(self, digest: Optional[str] = None) -> None:
        """Drop checkpoints past ``keep``; those of another config digest
        go first, whatever their iteration (a fresh run in a reused
        directory must not be shadowed by a previous run's)."""
        keep_pool = []
        for d in self.list_checkpoints():
            if digest is not None:
                try:
                    with open(os.path.join(d, "meta.json")) as fh:
                        have = json.load(fh).get("config_digest")
                except (OSError, ValueError):
                    have = None
                if have != digest:
                    log.warning("checkpoint prune: removing %s (written "
                                "under a different training config)", d)
                    shutil.rmtree(d, ignore_errors=True)
                    continue
            keep_pool.append(d)
        for d in keep_pool[self.keep:]:
            shutil.rmtree(d, ignore_errors=True)

    def _validate(self, path: str) -> Optional[dict]:
        """Meta of a structurally valid checkpoint (checksums included),
        else None."""
        try:
            with open(os.path.join(path, "meta.json")) as fh:
                meta = json.load(fh)
            if meta.get("kind") != "lgbm_tpu_checkpoint":
                return None
            if int(meta.get("format", -1)) > FORMAT_VERSION:
                log.warning("checkpoint %s has newer format %s; skipping",
                            path, meta.get("format"))
                return None
            for fname, want in (meta.get("sha256") or {}).items():
                if _sha256_file(os.path.join(path, fname)) != want:
                    log.warning("checkpoint %s: %s checksum mismatch "
                                "(corrupt or truncated); skipping",
                                path, fname)
                    return None
            return meta
        except (OSError, ValueError, KeyError) as exc:
            log.warning("checkpoint %s unreadable (%s); skipping", path, exc)
            return None

    def peek(self, config=None) -> Optional[Tuple[str, dict]]:
        """The newest valid checkpoint of this config: ``(path, meta)``,
        touching no trainer state.  A digest mismatch refuses the whole
        resume (older checkpoints are of the same run)."""
        want = self.digest or (config_digest(config)
                               if config is not None else None)
        for path in self.list_checkpoints():
            meta = self._validate(path)
            if meta is None:
                continue
            if want is not None and meta.get("config_digest") != want:
                log.warning("checkpoint %s was written under a different "
                            "training config (digest %s != %s); refusing "
                            "to resume, starting fresh", path,
                            meta.get("config_digest"), want)
                return None
            return path, meta
        return None

    def resume(self, booster, peeked: Tuple[str, dict]) -> RestoreState:
        """Load a peeked checkpoint into ``booster`` (after its valid sets
        are attached, so their score slots exist)."""
        from ..io.model_io import load_model_string
        path, meta = peeked
        gbdt = booster._gbdt
        if int(meta.get("num_data", -1)) != int(gbdt.train_ds.num_data):
            raise ValueError(
                f"checkpoint {path} was trained on {meta.get('num_data')} "
                f"rows but this dataset has {gbdt.train_ds.num_data}")
        with open(os.path.join(path, "model.txt")) as fh:
            loaded = load_model_string(fh.read(), "cpu")
        gbdt.load_initial_models(list(loaded.models), replay_scores=False)
        with np.load(os.path.join(path, "state.npz")) as npz:
            arrays = {k: npz[k] for k in npz.files}
        gbdt.restore_checkpoint_state(meta["state"], arrays)
        booster.best_iteration = int(meta.get("best_iteration", -1))
        history = [(int(it), [tuple(e) for e in entries])
                   for it, entries in meta.get("eval_history", [])]
        self.events.append({"event": "restore",
                            "iteration": int(meta["iteration"]),
                            "path": path})
        obs.event("restore", iteration=int(meta["iteration"]), path=path)
        log.info("checkpoint: resumed from %s at iteration %d (%d trees, "
                 "%d recorded eval rounds)", path, int(meta["iteration"]),
                 len(loaded.models), len(history))
        return RestoreState(iteration=int(meta["iteration"]), path=path,
                            eval_history=history, meta=meta)
