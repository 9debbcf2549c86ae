"""The serving store and the per-bucket CUDA graphs (counterpart of
lightgbm_tpu/serve/aot.py).

The JAX store persists each bucket's compiled executable, so a cold
process's first request compiles nothing.  The port compiles nothing per
bucket: its walk is eager torch ops, ~650 small launches a batch, and on
the card that walk is bound by launches, not by bytes.  Its counterpart
has two halves:

- **``BucketGraphs``**: one CUDA graph per pow2 bucket of a walk
  (``predict``, ``arena``, ``explain``), captured at warm-up with static
  input and output buffers.  A replay is one launch for the whole walk.
  The captured work is the eager walk's, the same ops in the same order
  on the same buffers, so a replay answers bit-equal to the eager walk.
  A lock per bucket guards its buffers (the microbatcher's and the
  router's threads share a session), and a capture waits for every
  serving walk of the process to finish (``GATE``).  A capture that fails
  raises: the card never walks a bucket uncaptured in its place.
- **``AOTStore``**: a CUDA graph cannot be written to disk, so an entry
  holds what a cold process needs before its first walk: the stacked
  ``ForestArrays`` as numpy, the serving bin space
  (``serve/packing.py ServeBinSpace``) and the bucket ladder.  A hit skips
  the bin-space rebuild and the packing; the graphs are captured at the
  process's warm-up.

Key schema (one entry per pack and ladder)::

    sha256(magic | kind | device name and compute capability |
           torch and CUDA versions | bucket | content digest | extras)

``bucket`` is the ladder's top (``max_batch``), which fixes the ladder;
the content digest hashes the trees' own arrays, so two models of equal
shapes and different thresholds key apart.  A corrupt, truncated or
foreign entry (another device, torch or CUDA version, kind or shape) is
a fallback: an ``aot_fallback`` event and the ``serve/aot_fallbacks``
counter, then the session packs from the model as a cold store would.

Armed by ``tpu_serve_aot_dir`` or ``$LGBM_TPU_SERVE_AOT_DIR`` (the
variable wins, as for every serve knob); ``tpu_serve_aot=false``
disarms both.
"""
from __future__ import annotations

import contextlib
import hashlib
import os
import pickle
import threading
from typing import Optional

import numpy as np
import torch

from .. import obs
from ..robust import faults
from ..utils import log
from ..utils.compile_cache import atomic_write_bytes, store_entries

_MAGIC = "lgbm-torch-aot-v1"
_SUFFIX = ".aot"

# CUDA graph captures and replays by walk kind, process-wide;
# chip_smoke.py reads them to show that requests replay and never capture
graph_captures = {"predict": 0, "arena": 0, "explain": 0}
graph_replays = {"predict": 0, "arena": 0, "explain": 0}


def resolve_aot_dir(config=None) -> Optional[str]:
    """The store directory in effect, or None (unarmed).
    ``$LGBM_TPU_SERVE_AOT_DIR`` wins over ``tpu_serve_aot_dir``;
    ``tpu_serve_aot=false`` disarms both."""
    if config is not None and not getattr(config, "tpu_serve_aot", True):
        return None
    p = (os.environ.get("LGBM_TPU_SERVE_AOT_DIR", "").strip()
         or str(getattr(config, "tpu_serve_aot_dir", "") or "").strip())
    return os.path.abspath(os.path.expanduser(p)) if p else None


def device_tag(device) -> str:
    """What an entry is valid for: the card's name and compute capability,
    or the device type."""
    device = torch.device(device)
    if device.type != "cuda":
        return device.type
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    major, minor = torch.cuda.get_device_capability(idx)
    return f"{torch.cuda.get_device_name(idx)}|sm_{major}{minor}"


def trees_digest(trees, extra: str = "") -> str:
    """Content digest of a tree window (each tree's split and leaf
    arrays), the store key's model part."""
    h = hashlib.sha256(extra.encode())
    for t in trees:
        nl = int(t.num_leaves)
        nn = max(nl - 1, 0)
        h.update(str(nl).encode())
        for a, n in ((t.split_feature, nn), (t.threshold, nn),
                     (t.decision_type, nn), (t.left_child, nn),
                     (t.right_child, nn), (t.leaf_value, nl),
                     (t.cat_boundaries, None), (t.cat_threshold, None)):
            arr = np.ascontiguousarray(np.asarray(
                a if n is None else a[:n]))
            h.update(str(arr.dtype).encode())
            h.update(arr.tobytes())
    return h.hexdigest()


def to_host(nt) -> dict:
    """A NamedTuple of tensors and numpy arrays as picklable numpy."""
    out = {}
    for k, v in nt._asdict().items():
        if isinstance(v, torch.Tensor):
            out[k] = ("tensor", v.detach().cpu().numpy())
        elif v is None:
            out[k] = ("none", None)
        else:
            out[k] = ("numpy", np.asarray(v))
    return out


def from_host(cls, state: dict, device):
    """``to_host``'s inverse: ``cls`` with its tensors on ``device``."""
    if set(state) != set(cls._fields):
        raise ValueError(f"{cls.__name__} fields differ: {sorted(state)}")
    kw = {}
    for k, (what, v) in state.items():
        if what == "tensor":
            kw[k] = torch.from_numpy(np.ascontiguousarray(v)).to(device)
        elif what == "numpy":
            kw[k] = np.asarray(v)
        elif what == "none":
            kw[k] = None
        else:
            raise ValueError(f"{cls.__name__}.{k}: unknown kind {what!r}")
    return cls(**kw)


class AOTStore:
    """One directory of packed serving state, content-keyed.

    ``load`` returns ``(status, payload)`` with status "hit", "miss" (no
    entry: a cold store) or "fallback" (an entry that exists but cannot be
    trusted, reported loudly); the caller packs from the model on a miss
    or a fallback, and ``save``s what it packed."""

    def __init__(self, path: str):
        self.path = str(path)
        self.loaded = 0
        self.saved = 0
        self.fallbacks = 0
        self.save_errors = 0

    @staticmethod
    def versions() -> str:
        return f"torch {torch.__version__}|cuda {torch.version.cuda}"

    def key(self, kind: str, bucket: int, content_digest: str,
            extra: str = "", device="cpu") -> str:
        parts = "|".join([_MAGIC, kind, device_tag(device), self.versions(),
                          str(int(bucket)), content_digest, extra])
        return hashlib.sha256(parts.encode()).hexdigest()[:32]

    def _entry_path(self, kind: str, key: str) -> str:
        return os.path.join(self.path, f"{kind}_{key}{_SUFFIX}")

    def load(self, kind: str, key: str, device="cpu", decode=None):
        """(status, value): "hit" and the entry's payload dict (passed
        through ``decode`` when given: a decode that raises makes the
        entry a fallback too), "miss" and None, or "fallback" and None
        (already reported)."""
        path = self._entry_path(kind, key)
        if not os.path.exists(path):
            return "miss", None
        try:
            faults.check("serve_aot_load")
            with open(path, "rb") as fh:
                blob = pickle.load(fh)
            if not (isinstance(blob, dict) and blob.get("magic") == _MAGIC):
                raise ValueError("bad magic: not a store entry")
            for field, want in (("kind", kind), ("key", key),
                                ("device", device_tag(device)),
                                ("versions", self.versions())):
                if blob.get(field) != want:
                    raise ValueError(f"{field} mismatch (entry "
                                     f"{blob.get(field)!r}, process "
                                     f"{want!r})")
            payload = blob.get("payload")
            if not isinstance(payload, dict):
                raise ValueError("entry has no payload")
            if decode is not None:
                payload = decode(payload)
            self.loaded += 1
            return "hit", payload
        except Exception as exc:  # noqa: BLE001 — pack from the model
            self.fallbacks += 1
            log.warning("serve store: entry %s unusable (%s: %s); packing "
                        "from the model", os.path.basename(path),
                        type(exc).__name__, exc)
            obs.event("aot_fallback", kind=kind,
                      entry=os.path.basename(path),
                      reason=f"{type(exc).__name__}: {exc}")
            obs.count("serve/aot_fallbacks")
            return "fallback", None

    def save(self, kind: str, key: str, payload: dict, device="cpu",
             note: dict = None) -> bool:
        """Write an entry (atomically).  False on failure: a failed write
        costs the next cold process a pack, never this one a request."""
        try:
            blob = {"magic": _MAGIC, "kind": kind, "key": key,
                    "device": device_tag(device),
                    "versions": self.versions(), "payload": payload,
                    "note": dict(note or {})}
            atomic_write_bytes(self._entry_path(kind, key),
                               pickle.dumps(blob, protocol=4))
            self.saved += 1
            return True
        except Exception as exc:  # noqa: BLE001
            self.save_errors += 1
            log.warning("serve store: failed to write %s/%s (%s: %s)",
                        kind, key, type(exc).__name__, exc)
            return False

    def entries(self) -> list:
        return store_entries(self.path, _SUFFIX)

    def stats(self) -> dict:
        return {"dir": self.path, "entries": len(self.entries()),
                "loaded": self.loaded, "saved": self.saved,
                "fallbacks": self.fallbacks,
                "save_errors": self.save_errors}


class _CaptureGate:
    """Captures against the serving walks of the whole process: a walk
    (a replay or an eager walk) holds the gate shared, a capture holds it
    alone, after every walk in flight has finished and the device has
    drained.  Another thread's work on the card while a stream captures
    can invalidate the capture (the caching allocator's event queries, an
    implicit synchronization); captures wait for walks, and new walks wait
    behind a waiting capture, so neither starves."""

    def __init__(self):
        self._cond = threading.Condition()
        self._walks = 0
        self._capturing = False
        self._waiting = 0

    @contextlib.contextmanager
    def walk(self):
        with self._cond:
            while self._capturing or self._waiting:
                self._cond.wait()
            self._walks += 1
        try:
            yield
        finally:
            with self._cond:
                self._walks -= 1
                self._cond.notify_all()

    @contextlib.contextmanager
    def capture(self, device):
        with self._cond:
            self._waiting += 1
            while self._capturing or self._walks:
                self._cond.wait()
            self._waiting -= 1
            self._capturing = True
        try:
            torch.cuda.synchronize(device)
            yield
        finally:
            with self._cond:
                self._capturing = False
                self._cond.notify_all()


# one gate a process: every session, replica and arena generation walks
# under it
GATE = _CaptureGate()


class _Captured:
    __slots__ = ("graph", "inputs", "output", "lock")

    def __init__(self, graph, inputs, output):
        self.graph = graph
        self.inputs = inputs
        self.output = output
        self.lock = threading.Lock()


class BucketGraphs:
    """One CUDA graph per bucket of one walk.  ``fn(*inputs) -> tensor``
    is the eager walk (its constants, the packed forest, closed over);
    ``inputs`` is a list of ``(shape_of(bucket), dtype)`` for the static
    input buffers.  ``run(bucket, *arrays)`` copies the host arrays into
    the bucket's buffers, replays its graph and returns the output on the
    host.  Each graph owns its private memory pool, so no two buckets'
    buffers alias; ``free`` releases them all."""

    def __init__(self, fn, device, kind: str, inputs):
        self.fn = fn
        self.device = torch.device(device)
        self.kind = kind
        self.inputs = list(inputs)
        self._graphs = {}
        self._lock = threading.Lock()
        self.captures = 0
        self.replays = 0

    def buckets(self) -> list:
        return sorted(self._graphs)

    def capture(self, bucket: int) -> _Captured:
        """Capture ``bucket``'s walk (idempotent).  The walk runs twice on
        the capture stream first, as ``torch.cuda.graph`` requires."""
        with self._lock:
            got = self._graphs.get(bucket)
            if got is not None:
                return got
            dev = self.device
            with GATE.capture(dev), torch.cuda.device(dev):
                ins = [torch.zeros(shape(bucket), dtype=dt, device=dev)
                       for shape, dt in self.inputs]
                side = torch.cuda.Stream(dev)
                side.wait_stream(torch.cuda.current_stream(dev))
                with torch.cuda.stream(side):
                    for _ in range(2):
                        self.fn(*ins)
                torch.cuda.current_stream(dev).wait_stream(side)
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph, stream=side,
                                      capture_error_mode="thread_local"):
                    out = self.fn(*ins)
                torch.cuda.current_stream(dev).wait_stream(side)
            got = _Captured(graph, ins, out)
            self._graphs[bucket] = got
            self.captures += 1
            graph_captures[self.kind] += 1
            obs.count("serve/graph_captures")
            return got

    def run(self, bucket: int, *arrays) -> np.ndarray:
        """Replay ``bucket``'s graph on ``arrays`` (host numpy, the bucket's
        shapes); captures it first when warm-up did not."""
        ent = self._graphs.get(bucket)
        if ent is None:
            ent = self.capture(bucket)
        with GATE.walk(), ent.lock:
            for buf, a in zip(ent.inputs, arrays):
                buf.copy_(torch.from_numpy(np.ascontiguousarray(a)))
            ent.graph.replay()
            out = ent.output.cpu().numpy()
        self.replays += 1
        graph_replays[self.kind] += 1
        return out

    def free(self) -> None:
        """Release every bucket's graph and buffers (a walk in flight
        finishes first: each reset waits for its bucket's lock)."""
        with self._lock:
            for ent in self._graphs.values():
                with ent.lock:
                    ent.graph.reset()
            self._graphs.clear()
