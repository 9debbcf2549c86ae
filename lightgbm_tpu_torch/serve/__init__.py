"""Serving on the device (counterpart of lightgbm_tpu/serve/): a model,
trained in-process or loaded from a file, is packed once into a stacked
bin-space forest on the card and served through a dynamic microbatcher
behind a threaded HTTP front end.

- ``packing``  — the model-derived bin space and the stacked forest
- ``session``  — ``PredictorSession``: sync ``predict`` and async
  ``submit``/``result`` over the microbatcher, ``explain`` and
  ``submit_explain`` over the batched TreeSHAP pass (``explain/``)
- ``batcher``  — request coalescing, bounded queue, priority shedding
- ``router``   — ``ReplicaRouter``: session replicas behind health-based
  routing, per-replica circuit breakers and draining
- ``registry`` — ``ModelRegistry``: named versions, canary-gated hot
  swap, rollback and the post-swap watch
- ``arena``    — ``ForestArena``: many tenant forests in one stacked
  forest with a model-id lane, cross-model batches, LRU residency under
  a byte budget
- ``server``   — the JSON-over-HTTP front end
- ``metrics``  — counters, the latency histogram, SLO burn, Prometheus

No request is ever answered from the host: a failed device batch fails
its requests (``DeviceFailed``, HTTP 503).  The JAX package's ``aot``
(persisted per-bucket executables) waits for ROADMAP.md's "serve AOT
store" item.  ``quality`` tracks a served model's rolling label quality.
"""
from .arena import ForestArena
from .batcher import (PRIORITIES, DeadlineExceeded, DeviceFailed,
                      MicroBatcher, ServeOverloadError, normalize_priority)
from .metrics import ServeMetrics, parse_prometheus
from .packing import ServeBinSpace
from .registry import ModelRegistry, SwapRejected, UnknownModelError
from .router import NoReplicaAvailable, ReplicaRouter
from .server import PredictServer
from .session import PredictorSession

__all__ = ["ForestArena", "PRIORITIES", "DeadlineExceeded", "DeviceFailed",
           "MicroBatcher", "ModelRegistry", "NoReplicaAvailable",
           "PredictServer", "PredictorSession", "ReplicaRouter",
           "ServeBinSpace", "ServeMetrics", "ServeOverloadError",
           "SwapRejected", "UnknownModelError", "normalize_priority",
           "parse_prometheus"]
