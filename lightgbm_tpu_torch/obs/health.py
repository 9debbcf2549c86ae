"""Training-health sentinels: numerics guards, model fingerprints and the
cross-rank divergence audit (counterpart of lightgbm_tpu/obs/health.py,
with its ``health`` and ``fingerprint`` events and its attribution).

One process-wide mode (``LGBM_TPU_HEALTH`` or ``tpu_health``):

- ``""`` off: every entry point is one boolean check;
- ``monitor``: check, warn and emit ``health`` events;
- ``strict``: abort with a :class:`TrainingHealthError` naming the phase,
  the iteration and, for a tree, the node and feature.

Each check is one torch reduction on the tensors' own device and one host
read of its few numbers, made only while the mode is on (no fallback: a
check runs where the tensor is, or raises):

- :func:`check_gradients` (``objective/base.py health_tap``, the GOSS
  amplifier, custom ``fobj`` gradients): non-finite counts and the first
  bad row (and class);
- :func:`check_score` (DART's renormalized scores);
- :func:`check_tree`: non-finite split gains, values and weights with the
  first bad node and its feature, and the conservation of the root's
  count and weight over the leaves;
- :func:`model_fingerprint`: f32 sums of the scores and of the
  iteration's trees, hashed into a ``fingerprint`` event.

:func:`divergence_audit` compares the fingerprints of the ranks, gathered
by ``parallel/distributed.py rank_allgather_stats``; alone (one process)
it has nothing to compare and returns.
"""
from __future__ import annotations

import hashlib
import os
from typing import Optional

import numpy as np

from ..utils import log
from ..utils.log import LightGBMError
from . import core


class TrainingHealthError(LightGBMError):
    """A health sentinel tripped (strict mode, or a divergence)."""


MODE_OFF, MODE_MONITOR, MODE_STRICT = "", "monitor", "strict"

# conservation tolerances (check_tree): counts are exact; weights sum
# through parent-minus-child histograms of rounded (2xbf16) hessians
_COUNT_ATOL = 0.5
_WEIGHT_RTOL = 5e-2

_mode = MODE_OFF
_gather_override = None  # test hook: callable(stats) -> [R, n] array


def parse_mode(value, fatal: bool = False) -> str:
    """The one health-mode parser (``config.py`` validates ``tpu_health``
    through it).  ``fatal`` rejects unknown values; the environment path
    arms 'monitor' for them, with a warning."""
    v = str(value).strip().lower()
    if v in ("", "0", "false", "off", "no", "none"):
        return MODE_OFF
    if v in ("strict", "abort"):
        return MODE_STRICT
    if v in ("1", "true", "on", "yes", "monitor", "warn"):
        return MODE_MONITOR
    if fatal:
        log.fatal("tpu_health should be off, monitor or strict "
                  f"(got {value!r})")
    log.warning("unknown LGBM_TPU_HEALTH value %r; arming 'monitor' "
                "(NOT 'strict'): fix the value if you wanted aborts", value)
    return MODE_MONITOR


def enable_health(mode="monitor") -> None:
    """Set the process-wide health mode."""
    global _mode
    _mode = parse_mode(mode)


def health_mode() -> str:
    return _mode


def health_enabled() -> bool:
    return bool(_mode)


def _fail(check: str, msg: str, *, phase: str, iteration: int,
          detail: dict) -> bool:
    core.count("health/failures")
    core.event("health", check=check, phase=phase, iteration=iteration,
               ok=False, mode=_mode, detail=detail)
    if _mode == MODE_STRICT:
        _dump_flight("training_health")
        raise TrainingHealthError(msg)
    log.warning("HEALTH: %s", msg)
    return False


def _dump_flight(reason: str) -> None:
    """Before an abort, write the flight ring: its last iteration and
    health events are the post-mortem."""
    from .spans import flight_dump, flight_enabled
    if flight_enabled():
        flight_dump(reason)


def _host(stats) -> np.ndarray:
    """The one host read of a check."""
    return stats.cpu().numpy()


def _first_bad(bad):
    """Index of the first True of a flat bool tensor (0 when none)."""
    import torch
    return torch.argmax(bad.to(torch.uint8))


# ---------------------------------------------------------------------------
# Numerics sentinels
# ---------------------------------------------------------------------------

def check_gradients(g, h, *, phase: str, iteration: int,
                    objective: Optional[str] = None) -> bool:
    """Finite-check gradients and hessians ([N] or [N, K]); True when
    healthy or off."""
    if not _mode:
        return True
    import torch
    core.count("health/checks")
    bg = ~torch.isfinite(g.reshape(-1))
    bh = ~torch.isfinite(h.reshape(-1))
    s = _host(torch.stack([bg.sum(), bh.sum(), _first_bad(bg),
                           _first_bad(bh)]))
    if s[0] == 0 and s[1] == 0:
        return True
    # the first bad index is over the flattened [N, K] buffer: as a row
    # and, for K classes, a class
    shape = tuple(g.shape)
    k = shape[1] if len(shape) == 2 else 1
    flat = int(s[2] if s[0] else s[3])
    detail = {"nonfinite_grad": int(s[0]), "nonfinite_hess": int(s[1]),
              "first_bad_row": flat // k, "size": int(np.prod(shape))}
    if k > 1:
        detail["first_bad_class"] = flat % k
    if objective:
        detail["objective"] = objective
    msg = (f"non-finite gradients/hessians at iteration {iteration} in "
           f"phase '{phase}'"
           + (f" (objective={objective})" if objective else "")
           + f": {int(s[0])} bad gradient and {int(s[1])} bad hessian "
           f"value(s), first at row {detail['first_bad_row']}"
           + (f" class {flat % k}" if k > 1 else ""))
    return _fail("gradients", msg, phase=phase, iteration=iteration,
                 detail=detail)


def check_score(score, *, phase: str, iteration: int) -> bool:
    """Finite-check a score tensor (DART's renormalization changes scores
    outside the checked gradient path)."""
    if not _mode:
        return True
    import torch
    core.count("health/checks")
    bad = ~torch.isfinite(score.reshape(-1))
    s = _host(torch.stack([bad.sum(), _first_bad(bad)]))
    if s[0] == 0:
        return True
    shape = tuple(score.shape)
    k = shape[1] if len(shape) == 2 else 1
    row = int(s[1]) // k
    msg = (f"non-finite score values at iteration {iteration} in phase "
           f"'{phase}': {int(s[0])} bad value(s), first at row {row}")
    return _fail("score", msg, phase=phase, iteration=iteration,
                 detail={"nonfinite": int(s[0]), "first_bad_row": row})


def tree_health_stats(arrs):
    """f32 [10] of a grown tree (``core/grower.py TreeArrays`` on its
    device): [bad gains, bad values, bad weights, first bad-gain node,
    its feature, leaf count sum, root count, leaf weight sum, root
    weight, leaves] over the active nodes and leaves (reference package:
    core/splitter.py ``tree_health_stats``)."""
    import torch
    nl = torch.as_tensor(arrs.num_leaves, device=arrs.leaf_value.device)
    n = arrs.split_gain.shape[0]
    L = arrs.leaf_value.shape[0]
    dev = arrs.leaf_value.device
    node_act = torch.arange(n, device=dev) < (nl - 1)
    leaf_act = torch.arange(L, device=dev) < nl
    pad = torch.zeros(L - n, dtype=torch.bool, device=dev)
    bad_gain = node_act & ~torch.isfinite(arrs.split_gain)
    bad_val = ((leaf_act & ~torch.isfinite(arrs.leaf_value))
               | torch.cat([node_act & ~torch.isfinite(arrs.internal_value),
                            pad]))
    bad_w = ((leaf_act & ~torch.isfinite(arrs.leaf_weight))
             | torch.cat([node_act & ~torch.isfinite(arrs.internal_weight),
                          pad]))
    first = _first_bad(bad_gain)
    f32 = torch.float32
    zero = torch.zeros((), dtype=f32, device=dev)
    return torch.stack([
        bad_gain.sum().to(f32), bad_val.sum().to(f32), bad_w.sum().to(f32),
        first.to(f32), arrs.split_feature[first].to(f32),
        torch.where(leaf_act, arrs.leaf_count.to(f32), zero).sum(),
        arrs.internal_count[0].to(f32),
        torch.where(leaf_act, arrs.leaf_weight.to(f32), zero).sum(),
        arrs.internal_weight[0].to(f32), nl.to(f32)])


def check_tree(arrs, *, phase: str, iteration: int, class_id: int = 0
               ) -> bool:
    """Split-gain finiteness and histogram-total conservation of one
    grown tree; True when healthy.  A one-leaf tree has no invariant and
    passes."""
    if not _mode:
        return True
    core.count("health/checks")
    s = _host(tree_health_stats(arrs)).astype(np.float64)
    (n_bad_gain, n_bad_val, n_bad_w, first_node, first_feat,
     leaf_cnt, root_cnt, leaf_w, root_w, nl) = s
    if nl <= 1:
        return True
    base = {"class_id": class_id, "num_leaves": int(nl)}
    if n_bad_gain or n_bad_val or n_bad_w:
        detail = dict(base, nonfinite_gain=int(n_bad_gain),
                      nonfinite_value=int(n_bad_val),
                      nonfinite_weight=int(n_bad_w))
        if n_bad_gain:
            detail["node"] = int(first_node)
            detail["feature"] = int(first_feat)
        msg = (f"non-finite tree state at iteration {iteration} in phase "
               f"'{phase}' (class {class_id}): {int(n_bad_gain)} bad split "
               f"gain(s), {int(n_bad_val)} bad value(s), {int(n_bad_w)} "
               f"bad weight(s)"
               + (f"; first bad gain at node {int(first_node)} "
                  f"(feature {int(first_feat)})" if n_bad_gain else ""))
        return _fail("tree", msg, phase=phase, iteration=iteration,
                     detail=detail)
    cnt_bad = abs(leaf_cnt - root_cnt) > max(_COUNT_ATOL, 1e-6 * root_cnt)
    w_bad = abs(leaf_w - root_w) > _WEIGHT_RTOL * max(abs(root_w), 1e-6)
    if cnt_bad or w_bad:
        detail = dict(base, leaf_count_sum=leaf_cnt, root_count=root_cnt,
                      leaf_weight_sum=leaf_w, root_weight=root_w)
        msg = (f"histogram-total conservation breach at iteration "
               f"{iteration} in phase '{phase}' (class {class_id}): "
               f"leaves sum to count={leaf_cnt:g}/weight={leaf_w:g} but "
               f"the root histogrammed count={root_cnt:g}/"
               f"weight={root_w:g}")
        return _fail("conservation", msg, phase=phase, iteration=iteration,
                     detail=detail)
    return True


# ---------------------------------------------------------------------------
# Model-state fingerprints and the cross-rank audit
# ---------------------------------------------------------------------------

def model_fingerprint(score, trees=(), *, iteration: int) -> Optional[dict]:
    """The model state of this iteration: f32 sums of the scores (sum,
    sum of squares, min, max) and of each tree's arrays, read in one copy,
    hashed (blake2b) into a ``fingerprint`` event.  Returns
    ``{"iteration", "stats", "digest"}`` (None when off)."""
    if not _mode:
        return None
    import torch
    f = score.reshape(-1).to(torch.float32)
    parts = [torch.stack([f.sum(), (f * f).sum(), f.min(), f.max()])]
    for t in trees:
        parts.append(torch.stack([
            t.leaf_value.sum(), t.leaf_value.abs().sum(),
            t.threshold_bin.to(torch.float32).sum(),
            t.split_feature.to(torch.float32).sum(),
            torch.as_tensor(t.num_leaves, device=f.device).to(
                torch.float32)]).to(f.device))
    stats = _host(torch.cat(parts)).astype(np.float64)
    digest = _digest_of(stats)
    core.event("fingerprint", iteration=iteration, digest=digest,
               stats=[float(x) for x in stats], trees=len(trees))
    return {"iteration": iteration, "stats": stats, "digest": digest}


def _digest_of(vec: np.ndarray) -> str:
    return hashlib.blake2b(np.asarray(vec, np.float64).astype("<f8")
                           .tobytes(), digest_size=8).hexdigest()


def divergence_audit(stats: np.ndarray, *, iteration: int) -> bool:
    """Compare this rank's fingerprint stats with every other rank's; a
    mismatch emits a ``divergence`` event naming the minority ranks and
    raises :class:`TrainingHealthError` in every mode.  One process has
    nothing to compare (``_gather_override`` stands in for the gather in
    tests)."""
    if not _mode:
        return True
    if _gather_override is not None:
        gathered = _gather_override(np.asarray(stats, np.float64))
    else:
        from ..parallel.distributed import rank_allgather_stats
        gathered = rank_allgather_stats(stats)
    if gathered is None:
        return True
    gathered = np.asarray(gathered, np.float64)
    if gathered.shape[0] <= 1:
        return True
    core.count("health/divergence_checks")
    digests = [_digest_of(gathered[r]) for r in range(gathered.shape[0])]
    spread = gathered.max(axis=0) - gathered.min(axis=0)
    ok = len(set(digests)) == 1
    core.event("divergence", iteration=iteration, ok=ok,
               ranks=gathered.shape[0], digests=digests,
               spread=[float(x) for x in spread])
    if ok:
        return True
    core.count("health/failures")
    counts = {}
    for d in digests:
        counts[d] = counts.get(d, 0) + 1
    modal, modal_n = max(counts.items(), key=lambda kv: kv[1])
    bad = ([r for r, d in enumerate(digests) if d != modal]
           if modal_n > 1 else list(range(len(digests))))
    worst = int(np.argmax(spread))
    msg = (f"cross-rank model divergence at iteration {iteration}: "
           f"rank(s) {bad} disagree with the majority fingerprint "
           f"(digests {digests}); worst stat index {worst} spreads "
           f"{spread[worst]:g} across ranks")
    _dump_flight("divergence")
    raise TrainingHealthError(msg)


_env_mode = os.environ.get("LGBM_TPU_HEALTH", "")
if _env_mode:
    enable_health(_env_mode)
