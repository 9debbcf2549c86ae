"""Device leaf refit (counterpart of lightgbm_tpu/online/refit.py; the
reference's GBDT::RefitTree gbdt.cpp:298-321 and
SerialTreeLearner::FitByExistingTree serial_tree_learner.cpp:239-264).

A refit keeps every tree's structure, so each tree's leaf id per row is a
function of the fixed bin matrix: one stacked ``core/forest.py
forest_leaf_fn`` walk gives the whole ``[T, N]`` leaf-id table up front.
What stays sequential is the gradient recurrence: gradients come once an
iteration from the scores of every tree refit before it (the reference
calls Boosting() once an iteration, gbdt.cpp:303), and each of the
iteration's K trees then takes one step on the training device: per-leaf
sums of the fresh g and h, the closed form with L1, L2 and
``max_delta_step``, the decay mix, and the score update.

The per-leaf sums are repeatable.  The JAX package sums in f32 with
``segment_sum``; a float ``index_add_`` on a CUDA tensor adds by atomics
in no fixed order, so two refits of one window would write model texts
that differ in their last digits (as K1's float sums did before they
became fixed point).  Here g and h are int64 fixed point, as in
``core/histogram.py hist_fixed_point``: a power-of-two scale 2^k per
channel from the tree's max |g| and |h|, with k chosen so that N values
of up to twice that maximum sum below 2^62.  Each value is rounded once
to the nearest int64 (a step of 2^(ceil(log2 N) - 62) of the maximum:
about 4.5e-13 of it at 1M rows), the sums are integer adds, whose order
cannot change them, and each sum goes back through f64.  The leaf values
are then computed in f64 from the host trees' f64 values, as the host
oracle (``GBDT._refit_models_host``, ``tpu_refit_device=false``) computes
them; the scores take the f32 leaf values, as the oracle's do.  The same
ops run on a CPU tensor, with the same integer sums.

No ``pallas_call`` is reached here in the JAX package (an XLA program), so
this is torch ops, not a hand kernel.
"""
from __future__ import annotations

import numpy as np
import torch

_FIXED_BITS = 61     # N values of up to 2 * max sum below 2^62


def leaf_sums(leaf: torch.Tensor, g: torch.Tensor, h: torch.Tensor,
              num_leaves: int) -> torch.Tensor:
    """Per-leaf ``(sum g, sum h)`` as f64 ``[num_leaves, 2]``, the same
    from call to call on any device: int64 fixed point (the module's
    docstring)."""
    gh = torch.stack([g, h], 1).double()                      # [N, 2]
    n = gh.shape[0]
    amax = (gh.abs().amax(0) if n else
            torch.zeros(2, dtype=torch.float64, device=gh.device))
    lg = 0 if n <= 1 else (n - 1).bit_length()               # ceil log2
    k = (_FIXED_BITS - lg - torch.frexp(amax).exponent).double()
    acc = torch.zeros((num_leaves, 2), dtype=torch.int64, device=gh.device)
    acc.index_add_(0, leaf, torch.round(torch.ldexp(gh, k)).long())
    return torch.ldexp(acc.double(), -k)


def device_refit_models(gbdt, decay: float) -> dict:
    """Refit ``gbdt``'s loaded forest to its (new) training data on its
    device, mixing old and new leaf outputs by ``decay``.  Sets the host
    trees' ``leaf_value`` (f64) and rebuilds ``_train_score``, as the host
    loop does.  Returns a report: trees, rows, iterations, and on the card
    the leaf walk's and the refit steps' milliseconds by CUDA events
    (``leaf_walk_ms``, ``steps_ms``)."""
    from ..boosting.gbdt import K_EPSILON
    from ..core.forest import forest_leaf_fn, stack_forest

    trees = list(gbdt.models)
    K = gbdt.num_tpi
    T = len(trees)
    N = int(gbdt.train_ds.num_data)
    if T == 0:
        return {"trees": 0, "rows": N, "iterations": 0}
    dev = gbdt.device
    cfg = gbdt.split_cfg
    l1, l2 = float(cfg.lambda_l1), float(cfg.lambda_l2)
    mds = float(cfg.max_delta_step)
    forest = stack_forest([gbdt._tree_arrays_np(t) for t in trees],
                          np.asarray([i % K for i in range(T)], np.int32),
                          dev)
    timed = dev.type == "cuda"
    if timed:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
    # [T, N] leaf ids in one walk; a bundled dataset's physical columns
    # are decoded as the score replay of load_initial_models decodes them
    leaf_ids = forest_leaf_fn(gbdt.meta, phys=gbdt._bundled)(
        forest, gbdt._train_bins_dev())
    if timed:
        ev[1].record()
    L = int(forest.leaf_value.shape[1])
    old = np.zeros((T, L), np.float64)
    for t, tree in enumerate(trees):
        old[t, :tree.num_leaves] = tree.leaf_value[:tree.num_leaves]
    old = torch.as_tensor(old).to(dev)
    shrink = torch.as_tensor([float(t.shrinkage) for t in trees],
                             dtype=torch.float64).to(dev)
    new = torch.empty((T, L), dtype=torch.float64, device=dev)
    score = gbdt._zero_score(N)
    for it in range(T // K):
        # gradients once an iteration, before any of its K class trees
        g, h = gbdt.objective.get_gradients(score)
        for k in range(K):
            t = it * K + k
            lid = leaf_ids[t]
            sums = leaf_sums(lid, g if K == 1 else g[:, k],
                             h if K == 1 else h[:, k], L)
            sum_g, sum_h = sums[:, 0], sums[:, 1] + K_EPSILON
            sg = torch.sign(sum_g) * torch.clamp(sum_g.abs() - l1, min=0.0)
            out = -sg / (sum_h + l2)
            if mds > 0:
                out = torch.clamp(out, -mds, mds)
            new[t] = decay * old[t] + (1.0 - decay) * out * shrink[t]
            score = gbdt._add_to_class(score, k, new[t].float()[lid])
    if timed:
        ev[2].record()
    gbdt._train_score = score
    new_np = new.cpu().numpy()          # waits for the steps
    for t, tree in enumerate(trees):
        tree.leaf_value = new_np[t, :tree.num_leaves].copy()
    report = {"trees": T, "rows": N, "iterations": T // K}
    if timed:
        report.update(leaf_walk_ms=ev[0].elapsed_time(ev[1]),
                      steps_ms=ev[1].elapsed_time(ev[2]))
    return report
