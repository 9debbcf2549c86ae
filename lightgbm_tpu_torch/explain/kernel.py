"""Batched TreeSHAP over a stacked forest, in torch ops on the forest's
device (counterpart of lightgbm_tpu/explain/kernel.py
``forest_shap_fn``).

The reference recurses per row per tree (tree.cpp:609-716); the JAX
package flattens the recursion into its path decomposition and runs one
``lax.scan`` over trees.  Here the same stages run as eager torch ops, a
Python loop over trees, on blocks of rows:

1. **decisions** — every internal node's go-left bit for every row
   ([n, M], the bin-space ``split_decision`` with category bitsets);
2. **one-fraction merge** — each (leaf, edge) hot indicator AND-folded
   into its merged slot (one integer scatter of the cold edges);
3. **EXTEND** — the closed-form parallel update ``w -> (z*w*(k-j) +
   o*shift(w)*j) / (k+1)`` over [n, L, P+1], one step for each of a
   leaf's merged slots;
4. **UNWIND** — UnwoundPathSum for every slot at once over [n, L, P], with
   the JAX package's ``maximum(Of, 1e-30)`` guard and ``where(O, t_hot,
   t_cold)`` select, at each leaf's own depth;
5. **scatter** — ``W * (O - Z) * leaf_value`` added into the contribution
   columns (pads into the expected-value column, where they add exactly
   0), plus the tree's expected value in column F.

Two departures from the JAX package, both for accuracy on deep trees:
the pad slots are skipped (the JAX package extends with them as identity
players: each one is a hot step of the unwinding recurrence, which
cancels), and stages 3-4 run in f64.  On a 40-column one-hot chain of
depth 30 (``tests/test_torch_explain.py``) the JAX package's f32 pass is
1.0e-2 from the f64 recursion, skipping pads in f32 1.4e-3, skipping pads
in f64 2.2e-7.  Trees add into their class's columns as a
Kahan-compensated f32 sum, as in the JAX package.  Rows are independent,
so blocks of rows change no result: a block holds ``_TEMP_BYTES`` per
[rows, L, P+1] f64 temporary.
No stage reaches a Pallas kernel in the JAX package; PERF.md measures
this pass against ``ops/treeshap.py shap_cost``.
"""
from __future__ import annotations

import torch

from ..core.splitter import split_decision

# bytes of one [rows, L, P+1] f64 temporary of a row block; ~10 are live
# at once, so a block peaks near 2.5 GB on the card
_TEMP_BYTES = 1 << 28

# calls of the device pass; chip_smoke.py reads them to show that a
# pred_contrib went through it
calls = {"shap": 0}


def forest_shap_fn(meta, K: int, F: int):
    """Build ``contribs(forest, explain, bins) -> [N, K, F+1] f32``.

    ``forest`` is a ``core.forest.ForestArrays``, ``explain`` the matching
    ``explain.paths.ExplainArrays``, ``bins`` the [N, F] int32 matrix of
    the bin space the forest was packed in (``ServeBinSpace``), all on
    one device."""

    def contribs(forest, explain, bins):
        calls["shap"] += 1
        N = bins.shape[0]
        _, L, P = explain.path_node.shape
        rows = max(1, _TEMP_BYTES // (8 * L * (P + 1)))
        out = [_block(forest, explain, bins[lo:lo + rows], L, P)
               for lo in range(0, N, rows)]
        return (torch.cat(out) if out else
                torch.zeros((0, K, F + 1), dtype=torch.float32,
                            device=bins.device))

    def _block(forest, explain, bins, L, P):
        n, dev = bins.shape[0], bins.device
        phi = torch.zeros((n, K, F + 1), dtype=torch.float32, device=dev)
        comp = torch.zeros_like(phi)
        j = torch.arange(P + 1, dtype=torch.float64, device=dev)
        for t, k in enumerate(forest.class_id.tolist()):
            add = _tree(forest, explain, t, bins, L, P, j)
            # Kahan-compensated accumulation into the tree's class
            y = add - comp[:, k]
            t_sum = phi[:, k] + y
            comp[:, k] = (t_sum - phi[:, k]) - y
            phi[:, k] = t_sum
        return phi

    def _tree(forest, explain, t, bins, L, P, j):
        n, dev = bins.shape[0], bins.device
        # 1. per-node decisions for every row: [n, M]
        sf = forest.split_feature[t]
        M = sf.shape[0]
        f = sf.clamp(min=0)
        col = bins.index_select(1, f).long()
        W = forest.cat_bitset.shape[2]
        word = forest.cat_bitset[t].reshape(-1)[
            torch.arange(M, device=dev)[None, :] * W
            + torch.clamp(col // 32, max=W - 1)]
        go_left = split_decision(
            col, forest.threshold_bin[t][None, :],
            forest.default_left[t][None, :], meta.missing_types[f][None, :],
            meta.num_bins[f][None, :], meta.default_bins[f][None, :],
            is_cat=meta.is_categorical[f][None, :], cat_word=word)

        # 2. hot indicators per (row, leaf, edge), pads forced hot, then
        # AND-folded into the merged slots
        pnode = explain.path_node[t]
        node = pnode.clamp(min=0)
        hot = (go_left[:, node.reshape(-1)].reshape(n, L, P)
               == explain.path_left[t][None]) | (pnode < 0)[None]
        cold = torch.zeros((n, L, P), dtype=torch.int32, device=dev)
        cold.scatter_add_(2, explain.path_slot[t][None].expand(n, L, P),
                          (~hot).to(torch.int32))
        O = cold == 0
        Of = O.to(torch.float64)
        Z = explain.slot_zero[t][None].double()                # [1, L, P]
        # each leaf's real (merged) slots come first; the rest are pads
        U = explain.num_slots[t]                               # [L]
        steps = int(explain.max_slots[t])

        # 3. EXTEND each leaf's U real slots (the pads are skipped)
        w = torch.zeros((n, L, P + 1), dtype=torch.float64, device=dev)
        w[..., 0] = 1.0
        zero_col = torch.zeros((n, L, 1), dtype=torch.float64, device=dev)
        for p in range(steps):
            k = float(p + 1)
            z = Z[0, :, p, None]
            shifted = torch.cat([zero_col, w[..., :-1]], dim=-1)
            ext = (z * w * (k - j) + Of[..., p, None] * shifted * j) / (k + 1.0)
            w = torch.where((p < U)[None, :, None], ext, w)

        # 4. UNWIND every slot at once over each leaf's depth D = U (one
        # fractions are 0/1; the o == 0 lanes poison only their own
        # discarded hot value, which the guard keeps finite)
        D = U.to(torch.float64)[None, :, None]
        Dp1 = D + 1.0
        nxt = torch.gather(w, 2, U[None, :, None].expand(n, L, 1))
        nxt = nxt.expand(n, L, P)
        total = torch.zeros((n, L, P), dtype=torch.float64, device=dev)
        Of_guard = torch.clamp(Of, min=1e-30)
        for i in range(steps - 1, -1, -1):
            fi = float(i)
            act = (i < U)[None, :, None]
            wi = w[..., i, None]
            tmp = nxt * Dp1 / ((fi + 1.0) * Of_guard)
            t_hot = total + tmp
            nxt = torch.where(act, wi - tmp * Z * (D - fi) / Dp1, nxt)
            t_cold = total + (wi / Z) * (Dp1 / (D - fi))
            total = torch.where(act, torch.where(O, t_hot, t_cold), total)

        # 5. contributions and the expected value
        contrib = (total * (Of - Z)).float() \
            * explain.leaf_value[t][None, :, None]
        add = torch.zeros((n, F + 1), dtype=torch.float32, device=dev)
        add.index_add_(1, explain.slot_feature[t].reshape(-1),
                       contrib.reshape(n, L * P))
        add[:, F] += explain.expected[t]
        return add

    return contribs
