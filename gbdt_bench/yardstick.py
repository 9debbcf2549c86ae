"""The needed work of an iteration, and the H100's data-sheet peaks.

A frozen count, independent of how the program does the work: it reads
the data shapes and the model text the run produced, never the program's
own cost functions or launch counts, so a redesign of a kernel does not
move its own yardstick.  What it leaves out only lowers the least time;
nothing in it can raise a share above what the work needs.

Histograms (LightGBM v2.3.2's algorithm): the root over every row of the
iteration's sample, then at each split the smaller child only (the larger
comes from subtraction); each row read once (its F bin bytes, its g and
h), each histogram of (g, h, count) over F x max_bin written once; the
operations are the adds.  The iteration adds the gradient pass (scores
and labels read, g and h written; for lambdarank one operation per pair
slot, the sum of the squared query sizes) and the score update (each
score read and written).
"""
from __future__ import annotations

# NVIDIA's H100 SXM data sheet at its 700 W limit (copied from
# lightgbm_tpu_torch/obs/profile.py)
H100_HBM_BYTES_PER_S = 3.35e12
H100_F32_OPS_PER_S = 67e12

F32 = 4


def bin_bytes(max_bin: int) -> int:
    return 1 if max_bin <= 256 else 2


def hist_rows(tree: dict) -> int:
    """Rows the tree's histograms need: the root's sample, then the
    smaller child of each split."""
    if tree["num_leaves"] <= 1:
        return 0

    def count(child):
        return (tree["internal_count"][child] if child >= 0
                else tree["leaf_count"][~child])

    rows = int(tree["internal_count"][0])
    for node in range(tree["num_leaves"] - 1):
        rows += int(min(count(tree["left_child"][node]),
                        count(tree["right_child"][node])))
    return rows


def hist_cost(tree: dict, features: int, max_bin: int):
    """(operations, bytes) of the tree's needed histograms."""
    if tree["num_leaves"] <= 1:
        return 0.0, 0.0
    rows = hist_rows(tree)
    n_hist = tree["num_leaves"]            # the root and one per split
    nbytes = rows * (features * bin_bytes(max_bin) + 2 * F32) \
        + n_hist * features * max_bin * 3 * F32
    return float(rows * features * 3), float(nbytes)


def iteration_cost(tree: dict, rows: int, features: int, max_bin: int,
                   pair_slots: float = 0.0):
    """(operations, bytes) of one iteration that grew ``tree``."""
    ops, nbytes = hist_cost(tree, features, max_bin)
    nbytes += rows * 2 * F32 + rows * 2 * F32      # gradient pass
    nbytes += rows * 2 * F32                       # score update
    return ops + pair_slots, nbytes


def least_seconds(ops: float, nbytes: float) -> float:
    """The larger of operations over the f32 peak and bytes over the
    memory rate."""
    return max(ops / H100_F32_OPS_PER_S, nbytes / H100_HBM_BYTES_PER_S)
