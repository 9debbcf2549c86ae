"""hist_store_roofline: the leaf histograms' stores against their
roofline, in percent: the least time of the histogram traffic the traced
trees needed over the device time launched under the program's
``lgbm/grow.hist_store`` range.

The count is this file's own, from the model text, whatever implements
the stores: at each split the parent's [F, max_bin, 3] f32 histogram
read once and its two children's written once, and the root's written
once (as ``yardstick.hist_cost`` takes B = ``max_bin``); bytes over the
memory rate (``yardstick.least_seconds``).  Nothing without a device
track or where the program opens no such range."""
from gbdt_bench import yardstick

RANGE = "lgbm/grow.hist_store"


def store_bytes(tree: dict, features: int, max_bin: int) -> float:
    """Bytes of one tree's needed histogram traffic: 3 histograms a split
    (the parent read, two children written) and the root's."""
    if tree["num_leaves"] <= 1:
        return 0.0
    hist = features * max_bin * 3 * yardstick.F32
    return float((3 * (tree["num_leaves"] - 1) + 1) * hist)


def read(run):
    if run.trace is None or not run.trace.device \
            or not run.trace.ranges(RANGE):
        return None
    us = run.trace.under_range_us(RANGE)
    if us <= 0:
        return None
    need = sum(yardstick.least_seconds(0.0, store_bytes(
        t, run.features, run.max_bin)) for t in run.traced_trees)
    return 100.0 * need / (us / 1e6)
