"""iter_mfu_pct: the least time of the window's needed work on the card
(``yardstick.iteration_cost`` of each tree the window grew, at the H100's
peaks) over the window's seconds, in percent.  Only for a run on the
card: it is a share of that card's peak."""
from gbdt_bench import yardstick


def read(run):
    if run.device_type != "cuda" or not run.window_trees:
        return None
    need = sum(yardstick.least_seconds(*yardstick.iteration_cost(
        t, run.rows, run.features, run.max_bin, run.pair_slots))
        for t in run.window_trees)
    return 100.0 * need / run.window_s
