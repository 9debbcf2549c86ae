"""k1_roofline: K1's share of its roofline, in percent: the least time of
the histograms the traced iterations' trees needed
(``yardstick.hist_cost``) over K1's device time in those iterations."""
from gbdt_bench import yardstick


def read(run):
    if run.trace is None:
        return None
    us = run.trace.kernel_us("hist_wave")
    if us <= 0:
        return None
    need = sum(yardstick.least_seconds(*yardstick.hist_cost(
        t, run.features, run.max_bin)) for t in run.traced_trees)
    return 100.0 * need / (us / 1e6)
