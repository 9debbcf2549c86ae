"""hist_store_ms_per_iter: device time of the work launched under the
program's ``lgbm/grow.hist_store`` range (the leaf histograms' layouts
and stores around K1: the parents' gather, the children's and siblings'
layouts, an unfused subtraction and the stores), per traced iteration;
nothing without a device track or where the program opens no such
range."""
RANGE = "lgbm/grow.hist_store"


def read(run):
    if run.trace is None or not run.trace.device \
            or not run.trace.ranges(RANGE):
        return None
    return run.trace.under_range_us(RANGE) / 1e3 / run.traced_iters
