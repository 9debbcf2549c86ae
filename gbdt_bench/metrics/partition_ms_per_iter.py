"""partition_ms_per_iter: device time of the work launched under the
program's ``lgbm/grow.partition`` range (the wave grower's partition:
``apply_splits``, or the sequential oracle's ``split_once`` calls), per
traced iteration; nothing without a device track or where the program
opens no such range."""
RANGE = "lgbm/grow.partition"


def read(run):
    if run.trace is None or not run.trace.device \
            or not run.trace.ranges(RANGE):
        return None
    return run.trace.under_range_us(RANGE) / 1e3 / run.traced_iters
