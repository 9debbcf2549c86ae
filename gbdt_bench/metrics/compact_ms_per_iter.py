"""compact_ms_per_iter: device time of the work launched under the
program's ``lgbm/grow.compact`` range (the wave grower's active-row
compaction: the mask, ``nonzero`` and the gathers), per traced
iteration; nothing without a device track or where the program opens no
such range."""
RANGE = "lgbm/grow.compact"


def read(run):
    if run.trace is None or not run.trace.device \
            or not run.trace.ranges(RANGE):
        return None
    return run.trace.under_range_us(RANGE) / 1e3 / run.traced_iters
