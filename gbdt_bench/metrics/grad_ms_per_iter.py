"""grad_ms_per_iter: device time of the work launched under the
harness's ``bench/gradients`` range (around the booster's
``objective.get_gradients``), per traced iteration."""


def read(run):
    if run.trace is None or not run.trace.device:
        return None
    us = run.trace.under_range_us("bench/gradients")
    if us <= 0:
        return None
    return us / 1e3 / run.traced_iters
