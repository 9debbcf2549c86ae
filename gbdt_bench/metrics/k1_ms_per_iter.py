"""k1_ms_per_iter: device time of the kernels whose symbol holds
``hist_wave`` (K1), per traced iteration."""


def read(run):
    if run.trace is None:
        return None
    us = run.trace.kernel_us("hist_wave")
    if us <= 0:
        return None
    return us / 1e3 / run.traced_iters
