"""device_idle_pct: 1 - (the union of the device's kernel, memcpy and
memset intervals a traced iteration) / (the unprofiled iteration time of
the window), in percent."""


def read(run):
    if run.trace is None:
        return None
    busy_s = run.trace.busy_us() / 1e6 / run.traced_iters
    if busy_s <= 0:
        return None
    return 100.0 * (1.0 - busy_s / run.iter_s)
