"""host_wait_ms_per_iter: host time of the program's ``lgbm/wait``
ranges (each a point where the host blocks on the card), per traced
iteration; nothing where the program opens no such range."""
RANGE = "lgbm/wait"


def read(run):
    spans = [] if run.trace is None else run.trace.ranges(RANGE)
    if not spans:
        return None
    return sum(e - s for s, e in spans) / 1e3 / run.traced_iters
