"""commit_ms_per_iter: host time of the program's ``lgbm/grow.commit``
ranges (the wave grower's best-first ``pick_split``/``commit`` loop, in
numpy), per traced iteration; nothing where the program opens no such
range."""
RANGE = "lgbm/grow.commit"


def read(run):
    spans = [] if run.trace is None else run.trace.ranges(RANGE)
    if not spans:
        return None
    return sum(e - s for s, e in spans) / 1e3 / run.traced_iters
