"""host_waits_per_tree: the program's ``lgbm/wait`` ranges (each a point
where the host blocks on the card) over the trees the traced iterations
grew; nothing where the program opens no such range."""
RANGE = "lgbm/wait"


def read(run):
    spans = [] if run.trace is None else run.trace.ranges(RANGE)
    if not spans or not run.traced_trees:
        return None
    return len(spans) / len(run.traced_trees)
