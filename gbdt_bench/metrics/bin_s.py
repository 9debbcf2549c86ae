"""bin_s: host seconds of ``Dataset(...).construct()`` (the port's host
binning), by the harness's clock."""


def read(run):
    return run.bin_s
