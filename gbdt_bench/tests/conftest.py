import os
import sys
from pathlib import Path

# two threads a worker, set before any OpenMP runtime loads: the CPU runs
# of whole cells spin idle threads when several workers each take every
# core
os.environ.setdefault("OMP_NUM_THREADS", "2")

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (skips without one); run on the "
        "card with `python -m pytest gbdt_bench/tests -m cuda -q`")
