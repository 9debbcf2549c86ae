"""``python -m lightgbm_tpu_torch.fleet <key=value ...>``: one fleet rank."""
import sys

from .elastic import run_rank

if __name__ == "__main__":
    sys.exit(run_rank() or 0)
