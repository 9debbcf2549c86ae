"""``python -m lightgbm_tpu_torch task=... config=...`` (reference:
src/main.cpp)."""
from .app import main

if __name__ == "__main__":
    main()
