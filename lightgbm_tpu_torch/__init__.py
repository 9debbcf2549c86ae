"""lightgbm_tpu_torch — the PyTorch/CUDA port of lightgbm_tpu.

It trains the binary GBDT: host binning (through a g++-built native loop
where it loads; numerical and categorical features, EFB bundles, bins
wider than 255), binary log-loss gradients, bagging and GOSS, the
wave-scheduled grower whose per-wave histograms come from a hand-written
CUDA kernel (``ops/hist_wave.py``, ``csrc/hist_wave.cu``) in the float
and the quantized int16/int8 modes (columns wider than 256 bins on a
PyTorch side-pass), the split scan (numerical and categorical), the
score update, callbacks and early stopping.  It saves and loads
LightGBM model text (categorical trees included; a loaded model's
objective converts its output) and predicts on the host or, for large
inputs, through the stacked forest on the device (``core/forest.py``).  ``python -m
lightgbm_tpu_torch`` is the CLI (``task=train``, ``task=predict``).
``ops/hist_channels.py`` holds the reference's dense channel histogram
kernel.  It imports torch and numpy, never jax or lightgbm_tpu.  Anything
outside the port raises ``LightGBMError`` naming the ROADMAP.md item that
will bring it.
"""
from .basic import Booster, Dataset
from .callback import early_stopping, print_evaluation, record_evaluation
from .engine import train
from .utils.log import LightGBMError

__all__ = ["Booster", "Dataset", "LightGBMError", "early_stopping",
           "print_evaluation", "record_evaluation", "train"]
