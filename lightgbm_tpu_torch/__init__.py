"""lightgbm_tpu_torch — the PyTorch/CUDA port of lightgbm_tpu.

It trains GBDTs of every objective of the JAX package: host binning
(through a g++-built native loop where it loads; dense, scipy sparse and
LibSVM input; numerical and categorical features, EFB bundles, bins
wider than 255; binary dataset files), gradients (or custom ones), bagging
and GOSS, the wave-scheduled grower whose per-wave histograms come from a
hand-written CUDA kernel (``ops/hist_wave.py``, ``csrc/hist_wave.cu``) in
the float and the quantized int16/int8 modes (columns wider than 256 bins
on a PyTorch side-pass), the serial grower (forced splits, CEGB, by-node
sampling, all-wide columns) whose leaf histograms come from the second
kernel (``ops/hist_channels.py``, ``csrc/hist_channels.cu``), the split
scan (numerical and categorical), the score update, init scores and
continued training, callbacks (learning-rate schedules included), early
stopping and cross-validation (``cv``).  It saves and loads
LightGBM model text (categorical trees included; a loaded model's
objective converts its output) and predicts on the host or, for large
inputs, through the stacked forest on the device (``core/forest.py``).  ``python -m
lightgbm_tpu_torch`` is the CLI (``task=train``, ``task=predict``).
It imports torch and numpy (scipy for sparse input), never jax or
lightgbm_tpu.  Anything
outside the port raises ``LightGBMError`` naming the ROADMAP.md item that
will bring it.
"""
from .basic import Booster, Dataset
from .callback import (early_stopping, print_evaluation, record_evaluation,
                       reset_parameter)
from .engine import CVBooster, cv, train
from .utils.log import LightGBMError

__all__ = ["Booster", "CVBooster", "Dataset", "LightGBMError", "cv",
           "early_stopping", "print_evaluation", "record_evaluation",
           "reset_parameter", "train"]
