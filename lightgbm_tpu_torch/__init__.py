"""lightgbm_tpu_torch — the PyTorch/CUDA port of lightgbm_tpu.

It trains the binary GBDT: host binning, binary log-loss gradients,
bagging, the wave-scheduled grower whose per-wave histograms come from a
hand-written CUDA kernel (``ops/hist_wave.py``, ``csrc/hist_wave.cu``) in
the float and the quantized int16/int8 modes, the split scan, the score
update and the model text.  ``ops/hist_channels.py`` holds the
reference's dense channel histogram kernel.  It imports torch and numpy, never jax or lightgbm_tpu.  Anything
outside the slice raises ``LightGBMError`` naming the ROADMAP.md item that
will bring it.
"""
from .basic import Booster, Dataset
from .engine import train
from .utils.log import LightGBMError

__all__ = ["Booster", "Dataset", "LightGBMError", "train"]
