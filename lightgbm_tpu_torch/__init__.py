"""lightgbm_tpu_torch — the PyTorch/CUDA port of lightgbm_tpu.

It trains GBDTs of every objective of the JAX package: host binning
(through a g++-built native loop where it loads; dense, scipy sparse and
LibSVM input; numerical and categorical features, EFB bundles, bins
wider than 255; binary dataset files), gradients (or custom ones), bagging
GOSS, DART and random forests, the wave-scheduled grower whose per-wave histograms come from a
hand-written CUDA kernel (``ops/hist_wave.py``, ``csrc/hist_wave.cu``) in
the float and the quantized int16/int8 modes (columns wider than 256 bins
on a PyTorch side-pass), the serial grower (forced splits, CEGB, by-node
sampling, all-wide columns) whose leaf histograms come from the second
kernel (``ops/hist_channels.py``, ``csrc/hist_channels.cu``), the split
scan (numerical and categorical), the score update, init scores and
continued training, callbacks (learning-rate schedules included), early
stopping and cross-validation (``cv``), checkpoints with bit-exact resume
and a guard around the device steps (``robust/``).  It saves and loads
LightGBM model text (categorical trees included; a loaded model's
objective converts its output) and predicts on the host or, for large
inputs, through the stacked forest on the device (``core/forest.py``);
it explains predictions by TreeSHAP (``pred_contrib``: ``explain/`` on the
device, ``core/shap.py`` on the host) and writes a model as C code
(``model_to_if_else``).  ``python -m lightgbm_tpu_torch`` is the CLI
(``task=train``, ``task=predict``, ``task=convert_model``,
``task=serve``, ``task=refit``, ``task=online``); ``serve/`` serves
models from the device, and ``online/`` refits their leaves on the device
(``Booster.refit``) and feeds a label stream back into fresh served
versions.  The v2.3.2
Python API is whole: ``Dataset`` and ``Booster`` (pandas input, pickling,
``trees_to_dataframe`` and the rest), the scikit-learn estimators
(``sklearn.py``) and the plots (``plotting.py``).  ``obs/`` is the
observability plane: telemetry, spans and the flight recorder, the
memory census, kernel times against their bounds, training-health
sentinels and the drift and quality plane.
It imports torch and numpy (scipy for sparse input; pandas, matplotlib,
graphviz and scikit-learn where their features are used), never jax or
lightgbm_tpu.  Anything
outside the port raises ``LightGBMError`` naming the ROADMAP.md item that
will bring it.
"""
from .basic import Booster, Dataset
from .callback import (early_stopping, print_evaluation, record_evaluation,
                       reset_parameter)
from .config import Config
from .engine import CVBooster, cv, train
from .utils.log import LightGBMError

try:  # the sklearn wrappers are optional at import time
    from .sklearn import LGBMClassifier, LGBMModel, LGBMRanker, LGBMRegressor
    _SKLEARN = ["LGBMModel", "LGBMRegressor", "LGBMClassifier", "LGBMRanker"]
except ImportError:  # pragma: no cover
    _SKLEARN = []

try:
    from .plotting import (create_tree_digraph, plot_importance, plot_metric,
                           plot_split_value_histogram, plot_tree)
    _PLOT = ["plot_importance", "plot_metric", "plot_tree",
             "create_tree_digraph", "plot_split_value_histogram"]
except ImportError:  # pragma: no cover
    _PLOT = []

__version__ = "0.1.0"

__all__ = ["Booster", "CVBooster", "Config", "Dataset", "LightGBMError",
           "cv", "early_stopping", "print_evaluation", "record_evaluation",
           "reset_parameter", "train"] + _SKLEARN + _PLOT
