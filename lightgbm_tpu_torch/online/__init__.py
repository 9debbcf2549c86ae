"""online/: refit and the closed loop from served traffic to fresh models
(counterpart of lightgbm_tpu/online/).

``refit.py`` is the device leaf refit over a frozen forest (one stacked
leaf walk, then one step an iteration, with repeatable per-leaf sums);
``binspace.py`` refits and continues a model from its file alone, binning
new rows in the model's own bin space; ``loop.py`` is ``task=online``:
the label stream, the ingest window, the refresh cadence and the push
through the registry's canary-gated swap.
"""
from .binspace import (continue_dataset, model_bin_mappers,
                       refit_from_model, train_continue)
from .loop import OnlineLoop, read_label_stream, run_online
from .refit import device_refit_models

__all__ = [
    "OnlineLoop",
    "continue_dataset",
    "device_refit_models",
    "model_bin_mappers",
    "read_label_stream",
    "refit_from_model",
    "run_online",
    "train_continue",
]
