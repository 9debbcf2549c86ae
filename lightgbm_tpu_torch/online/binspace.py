"""The model's own training bin space: continued training and refit from a
model file alone (counterpart of lightgbm_tpu/online/binspace.py).

Continued training normally bins the new rows from scratch, which needs a
sample big enough to find good quantiles and gives a bin space unrelated
to the one serving rebuilds from the model (``serve/packing.py``).  Here
new rows are binned through the model's own split state instead:
``BinMapper.from_thresholds`` for a numerical feature (the sorted distinct
split thresholds become the bin bounds, so every node decision is
reproduced exactly) and ``BinMapper.categorical_from_categories`` for a
categorical one (the categories the bitsets reference become the bins,
plus a NaN/unseen catch-all).  The replayed forest then routes every row
as the host's value-space walk does, and new trees grow in that space:
their thresholds are thresholds the model already has, so serving's bin
space stays stable across refreshes.
"""
from __future__ import annotations

import copy
import os
from typing import List, Optional

import numpy as np

from ..io.binning import BinMapper
from ..serve.packing import collect_split_state
from ..utils import log


def model_bin_mappers(models, num_features: int) -> List[BinMapper]:
    """One training ``BinMapper`` per original feature, from the forest's
    split state.  A feature no tree splits on gets a trivial mapper: the
    dataset leaves it out, the replayed trees never read it, and no new
    tree could split on what the bin space cannot tell apart."""
    thr_vals, miss, is_cat, cats, _ = collect_split_state(
        models, num_features, want_cats=True)
    mappers: List[BinMapper] = []
    for f in range(num_features):
        if is_cat[f]:
            mappers.append(BinMapper.categorical_from_categories(cats[f]))
        elif thr_vals[f]:
            mappers.append(BinMapper.from_thresholds(thr_vals[f],
                                                     int(miss[f])))
        else:
            mappers.append(BinMapper())
    return mappers


def continue_dataset(models, X, label=None, weight=None,
                     params: Optional[dict] = None,
                     num_features: Optional[int] = None,
                     feature_names: Optional[List[str]] = None):
    """A constructed :class:`~lightgbm_tpu_torch.basic.Dataset` in the
    model's bin space, not the data's (the continued-training analog of
    ``ServeBinSpace.bin_matrix``): ``models`` the forest (host ``Tree``s),
    ``X`` the raw rows."""
    from ..basic import Dataset
    from ..io.dataset import BinnedDataset, Metadata

    X = np.ascontiguousarray(np.asarray(X, dtype=np.float64))
    if X.ndim != 2:
        raise ValueError("continue_dataset needs a 2-D feature matrix")
    F = X.shape[1]
    need = max((int(t.split_feature[i]) + 1 for t in models
                for i in range(max(t.num_leaves - 1, 0))), default=0)
    if F < need:
        raise ValueError(f"continue data has {F} features, the model "
                         f"splits on feature {need - 1}")
    binned = BinnedDataset()
    binned.num_data = int(X.shape[0])
    binned.num_total_features = F
    binned.metadata = Metadata(binned.num_data)
    binned.bin_mappers = model_bin_mappers(models, F)
    binned.max_bin = int(max((m.num_bin for m in binned.bin_mappers),
                             default=1))
    binned.feature_names = (list(feature_names)
                            if feature_names and len(feature_names) == F
                            else [f"Column_{i}" for i in range(F)])
    binned._finalize_features()
    binned._binarize(X)
    ds = Dataset(None, params=dict(params or {}))
    ds._handle = binned
    if label is not None:
        ds.set_label(np.asarray(label, dtype=np.float64).ravel())
    if weight is not None:
        ds.set_weight(np.asarray(weight, dtype=np.float64).ravel())
    return ds


def model_params(gbdt) -> dict:
    """The objective (and ``num_class``) a model file's header names: the
    parameters a refit or a continuation of a loaded forest starts from
    (the JAX package's minimal config of a loaded model)."""
    obj = (gbdt.objective_string or "").split()
    if not obj or obj[0] == "custom":
        return {}
    out = {"objective": obj[0]}
    if gbdt.num_class > 1:
        out["num_class"] = int(gbdt.num_class)
    return out


def _load_models_and_params(model):
    """(trees, base params, feature names) of a Booster or a model file."""
    from ..basic import Booster
    from ..io.model_io import load_model_file

    if isinstance(model, Booster):
        return list(model._gbdt.models), dict(model.params or {}), None
    loaded = load_model_file(os.fsdecode(model), "cpu")
    return (list(loaded.models), model_params(loaded),
            loaded.feature_names or None)


def train_continue(model, X, label, params: Optional[dict] = None,
                   num_boost_round: int = 10, weight=None, **train_kw):
    """Boost ``num_boost_round`` more trees onto ``model`` (a model file or
    a ``Booster``) from the model and the new rows alone: the rows are
    binned in the model's bin space, and ``init_model`` replays the forest
    before the first new iteration.  The model's objective and
    ``num_class`` seed the parameters; ``params`` entries win.  Returns
    the continued :class:`Booster`."""
    from ..basic import Booster
    from ..engine import train as train_api

    if not (isinstance(model, (Booster, str, bytes))
            or hasattr(model, "__fspath__")):
        raise TypeError("train_continue needs a Booster or a model file "
                        f"path, met {type(model).__name__}")
    models, base_params, feature_names = _load_models_and_params(model)
    if not models:
        raise ValueError("cannot continue an empty model")
    merged = {**base_params, **(params or {})}
    log.info("train_continue: %d new rows binned in the model's own bin "
             "space, boosting %d more round(s) onto %d tree(s)",
             int(np.asarray(X).shape[0]), num_boost_round, len(models))
    ds = continue_dataset(models, X, label=label, weight=weight,
                          params=merged, feature_names=feature_names)
    return train_api(merged, ds, num_boost_round=num_boost_round,
                     init_model=model, verbose_eval=False, **train_kw)


def refit_from_model(model, X, label, params: Optional[dict] = None,
                     decay_rate: Optional[float] = None, weight=None):
    """Leaf refit of a model (file or ``Booster``) over new rows binned in
    the model's bin space: the online loop's refit.

    ``Booster.refit`` bins the new rows from scratch, which quantizes the
    frozen thresholds to the new data's bins and can misroute a row that
    shares a new bin with a threshold.  In the model's threshold space
    every node decision is reproduced exactly, so each leaf is refit over
    exactly the rows the serving forest sends there."""
    from ..basic import Booster

    models, base_params, feature_names = _load_models_and_params(model)
    if not models:
        raise ValueError("cannot refit an empty model")
    merged = {**base_params, **(params or {})}
    if decay_rate is not None:
        merged["refit_decay_rate"] = float(decay_rate)
    ds = continue_dataset(models, X, label=label, weight=weight,
                          params=merged, feature_names=feature_names)
    bst = Booster(params=merged, train_set=ds)
    bst._gbdt.load_initial_models([copy.deepcopy(t) for t in models],
                                  replay_scores=False)
    bst._gbdt.refit_models(decay_rate)
    return bst
