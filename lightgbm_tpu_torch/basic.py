"""Dataset and Booster (counterpart of lightgbm_tpu/basic.py; reference:
python-package/lightgbm/basic.py).  Binning runs on the host; a Booster
trains and predicts on ``device`` ("cuda" unless the caller, or the
``device_type`` parameter, asks for "cpu")."""
from __future__ import annotations

import copy
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .boosting import create_boosting
from .config import Config
from .io.dataset import BinnedDataset
from .metric import create_metrics
from .objective import create_objective
from .utils.log import LightGBMError, refuse


def parse_categorical_spec(spec: str) -> list:
    """A ``categorical_feature`` string (``0,1,3`` or ``name:a,b``) as
    indices and names (reference package: app.py
    ``_resolve_cli_categoricals``)."""
    cats = []
    for tok in str(spec or "").replace("name:", "").split(","):
        tok = tok.strip()
        if tok:
            cats.append(int(tok) if tok.isdigit() else tok)
    return cats


def resolve_device(device) -> torch.device:
    """The device to run on; CUDA must be present when it is asked for."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise LightGBMError("device='cuda' but torch.cuda.is_available() is "
                            "False; pass device='cpu' (device_type=cpu) to "
                            "run on the CPU")
    if device.type not in ("cuda", "cpu"):
        raise LightGBMError(f"unsupported device {device}")
    return device


class Dataset:
    """Training/validation data with lazy binning (reference:
    basic.py:712-1664): dense matrices, labels, sample weights, query
    groups (sizes, or boundaries), and categorical columns by index or
    name (``categorical_feature``, or the parameter of that name).  A
    valid set carries its own weights and groups."""

    def __init__(self, data, label=None, reference: Optional["Dataset"] = None,
                 weight=None, group=None, init_score=None,
                 feature_name="auto", categorical_feature="auto",
                 params: Optional[Dict[str, Any]] = None,
                 free_raw_data: bool = True):
        if init_score is not None:
            refuse("init scores", "the rest of queue 1")
        self.categorical_feature = categorical_feature
        self.data = data
        self.label = label
        self.weight = weight
        self.group = group
        self.reference = reference
        self.feature_name = feature_name
        self.params = dict(params) if params else {}
        self.free_raw_data = free_raw_data
        self._handle: Optional[BinnedDataset] = None

    def construct(self) -> "Dataset":
        """Bin the raw data (reference: _lazy_init, basic.py:819)."""
        if self._handle is not None:
            return self
        if self.data is None:
            raise LightGBMError("Cannot construct Dataset: raw data was freed")
        if hasattr(self.data, "tocsr"):
            refuse("sparse input", "the rest of queue 1")
        mat = np.asarray(self.data)
        names = (list(self.feature_name)
                 if isinstance(self.feature_name, (list, tuple)) else None)
        ref = (self.reference.construct()._handle
               if self.reference is not None else None)
        self._handle = BinnedDataset.from_matrix(
            mat, Config.from_params(self.params),
            categorical_features=self._resolve_categorical(
                names or [f"Column_{i}" for i in range(mat.shape[1])]),
            feature_names=names, reference=ref)
        if self.label is not None:
            self._handle.metadata.set_label(self.label)
        self.set_weight(self.weight)
        self.set_group(self.group)
        if self.free_raw_data:
            self.data = None
        return self

    def _resolve_categorical(self, names: List[str]) -> List[int]:
        """Column indices of the categorical features (reference package:
        basic.py ``_resolve_categorical``): the argument, else the
        ``categorical_feature`` parameter; entries are indices or names,
        and a string is a comma-separated spec (``name:`` prefix
        allowed)."""
        cats = self.categorical_feature
        if cats == "auto" or cats is None:
            cats = self.params.get("categorical_feature", [])
        if isinstance(cats, str):
            cats = parse_categorical_spec(cats)
        out = []
        for c in cats or []:
            if isinstance(c, str):
                if c in names:
                    out.append(names.index(c))
            else:
                out.append(int(c))
        return sorted(set(out))

    def set_weight(self, weight) -> None:
        self.weight = weight
        if self._handle is not None and weight is not None:
            self._handle.metadata.set_weights(np.asarray(weight).ravel())

    def set_group(self, group) -> None:
        """Query sizes (or boundaries) of the rows, in row order."""
        self.group = group
        if self._handle is not None and group is not None:
            self._handle.metadata.set_query(np.asarray(group).ravel())

    def get_group(self):
        return self.group

    def num_data(self) -> int:
        return self.construct()._handle.num_data

    def num_feature(self) -> int:
        return self.construct()._handle.num_total_features


class Booster:
    """Model handle: trains through ``update`` when built from a Dataset,
    or predicts from a model file or string (reference: basic.py:1666+)."""

    def __init__(self, params: Optional[Dict[str, Any]] = None,
                 train_set: Optional[Dataset] = None,
                 model_file: Optional[str] = None,
                 model_str: Optional[str] = None, device=None):
        self.params = dict(params) if params else {}
        self.config = Config.from_params(self.params)
        self.device = resolve_device(device or self.config.device_type)
        self.best_iteration = -1
        self.best_score: Dict = {}
        self._train_data_name = "training"
        self.train_set = None
        self.valid_sets: List[Dataset] = []
        if train_set is not None:
            if not isinstance(train_set, Dataset):
                raise TypeError("Training data should be Dataset instance, "
                                f"met {type(train_set).__name__}")
            train_set.params = {**train_set.params, **self.params}
            train_set.construct()
            self.train_set = train_set
            self._gbdt = create_boosting(self.config)
            self._gbdt.init(self.config, train_set._handle,
                            create_objective(self.config),
                            create_metrics(self.config), self.device)
        elif model_file is not None or model_str is not None:
            from .io.model_io import load_model_file, load_model_string
            self._gbdt = (load_model_file(model_file, self.device)
                          if model_file is not None
                          else load_model_string(model_str, self.device))
        else:
            raise TypeError("Need at least one training dataset or model "
                            "file or model string to create Booster instance")

    def add_valid(self, data: Dataset, name: str) -> "Booster":
        """Attach a valid set; trees grown so far are replayed onto it."""
        if self.train_set is None:
            raise LightGBMError("Cannot add validation data to a booster "
                                "without training data")
        if data._handle is None:
            data.reference = self.train_set
            data.construct()
        elif data._handle.bin_mappers is not self.train_set._handle.bin_mappers:
            raise LightGBMError("Cannot add validation data, since it has "
                                "different bin mappers with training data; "
                                "construct it with reference=train_set")
        self._gbdt.add_valid(data._handle, name)
        self.valid_sets.append(data)
        return self

    def update(self) -> bool:
        """One boosting iteration; True = no further splits possible."""
        return self._gbdt.train_one_iter()

    def eval_train(self) -> List:
        return [(self._train_data_name,) + e[1:]
                for e in self._gbdt.eval_results(include_train=True)
                if e[0] == "training"]

    def eval_valid(self) -> List:
        return self._gbdt.eval_results(include_train=False)

    def current_iteration(self) -> int:
        return self._gbdt.current_iteration()

    def num_trees(self) -> int:
        return self._gbdt.num_trees

    def num_model_per_iteration(self) -> int:
        return self._gbdt.num_tpi

    def feature_name(self) -> List[str]:
        if self._gbdt.train_ds is not None:
            return list(self._gbdt.train_ds.feature_names)
        return list(self._gbdt.feature_names)

    def num_feature(self) -> int:
        if self._gbdt.train_ds is not None:
            return self._gbdt.train_ds.num_total_features
        return self._gbdt.num_features

    def predict(self, data, num_iteration: Optional[int] = None,
                raw_score: bool = False, pred_leaf: bool = False,
                pred_contrib: bool = False, start_iteration: int = 0,
                **kwargs) -> np.ndarray:
        """Predictions for a dense matrix: probabilities, raw margins
        (``raw_score``) or leaf indices (``pred_leaf``).  ``kwargs`` are
        parameters for this call only, such as ``pred_early_stop``,
        ``pred_early_stop_freq`` and ``pred_early_stop_margin``.  Without
        ``num_iteration`` the best iteration of early stopping is used,
        else every tree."""
        if pred_contrib:
            refuse("pred_contrib (TreeSHAP)", "the rest of queue 1: explain")
        if hasattr(data, "tocsr"):
            refuse("sparse input", "the rest of queue 1")
        mat = np.asarray(data, dtype=np.float64)
        if mat.ndim != 2 or mat.shape[1] != self.num_feature():
            raise LightGBMError(
                f"The number of features in data ({mat.shape[-1]}) is not the "
                f"same as it was in training data ({self.num_feature()})")
        if num_iteration is None:
            num_iteration = (self.best_iteration if self.best_iteration > 0
                             else -1)
        if pred_leaf:
            return self._gbdt.predict_leaf(mat, num_iteration,
                                           start_iteration)
        config = self.config
        if kwargs:
            config = copy.copy(config)
            config.update(kwargs)
        return self._gbdt.predict(mat, num_iteration, raw_score,
                                  start_iteration, config=config)

    def model_to_string(self, num_iteration: Optional[int] = None,
                        start_iteration: int = 0) -> str:
        from .io.model_io import model_to_string
        if num_iteration is None:
            num_iteration = (self.best_iteration if self.best_iteration > 0
                             else -1)
        return model_to_string(self._gbdt, num_iteration, start_iteration)

    def save_model(self, filename: str, num_iteration: Optional[int] = None,
                   start_iteration: int = 0) -> "Booster":
        with open(filename, "w") as fh:
            fh.write(self.model_to_string(num_iteration, start_iteration))
        return self

    def dump_model(self, num_iteration: Optional[int] = None,
                   start_iteration: int = 0) -> Dict[str, Any]:
        """The model as a nested dict, the reference's JSON structure
        (reference: GBDT::DumpModel, gbdt_model_text.cpp:20-85)."""
        from .io.model_json import dump_model
        if num_iteration is None:
            num_iteration = (self.best_iteration if self.best_iteration > 0
                             else -1)
        return dump_model(self._gbdt, num_iteration, start_iteration)

    def feature_importance(self, importance_type: str = "split",
                           iteration: Optional[int] = None) -> np.ndarray:
        return self._gbdt.feature_importance(
            importance_type,
            num_iteration=-1 if iteration is None else int(iteration))

    def reset_parameter(self, params: Dict[str, Any]) -> "Booster":
        """Change parameters that act from now on: the prediction knobs
        (``pred_early_stop*``) and, while training, ``learning_rate``."""
        self.params.update(params)
        self.config.update(params)
        if self._gbdt.train_ds is not None:
            self._gbdt.shrinkage_rate = float(self.config.learning_rate)
        return self
