"""Dataset and Booster (counterpart of lightgbm_tpu/basic.py; reference:
python-package/lightgbm/basic.py).  Binning runs on the host; a Booster
trains and predicts on ``device`` ("cuda" unless the caller, or the
``device_type`` parameter, asks for "cpu")."""
from __future__ import annotations

import copy
import os
from typing import Any, Dict, List, Optional, Sequence

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


def _is_scipy_sparse(data) -> bool:
    return hasattr(data, "toarray") and hasattr(data, "tocsr")


def _same_bin_mappers(a: BinnedDataset, b: BinnedDataset) -> bool:
    """Whether two constructed datasets share one bin space (reference:
    Dataset::CheckAlign; reference package: basic.py
    ``_same_bin_mappers``)."""
    if a.bin_mappers is b.bin_mappers:
        return True
    if len(a.bin_mappers) != len(b.bin_mappers):
        return False
    for ma, mb in zip(a.bin_mappers, b.bin_mappers):
        if (ma.num_bin != mb.num_bin or ma.bin_type != mb.bin_type
                or ma.missing_type != mb.missing_type
                or not np.array_equal(ma.bin_upper_bound, mb.bin_upper_bound)
                or ma.bin_2_categorical != mb.bin_2_categorical):
            return False
    return True


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
    basic.py:712-1664): dense matrices, scipy sparse matrices (binned
    without densifying), or the name of a file ``save_binary`` wrote;
    labels, sample weights, query groups (sizes, or boundaries), init
    scores (class major for K trees an iteration), and categorical columns
    by index or name (``categorical_feature``, or the parameter of that
    name).  A valid set carries its own weights, groups and init scores."""

    def __init__(self, data, label=None, reference: Optional["Dataset"] = None,
                 weight=None, group=None, init_score=None,
                 feature_name="auto", categorical_feature="auto",
                 params: Optional[Dict[str, Any]] = None,
                 free_raw_data: bool = True):
        self.init_score = init_score
        self.used_indices: Optional[np.ndarray] = None
        self._matrix_cache = None
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
        if isinstance(self.data, (str, bytes)) or hasattr(self.data,
                                                          "__fspath__"):
            from .io.dataset_io import is_dataset_file, load_dataset
            path = os.fsdecode(self.data)
            if not is_dataset_file(path):
                raise LightGBMError(f"{path} is not a binned dataset file "
                                    "(Dataset.save_binary writes one)")
            self._handle = load_dataset(path)
        else:
            sparse = _is_scipy_sparse(self.data)
            mat = self.data if sparse else np.asarray(self.data)
            names = (list(self.feature_name)
                     if isinstance(self.feature_name, (list, tuple))
                     else None)
            ref = (self.reference.construct()._handle
                   if self.reference is not None else None)
            builder = (BinnedDataset.from_csr if sparse
                       else BinnedDataset.from_matrix)
            self._handle = builder(
                mat, Config.from_params(self.params),
                categorical_features=self._resolve_categorical(
                    names or [f"Column_{i}" for i in range(mat.shape[1])]),
                feature_names=names, reference=ref)
        if self.label is not None:
            self._handle.metadata.set_label(np.asarray(self.label).ravel())
        self.set_weight(self.weight)
        self.set_group(self.group)
        self.set_init_score(self.init_score)
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

    def set_init_score(self, init_score) -> None:
        """Starting raw scores of the rows ([N], or class major [K * N])."""
        self.init_score = init_score
        if self._handle is not None and init_score is not None:
            self._handle.metadata.set_init_score(
                np.asarray(init_score).ravel())

    def set_label(self, label) -> None:
        self.label = label
        if self._handle is not None and label is not None:
            self._handle.metadata.set_label(np.asarray(label).ravel())

    def get_label(self):
        if self._handle is not None and self._handle.metadata.label is not None:
            return self._handle.metadata.label
        return self.label

    def get_weight(self):
        return self.weight

    def get_group(self):
        return self.group

    def get_init_score(self):
        return self.init_score

    def num_data(self) -> int:
        return self.construct()._handle.num_data

    def num_feature(self) -> int:
        return self.construct()._handle.num_total_features

    def subset(self, used_indices: Sequence[int], params=None) -> "Dataset":
        """Rows ``used_indices`` in this dataset's bin space, with their
        labels, weights, groups and init scores (reference package:
        basic.py ``subset``); needs the raw data (``free_raw_data=False``),
        kept sparse when it is."""
        self.construct()
        if self.data is None:
            raise LightGBMError("Cannot subset: raw data was freed; "
                                "use free_raw_data=False")
        idx = np.asarray(used_indices)
        if self._matrix_cache is None:
            self._matrix_cache = (self.data.tocsr()
                                  if _is_scipy_sparse(self.data)
                                  else np.asarray(self.data, np.float64))
        sub = Dataset(self._matrix_cache[idx], reference=self,
                      params=params or self.params,
                      free_raw_data=self.free_raw_data)
        if self.label is not None:
            sub.label = np.asarray(self.label)[idx]
        if self.weight is not None:
            sub.weight = np.asarray(self.weight)[idx]
        if self.init_score is not None:
            K = max(1, len(np.ravel(self.init_score))
                    // self._handle.num_data)
            sub.init_score = np.asarray(self.init_score).ravel().reshape(
                K, -1)[:, idx].ravel()
        if self.group is not None:
            sizes = np.asarray(self.group).ravel()
            qid = np.repeat(np.arange(len(sizes)), sizes)[idx]
            _, counts = np.unique(qid, return_counts=True)
            sub.group = counts
        sub.used_indices = idx
        return sub

    def save_binary(self, filename: str) -> "Dataset":
        """Write the constructed dataset to ``filename``, a numpy archive
        either package loads (``io/dataset_io.py``); ``Dataset(filename)``
        reads it back."""
        self.construct()
        from .io.dataset_io import save_dataset
        save_dataset(self._handle, filename)
        return self


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
        elif not _same_bin_mappers(data._handle, self.train_set._handle):
            raise LightGBMError("Cannot add validation data, since it has "
                                "different bin mappers with training data; "
                                "construct it with reference=train_set")
        self._gbdt.add_valid(data._handle, name)
        self.valid_sets.append(data)
        return self

    def update(self, train_set: Optional[Dataset] = None,
               fobj=None) -> bool:
        """One boosting iteration; True = no further splits possible.
        ``fobj(raw_scores, train_set) -> (grad, hess)`` supplies custom
        gradients (class major for K trees an iteration)."""
        if train_set is not None and train_set is not self.train_set:
            raise LightGBMError("Resetting the training set is not "
                                "supported; create a new Booster instead")
        if fobj is None:
            return self._gbdt.train_one_iter()
        grad, hess = fobj(self._raw_train_score(), self.train_set)
        return self._gbdt.train_one_iter(np.asarray(grad), np.asarray(hess))

    def _raw_train_score(self) -> np.ndarray:
        """Raw training scores as f64: [N], or [N, K]."""
        return self._gbdt._train_score.cpu().numpy().astype(np.float64)

    def eval_train(self, feval=None) -> List:
        return [e for e in self._eval_all(feval)
                if e[0] == self._train_data_name]

    def eval_valid(self, feval=None) -> List:
        return [e for e in self._eval_all(feval, include_train=False)
                if e[0] != self._train_data_name]

    def _eval_all(self, feval=None, include_train: bool = True) -> List:
        """Every metric entry, then ``feval``'s: a function of (predictions,
        dataset) returning (name, value, higher_is_better) or a list of
        them, given converted predictions as the reference gives them."""
        out = [((self._train_data_name if e[0] == "training" else e[0]),)
               + tuple(e[1:])
               for e in self._gbdt.eval_results(include_train=include_train)]
        if feval is None:
            return out

        def run(score, dataset, tag):
            obj = self._gbdt.objective
            preds = (np.asarray(obj.convert_output(score)) if obj is not None
                     else score)
            res = feval(preds, dataset)
            if res is None:
                return
            for name, value, hib in (res if isinstance(res, list)
                                     else [res]):
                out.append((tag, name, value, hib))
        if include_train:
            run(self._raw_train_score(), self.train_set,
                self._train_data_name)
        for i, vds in enumerate(self.valid_sets):
            run(self._gbdt._valid_scores[i].cpu().numpy().astype(np.float64),
                vds, self._gbdt.valid_names[i])
        return out

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
        """Predictions for a dense or scipy sparse matrix (a narrower
        sparse one has implicit zero columns): probabilities, raw margins
        (``raw_score``) or leaf indices (``pred_leaf``).
        ``kwargs`` are parameters for this call only, such as
        ``pred_early_stop``,
        ``pred_early_stop_freq`` and ``pred_early_stop_margin``.  Without
        ``num_iteration`` the best iteration of early stopping is used,
        else every tree."""
        if pred_contrib:
            refuse("pred_contrib (TreeSHAP)", "the rest of queue 1: explain")
        if num_iteration is None:
            num_iteration = (self.best_iteration if self.best_iteration > 0
                             else -1)
        config = self.config
        if kwargs:
            config = copy.copy(config)
            config.update(kwargs)
        sparse = _is_scipy_sparse(data)
        mat = data if sparse else np.asarray(data, dtype=np.float64)
        n_feat = self.num_feature()
        if mat.ndim != 2 or (mat.shape[1] > n_feat if sparse
                             else mat.shape[1] != n_feat):
            raise LightGBMError(
                f"The number of features in data ({mat.shape[-1]}) is not the "
                f"same as it was in training data ({n_feat})")
        if pred_leaf:
            return self._gbdt.predict_leaf(mat, num_iteration,
                                           start_iteration)
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
            self._gbdt.config = self.config
            self._gbdt.shrinkage_rate = float(self.config.learning_rate)
        return self
