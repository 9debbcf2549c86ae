"""Dataset and Booster (counterpart of lightgbm_tpu/basic.py; reference:
python-package/lightgbm/basic.py).  Binning runs on the host; a Booster
trains and predicts on ``device`` ("cuda" unless the caller, or the
``device_type`` parameter, asks for "cpu").  A pandas DataFrame's column
names become feature names and its ``category`` columns their codes
(categorical unless the caller says otherwise); a Booster pickles and
copies through its model text, and comes back on the device it ran on."""
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
from .utils import log
from .utils.log import LightGBMError

_PARALLEL = "the rest of queue 1: parallel and fleet planes"


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


def _is_pandas_df(data) -> bool:
    return hasattr(data, "columns") and hasattr(data, "dtypes")


def _data_from_pandas(df, categorical_feature="auto",
                      pandas_categorical=None):
    """A DataFrame as (f64 matrix, column names, categorical_feature,
    pandas_categorical) (reference: basic.py:313-354; reference package:
    basic.py ``_data_from_pandas``).  ``category`` columns become their
    codes in the category lists of training (``pandas_categorical``, taken
    from this frame when None), NaN where a value is missing or was not
    seen in training; with ``categorical_feature="auto"`` the unordered
    ones are categorical."""
    import pandas as pd
    cat_cols = [c for c in df.columns
                if isinstance(df[c].dtype, pd.CategoricalDtype)]
    unordered = [c for c in cat_cols if not df[c].cat.ordered]
    if cat_cols:
        df = df.copy()
    if pandas_categorical is None:
        pandas_categorical = [list(df[c].cat.categories) for c in cat_cols]
    else:
        if len(cat_cols) != len(pandas_categorical):
            raise LightGBMError("train and valid dataset "
                                "categorical_feature do not match.")
        for c, cats in zip(cat_cols, pandas_categorical):
            if list(df[c].cat.categories) != list(cats):
                df[c] = df[c].cat.set_categories(cats)
    for c in cat_cols:
        codes = df[c].cat.codes.to_numpy().astype(np.float64)
        codes[codes == -1] = np.nan
        df[c] = codes
    names = [str(c) for c in df.columns]
    if categorical_feature == "auto":
        categorical_feature = [names.index(str(c)) for c in unordered]
    mat = np.ascontiguousarray(df.to_numpy(dtype=np.float64))
    return mat, names, categorical_feature, pandas_categorical


def _values(x):
    """A pandas Series or frame as its numpy values; anything else as it
    is."""
    return x.values if hasattr(x, "values") and hasattr(x, "index") else x


def _padded_dense(mat, n_feat: int) -> np.ndarray:
    """A scipy sparse matrix as dense f64 [rows, n_feat] (implicit zero
    columns past its width)."""
    out = np.zeros((mat.shape[0], n_feat))
    out[:, :mat.shape[1]] = mat.toarray()
    return out


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
                 free_raw_data: bool = True, silent: bool = False):
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
        self.pandas_categorical = None

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
            names = None
            if _is_pandas_df(self.data):
                ref_pc = (self.reference.construct().pandas_categorical
                          if self.reference is not None else None)
                mat, names, auto_cat, self.pandas_categorical = \
                    _data_from_pandas(self.data, self.categorical_feature,
                                      ref_pc)
                if self.categorical_feature == "auto" and auto_cat:
                    # "auto" stays when no column is a category, so the
                    # categorical_feature parameter still applies
                    self.categorical_feature = auto_cat
            else:
                mat = self.data if sparse else np.asarray(self.data)
            if isinstance(self.feature_name, (list, tuple)):
                names = list(self.feature_name)
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
            self._handle.metadata.set_label(
                np.asarray(_values(self.label)).ravel())
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

    def create_valid(self, data, label=None, weight=None, group=None,
                     init_score=None, params=None) -> "Dataset":
        """A validation Dataset binned in this one's bin space."""
        return Dataset(data, label=label, reference=self, weight=weight,
                       group=group, init_score=init_score,
                       params=params or self.params,
                       free_raw_data=self.free_raw_data)

    def set_weight(self, weight) -> None:
        self.weight = weight
        if self._handle is not None and weight is not None:
            self._handle.metadata.set_weights(
                np.asarray(_values(weight)).ravel())

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
            self._handle.metadata.set_label(
                np.asarray(_values(label)).ravel())

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

    def get_data(self):
        """The raw data (None once construction freed it)."""
        return self.data

    def get_feature_name(self) -> List[str]:
        return list(self.construct()._handle.feature_names)

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
            self._matrix_cache = (
                self.data.tocsr() if _is_scipy_sparse(self.data)
                else _data_from_pandas(self.data, None,
                                       self.pandas_categorical)[0]
                if _is_pandas_df(self.data)
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
                 model_str: Optional[str] = None, silent: bool = False,
                 device=None):
        self.params = dict(params) if params else {}
        self.config = Config.from_params(self.params)
        self.device = resolve_device(device or self.config.device_type)
        self.best_iteration = -1
        self.best_score: Dict = {}
        self._train_data_name = "training"
        self.train_set = None
        self.valid_sets: List[Dataset] = []
        self.pandas_categorical = None
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
            self.pandas_categorical = train_set.pandas_categorical
        elif model_file is not None or model_str is not None:
            from .io.model_io import load_model_file, load_model_string
            self._gbdt = (load_model_file(model_file, self.device)
                          if model_file is not None
                          else load_model_string(model_str, self.device))
            self.pandas_categorical = self._gbdt.pandas_categorical
        else:
            raise TypeError("Need at least one training dataset or model "
                            "file or model string to create Booster instance")

    def add_valid(self, data: Dataset, name: str) -> "Booster":
        """Attach a valid set; trees grown so far are replayed onto it.  A
        booster that let go of its training Dataset (``free_dataset``)
        takes a valid set binned with ``reference=`` that Dataset."""
        if not isinstance(data, Dataset):
            raise TypeError("Validation data should be Dataset instance, "
                            f"met {type(data).__name__}")
        train_ds = getattr(self._gbdt, "train_ds", None)
        if train_ds is None:
            raise LightGBMError("Cannot add validation data to a booster "
                                "without training data")
        if data._handle is None and self.train_set is not None:
            data.reference = self.train_set
        data.construct()
        if not _same_bin_mappers(data._handle, train_ds):
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

    def rollback_one_iter(self) -> "Booster":
        """Drop the last iteration's trees and their scores (reference:
        GBDT::RollbackOneIter, gbdt.cpp:451-467)."""
        self._gbdt.rollback_one_iter()
        return self

    def refit(self, data, label, decay_rate: float = 0.9,
              **kwargs) -> "Booster":
        """This model's tree structures refit to new data: each leaf
        becomes ``decay_rate * old + (1 - decay_rate) * new`` (reference:
        basic.py:2547 Booster.refit -> GBDT::RefitTree gbdt.cpp:298-321;
        reference package: basic.py ``refit``).  ``kwargs`` are parameters
        of the refit booster (``tpu_refit_device=false`` takes the host
        oracle); a booster loaded from a file takes its objective and
        ``num_class`` from the model.  The new rows are binned as a new
        Dataset, and the refit runs on this booster's device."""
        if self._gbdt is None or self._gbdt.num_trees == 0:
            raise LightGBMError("Cannot refit an empty model")
        if getattr(self._gbdt, "objective", None) is None:
            raise LightGBMError("Cannot refit due to null objective "
                                "function.")
        params = dict(self.params or {})
        params["refit_decay_rate"] = decay_rate
        params.update(kwargs)
        from .io.model_io import LoadedGBDT
        if "objective" not in params and isinstance(self._gbdt, LoadedGBDT):
            from .online.binspace import model_params
            params.update(model_params(self._gbdt))
        new_set = Dataset(data, label=label, params=params)
        nb = Booster(params=params, train_set=new_set, device=self.device)
        nb._gbdt.load_initial_models(
            [copy.deepcopy(t) for t in self._gbdt.models],
            replay_scores=False)       # the refit rebuilds the scores
        nb._gbdt.refit_models(decay_rate)
        return nb

    def eval(self, data=None, name=None, feval=None) -> List:
        """The metrics of the training set or of an attached valid set
        (all of them without ``data``)."""
        if data is None:
            return self._eval_all(feval)
        if data is self.train_set:
            return self.eval_train(feval)
        for i, vds in enumerate(self.valid_sets):
            if data is vds:
                want = self._gbdt.valid_names[i]
                return [e for e in self._eval_all(feval) if e[0] == want]
        raise LightGBMError("Can only evaluate the training set or a "
                            "dataset previously attached with add_valid")

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
        if include_train and self.train_set is not None:
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
        (``raw_score``), leaf indices (``pred_leaf``) or SHAP
        contributions (``pred_contrib``: [n, F+1], the last column the
        expected value; [n, K*(F+1)] for K classes).
        ``kwargs`` are parameters for this call only, such as
        ``pred_early_stop``,
        ``pred_early_stop_freq`` and ``pred_early_stop_margin``.  Without
        ``num_iteration`` the best iteration of early stopping is used,
        else every tree."""
        if num_iteration is None:
            num_iteration = (self.best_iteration if self.best_iteration > 0
                             else -1)
        config = self.config
        if kwargs:
            config = copy.copy(config)
            config.update(kwargs)
        if _is_pandas_df(data):
            data = _data_from_pandas(data, None, self.pandas_categorical)[0]
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
        if pred_contrib:
            if sparse:
                mat = _padded_dense(mat, n_feat)
            return self._gbdt.predict_contrib(mat, num_iteration,
                                              start_iteration)
        return self._gbdt.predict(mat, num_iteration, raw_score,
                                  start_iteration, config=config)

    def model_to_string(self, num_iteration: Optional[int] = None,
                        start_iteration: int = 0) -> str:
        from .io.model_io import model_to_string, pandas_categorical_trailer
        if num_iteration is None:
            num_iteration = (self.best_iteration if self.best_iteration > 0
                             else -1)
        return (model_to_string(self._gbdt, num_iteration, start_iteration)
                + pandas_categorical_trailer(self.pandas_categorical))

    def save_model(self, filename: str, num_iteration: Optional[int] = None,
                   start_iteration: int = 0) -> "Booster":
        """Write the model text, and, for a booster that holds its
        training data, the quality profile beside it
        (``<filename>.quality.json``, ``obs/drift.py``) unless
        ``tpu_quality_profile`` is off; a failed profile never fails the
        save."""
        with open(filename, "w") as fh:
            fh.write(self.model_to_string(num_iteration, start_iteration))
        cfg = self._gbdt.config
        if (self._gbdt.train_ds is not None
                and (cfg is None or cfg.tpu_quality_profile)):
            from .obs.drift import profile_path
            try:
                prof = self._gbdt.quality_profile()
                if prof is not None:
                    prof.save(profile_path(filename))
            except Exception as exc:  # noqa: BLE001
                log.warning("quality profile sidecar skipped: %s", exc)
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

    def model_to_if_else(self, num_iteration: Optional[int] = None) -> str:
        """Standalone C scoring code of the forest, the CLI's
        ``task=convert_model`` output (reference: GBDT::ModelToIfElse,
        gbdt_model_text.cpp:88-270)."""
        from .io.model_json import model_to_if_else
        return model_to_if_else(self._gbdt, num_iteration)

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

    def free_dataset(self) -> "Booster":
        """Let go of the training Dataset (the trainer keeps its binned
        data for prediction and model text)."""
        self.train_set = None
        return self

    def set_network(self, machines, local_listen_port: int = 12400,
                    listen_time_out: int = 120,
                    num_machines: int = 1) -> "Booster":
        log.refuse("Booster.set_network", _PARALLEL)

    def free_network(self) -> "Booster":
        log.refuse("Booster.free_network", _PARALLEL)

    # pickling and copying go through the model text (reference:
    # basic.py:1875-1904; reference package: basic.py:642-668): the
    # trainer's tensors, objective and locks are rebuilt, never pickled.
    # The copy predicts and has no training state.
    def __getstate__(self) -> Dict[str, Any]:
        return {"params": self.params, "device": self.device.type,
                "best_iteration": self.best_iteration,
                "best_score": self.best_score,
                "model_str": self.model_to_string(num_iteration=-1)}

    def __setstate__(self, state: Dict[str, Any]) -> None:
        """Back on the device it was pickled on: ``cuda`` without a card
        raises as ``resolve_device`` does."""
        from .io.model_io import load_model_string
        self.params = dict(state.get("params", {}))
        self.config = Config.from_params(self.params)
        self.device = resolve_device(state.get("device")
                                     or self.config.device_type)
        self.best_iteration = state.get("best_iteration", -1)
        self.best_score = state.get("best_score", {})
        self._train_data_name = "training"
        self.train_set = None
        self.valid_sets = []
        self._gbdt = load_model_string(state["model_str"], self.device)
        self.pandas_categorical = self._gbdt.pandas_categorical

    def __copy__(self) -> "Booster":
        return self.__deepcopy__(None)

    def __deepcopy__(self, memo) -> "Booster":
        new = Booster.__new__(Booster)
        new.__setstate__(self.__getstate__())
        return new

    def get_split_value_histogram(self, feature, bins=None,
                                  xgboost_style: bool = False):
        """numpy histogram of the thresholds of ``feature`` (index or name)
        over the forest's numerical splits (reference: basic.py:2583;
        reference package: basic.py:670-693); with ``xgboost_style`` a
        DataFrame of the non-empty bins' upper edges and counts."""
        if isinstance(feature, str):
            feature = self.feature_name().index(feature)
        values = [float(t.threshold[i]) for t in self._gbdt.models
                  for i in range(max(t.num_leaves - 1, 0))
                  if int(t.split_feature[i]) == feature
                  and not t.is_categorical(i)]
        values = np.asarray(values, np.float64)
        if bins is None or (isinstance(bins, int) and bins > len(values)):
            bins = max(len(values), 1)
        hist, edges = np.histogram(values, bins=bins)
        if not xgboost_style:
            return hist, edges
        import pandas as pd
        mask = hist != 0
        return pd.DataFrame({"SplitValue": edges[1:][mask],
                             "Count": hist[mask]})

    def trees_to_dataframe(self):
        """One row a node of every tree, depth first (reference:
        basic.py:2757; reference package: basic.py:695-740): nodes named
        ``<tree>-S<split>`` and ``<tree>-L<leaf>``."""
        import pandas as pd
        names = self.feature_name()
        rows = []

        def child(ti, c):
            return f"{ti}-S{c}" if c >= 0 else f"{ti}-L{~c}"

        def walk(tree, ti, node, depth, parent):
            if node >= 0:
                idx = f"{ti}-S{node}"
                f = int(tree.split_feature[node])
                rows.append(dict(
                    tree_index=ti, node_depth=depth, node_index=idx,
                    left_child=child(ti, int(tree.left_child[node])),
                    right_child=child(ti, int(tree.right_child[node])),
                    parent_index=parent,
                    split_feature=names[f] if f < len(names) else str(f),
                    split_gain=float(tree.split_gain[node]),
                    threshold=float(tree.threshold[node]),
                    decision_type="==" if tree.is_categorical(node)
                    else "<=",
                    missing_direction="left"
                    if (int(tree.decision_type[node]) & 2) else "right",
                    value=float(tree.internal_value[node]),
                    weight=float(tree.internal_weight[node]),
                    count=int(tree.internal_count[node])))
                walk(tree, ti, int(tree.left_child[node]), depth + 1, idx)
                walk(tree, ti, int(tree.right_child[node]), depth + 1, idx)
            else:
                leaf = ~node
                rows.append(dict(
                    tree_index=ti, node_depth=depth,
                    node_index=f"{ti}-L{leaf}", left_child=None,
                    right_child=None, parent_index=parent,
                    split_feature=None, split_gain=None, threshold=None,
                    decision_type=None, missing_direction=None,
                    value=float(tree.leaf_value[leaf]),
                    weight=float(tree.leaf_weight[leaf]),
                    count=int(tree.leaf_count[leaf])))

        for ti, tree in enumerate(self._gbdt.models):
            walk(tree, ti, 0 if tree.num_leaves > 1 else ~0, 1, None)
        return pd.DataFrame(rows)
