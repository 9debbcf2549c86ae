"""scikit-learn estimator wrappers (counterpart of lightgbm_tpu/sklearn.py,
with its signatures; reference: python-package/lightgbm/sklearn.py:169
LGBMModel, :733 LGBMRegressor, :760 LGBMClassifier, :902 LGBMRanker).

The wrappers follow the sklearn contract: constructor arguments are stored
verbatim (``get_params``/``set_params``/``clone`` round-trip), all work
happens in ``fit``, and fitted state lands in trailing-underscore
attributes.  The device is LightGBM's own ``device_type`` parameter,
given through ``**kwargs`` (``LGBMClassifier(device_type="cpu")``): the
card unless it asks for the CPU, as ``train`` does.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from .basic import Booster, Dataset
from .engine import train
from .utils.log import LightGBMError


class LGBMModel:
    """Base estimator (reference: sklearn.py:169-731)."""

    def __init__(self, boosting_type: str = "gbdt", num_leaves: int = 31,
                 max_depth: int = -1, learning_rate: float = 0.1,
                 n_estimators: int = 100, subsample_for_bin: int = 200000,
                 objective: Optional[str] = None,
                 class_weight=None, min_split_gain: float = 0.0,
                 min_child_weight: float = 1e-3, min_child_samples: int = 20,
                 subsample: float = 1.0, subsample_freq: int = 0,
                 colsample_bytree: float = 1.0, reg_alpha: float = 0.0,
                 reg_lambda: float = 0.0, random_state=None,
                 n_jobs: int = -1, silent: bool = True,
                 importance_type: str = "split", **kwargs):
        self.boosting_type = boosting_type
        self.num_leaves = num_leaves
        self.max_depth = max_depth
        self.learning_rate = learning_rate
        self.n_estimators = n_estimators
        self.subsample_for_bin = subsample_for_bin
        self.objective = objective
        self.class_weight = class_weight
        self.min_split_gain = min_split_gain
        self.min_child_weight = min_child_weight
        self.min_child_samples = min_child_samples
        self.subsample = subsample
        self.subsample_freq = subsample_freq
        self.colsample_bytree = colsample_bytree
        self.reg_alpha = reg_alpha
        self.reg_lambda = reg_lambda
        self.random_state = random_state
        self.n_jobs = n_jobs
        self.silent = silent
        self.importance_type = importance_type
        self._other_params: Dict[str, Any] = dict(kwargs)
        for k, v in kwargs.items():
            setattr(self, k, v)
        self._Booster: Optional[Booster] = None
        self._evals_result: Dict = {}
        self._best_score: Dict = {}
        self._best_iteration = -1
        self._n_features = -1
        self._classes = None
        self._n_classes = -1
        self._objective = objective

    # -- sklearn plumbing ----------------------------------------------
    @classmethod
    def _get_param_names(cls) -> List[str]:
        import inspect
        init = cls.__init__
        sig = inspect.signature(init)
        return sorted(p.name for p in sig.parameters.values()
                      if p.name not in ("self", "kwargs")
                      and p.kind != p.VAR_KEYWORD)

    def get_params(self, deep: bool = True) -> Dict[str, Any]:
        params = {name: getattr(self, name) for name in self._get_param_names()}
        params.update(self._other_params)
        return params

    def set_params(self, **params) -> "LGBMModel":
        for k, v in params.items():
            setattr(self, k, v)
            if k not in self._get_param_names():
                self._other_params[k] = v
        return self

    def _more_tags(self):
        return {"allow_nan": True, "X_types": ["2darray"]}

    def __sklearn_tags__(self):
        # sklearn >= 1.6 tag protocol
        try:
            from sklearn.utils import Tags, InputTags, TargetTags
            tags = Tags(estimator_type=getattr(self, "_estimator_type", None),
                        target_tags=TargetTags(required=True),
                        input_tags=InputTags(allow_nan=True))
            return tags
        except Exception:  # pragma: no cover - older sklearn
            raise AttributeError("__sklearn_tags__ unavailable")

    # -- training ------------------------------------------------------
    def _process_params(self) -> Dict[str, Any]:
        params = self.get_params()
        params.pop("silent", None)
        params.pop("importance_type", None)
        params.pop("class_weight", None)
        params.pop("n_jobs", None)
        out = {
            "boosting_type": params.pop("boosting_type"),
            "num_leaves": params.pop("num_leaves"),
            "max_depth": params.pop("max_depth"),
            "learning_rate": params.pop("learning_rate"),
            "bin_construct_sample_cnt": params.pop("subsample_for_bin"),
            "min_gain_to_split": params.pop("min_split_gain"),
            "min_sum_hessian_in_leaf": params.pop("min_child_weight"),
            "min_data_in_leaf": params.pop("min_child_samples"),
            "bagging_fraction": params.pop("subsample"),
            "bagging_freq": params.pop("subsample_freq"),
            "feature_fraction": params.pop("colsample_bytree"),
            "lambda_l1": params.pop("reg_alpha"),
            "lambda_l2": params.pop("reg_lambda"),
            "verbose": -1 if self.silent else 1,
        }
        params.pop("n_estimators", None)
        seed = params.pop("random_state", None)
        if seed is not None:
            if isinstance(seed, (int, np.integer)):
                out["seed"] = int(seed)
            elif isinstance(seed, np.random.RandomState):
                # deterministic derivation (reference: sklearn.py _process_params)
                out["seed"] = int(seed.randint(2**31))
            elif isinstance(seed, np.random.Generator):
                out["seed"] = int(seed.integers(2**31))
            else:
                raise TypeError(f"random_state must be an int, RandomState "
                                f"or Generator, met {type(seed).__name__}")
        obj = params.pop("objective", None)
        if obj is not None:
            out["objective"] = obj
        out.update(params)  # **kwargs passthrough
        return out

    def fit(self, X, y, sample_weight=None, init_score=None, group=None,
            eval_set=None, eval_names=None, eval_sample_weight=None,
            eval_init_score=None, eval_group=None, eval_metric=None,
            early_stopping_rounds=None, verbose=False,
            feature_name="auto", categorical_feature="auto",
            callbacks=None) -> "LGBMModel":
        params = self._process_params()
        if self._objective is None:
            self._objective = params.get("objective")
        feval = None
        if eval_metric is not None:
            if isinstance(eval_metric, (set, frozenset)):
                metrics = sorted(eval_metric, key=str)  # deterministic
            elif isinstance(eval_metric, (list, tuple)):
                metrics = list(eval_metric)
            else:
                metrics = [eval_metric]
            name_metrics = [m for m in metrics if not callable(m)]
            fn_metrics = [m for m in metrics if callable(m)]
            if name_metrics:
                params["metric"] = name_metrics
            if fn_metrics:
                # sklearn-style callables take (y_true, y_pred); the
                # engine feval convention is (preds, dataset) with preds
                # already objective-transformed (reference:
                # sklearn.py _EvalFunctionWrapper)
                def feval(preds, dataset):
                    y_true = np.asarray(dataset.get_label())
                    out = []
                    for f in fn_metrics:
                        r = f(y_true, preds)
                        out.extend(r if isinstance(r, list) else [r])
                    return out
        X = np.asarray(X, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64).ravel()
        self._n_features = X.shape[1]

        train_set = Dataset(X, label=y, weight=sample_weight, group=group,
                            init_score=init_score, params=params)
        valid_sets = []
        valid_names = list(eval_names) if eval_names else []
        if eval_set is not None:
            if isinstance(eval_set, tuple):
                eval_set = [eval_set]
            for i, (vx, vy) in enumerate(eval_set):
                vx = np.asarray(vx, dtype=np.float64)
                if vx.shape == X.shape and np.array_equal(vx, X):
                    valid_sets.append(train_set)
                else:
                    w = (eval_sample_weight[i]
                         if eval_sample_weight is not None else None)
                    isc = (eval_init_score[i]
                           if eval_init_score is not None else None)
                    grp = eval_group[i] if eval_group is not None else None
                    valid_sets.append(Dataset(
                        vx, label=np.asarray(vy, np.float64).ravel(),
                        weight=w, group=grp, init_score=isc,
                        reference=train_set, params=params))
                if i >= len(valid_names):
                    valid_names.append(f"valid_{i}")

        self._evals_result = {}
        self._Booster = train(
            params, train_set, num_boost_round=self.n_estimators,
            valid_sets=valid_sets or None,
            valid_names=valid_names or None,
            early_stopping_rounds=early_stopping_rounds,
            evals_result=self._evals_result,
            verbose_eval=verbose,
            feval=feval,
            feature_name=feature_name,
            categorical_feature=categorical_feature,
            callbacks=callbacks)
        self._best_iteration = self._Booster.best_iteration
        self._best_score = self._Booster.best_score
        return self

    # -- prediction ----------------------------------------------------
    def predict(self, X, raw_score: bool = False, num_iteration=None,
                pred_leaf: bool = False, pred_contrib: bool = False,
                **kwargs):
        self._check_fitted()
        X = np.asarray(X, dtype=np.float64)
        disable_shape_check = kwargs.pop("predict_disable_shape_check",
                                         False)
        if (X.ndim != 2 or X.shape[1] != self._n_features) \
                and not disable_shape_check:
            raise ValueError(
                f"Number of features of the model must match the input. "
                f"Model n_features_ is {self._n_features} and input "
                f"n_features is {X.shape[1] if X.ndim == 2 else 'unknown'}")
        return self._Booster.predict(X, raw_score=raw_score,
                                     num_iteration=num_iteration,
                                     pred_leaf=pred_leaf,
                                     pred_contrib=pred_contrib, **kwargs)

    # -- fitted attributes ---------------------------------------------
    def _check_fitted(self) -> None:
        if self._Booster is None:
            raise LightGBMError("Estimator not fitted, call fit before "
                                "exploiting the model.")

    @property
    def booster_(self) -> Booster:
        self._check_fitted()
        return self._Booster

    @property
    def evals_result_(self) -> Dict:
        self._check_fitted()
        return self._evals_result

    @property
    def best_score_(self) -> Dict:
        self._check_fitted()
        return self._best_score

    @property
    def best_iteration_(self) -> int:
        self._check_fitted()
        return self._best_iteration

    @property
    def n_features_(self) -> int:
        self._check_fitted()
        return self._n_features

    @property
    def objective_(self):
        self._check_fitted()
        return self._objective

    @property
    def feature_importances_(self) -> np.ndarray:
        self._check_fitted()
        return self._Booster.feature_importance(
            importance_type=self.importance_type)


class LGBMRegressor(LGBMModel):
    """(reference: sklearn.py:733-758)."""
    _estimator_type = "regressor"

    def fit(self, X, y, **kwargs):
        saved = self.objective  # keep the constructor param pristine for clone()
        if self.objective is None:
            self.objective = "regression"
        self._objective = self.objective
        try:
            super().fit(X, y, **kwargs)
        finally:
            self.objective = saved
        return self

    def score(self, X, y, sample_weight=None):
        from sklearn.metrics import r2_score
        return r2_score(y, self.predict(X), sample_weight=sample_weight)


class LGBMClassifier(LGBMModel):
    """(reference: sklearn.py:760-900)."""
    _estimator_type = "classifier"

    def fit(self, X, y, sample_weight=None, **kwargs):
        y = np.asarray(y).ravel()
        self._classes, y_enc = np.unique(y, return_inverse=True)
        self._n_classes = len(self._classes)
        saved_objective = self.objective
        params_extra = {}
        if self._n_classes > 2:
            if self.objective is None:
                self.objective = "multiclass"
            params_extra["num_class"] = self._n_classes
        elif self.objective is None:
            self.objective = "binary"
        if self.class_weight is not None:
            w = self._class_weights(y_enc)
            sample_weight = (w if sample_weight is None
                             else np.asarray(sample_weight) * w)
        # re-encode eval sets' labels too
        es = kwargs.get("eval_set")
        if es is not None:
            if isinstance(es, tuple):
                es = [es]
            enc = {c: i for i, c in enumerate(self._classes)}
            kwargs["eval_set"] = [
                (vx, np.asarray([enc[v] for v in np.asarray(vy).ravel()]))
                for vx, vy in es]
        self._other_params.update(params_extra)
        try:
            super().fit(X, y_enc.astype(np.float64),
                        sample_weight=sample_weight, **kwargs)
        finally:
            self.objective = saved_objective
            for k in params_extra:
                self._other_params.pop(k, None)
        return self

    def _class_weights(self, y_enc: np.ndarray) -> np.ndarray:
        if self.class_weight == "balanced":
            counts = np.bincount(y_enc, minlength=self._n_classes)
            cw = len(y_enc) / (self._n_classes * np.maximum(counts, 1))
        else:
            cw = np.array([self.class_weight.get(self._classes[i], 1.0)
                           for i in range(self._n_classes)])
        return cw[y_enc]

    def predict(self, X, raw_score: bool = False, num_iteration=None,
                pred_leaf: bool = False, pred_contrib: bool = False,
                **kwargs):
        if raw_score or pred_leaf or pred_contrib:
            return super().predict(X, raw_score=raw_score,
                                   num_iteration=num_iteration,
                                   pred_leaf=pred_leaf,
                                   pred_contrib=pred_contrib, **kwargs)
        proba = self.predict_proba(X, num_iteration=num_iteration, **kwargs)
        return self._classes[np.argmax(proba, axis=1)]

    def predict_proba(self, X, num_iteration=None, **kwargs) -> np.ndarray:
        p = super().predict(X, num_iteration=num_iteration, **kwargs)
        if p.ndim == 1:
            return np.column_stack([1.0 - p, p])
        return p

    def score(self, X, y, sample_weight=None):
        from sklearn.metrics import accuracy_score
        return accuracy_score(y, self.predict(X), sample_weight=sample_weight)

    @property
    def classes_(self) -> np.ndarray:
        self._check_fitted()
        return self._classes

    @property
    def n_classes_(self) -> int:
        self._check_fitted()
        return self._n_classes


class LGBMRanker(LGBMModel):
    """(reference: sklearn.py:902-976)."""

    def fit(self, X, y, group=None, eval_group=None, eval_at=(1, 2, 3, 4, 5),
            **kwargs):
        if group is None:
            raise ValueError("Should set group for ranking task")
        es = kwargs.get("eval_set")
        if es is not None and eval_group is None:
            raise ValueError("Eval_group cannot be None when eval_set is "
                             "not None")
        saved = self.objective
        if self.objective is None:
            self.objective = "lambdarank"
        had_eval_at = "eval_at" in self._other_params
        self._other_params.setdefault("eval_at", list(eval_at))
        try:
            super().fit(X, y, group=group, eval_group=eval_group, **kwargs)
        finally:
            self.objective = saved
            if not had_eval_at:  # keep a constructor-supplied eval_at for
                self._other_params.pop("eval_at", None)  # clone()/refits
        return self
