"""Training and cross-validation entry points (counterpart of
lightgbm_tpu/engine.py ``train`` and ``cv``; reference:
python-package/lightgbm/engine.py:18, :373)."""
from __future__ import annotations

import collections
import os
from typing import Any, Dict, List, Optional

import numpy as np

from . import callback
from .basic import Booster, Dataset
from .utils import log
from .utils.log import LightGBMError

_ROUND_ALIASES = ("num_boost_round", "num_iterations", "num_iteration",
                  "n_iter", "num_tree", "num_trees", "num_round",
                  "num_rounds", "n_estimators")


def train(params: Dict[str, Any], train_set: Dataset,
          num_boost_round: int = 100,
          valid_sets: Optional[List[Dataset]] = None,
          valid_names: Optional[List[str]] = None,
          evals_result: Optional[Dict] = None,
          verbose_eval=True, device=None, fobj=None, feval=None,
          init_model=None, early_stopping_rounds: Optional[int] = None,
          learning_rates=None, callbacks: Optional[List] = None) -> Booster:
    """Train a booster on ``device`` ("cuda" unless the caller or the
    ``device_type`` parameter asks for "cpu").  ``valid_sets`` may hold
    ``train_set`` itself to evaluate the training data; ``evals_result``
    collects every metric per iteration; ``early_stopping_rounds`` stops
    when no validation metric improved for that many rounds and sets
    ``best_iteration``.  ``fobj(raw_scores, train_set) -> (grad, hess)``
    replaces the objective, ``feval(preds, dataset)`` adds metrics,
    ``init_model`` (a Booster or a model file) continues its forest, and
    ``learning_rates`` (a list, one a round, or a function of the round)
    schedules the shrinkage."""
    params = dict(params or {})
    for alias in _ROUND_ALIASES:
        if alias in params:
            num_boost_round = int(params.pop(alias))
            log.warning(f"Found `{alias}` in params. Will use it instead of argument")
    if fobj is not None:
        params["objective"] = "none"
    if not isinstance(train_set, Dataset):
        raise TypeError(f"Training only accepts Dataset object, "
                        f"met {type(train_set).__name__}")
    init_trees = _init_trees(init_model)
    booster = Booster(params=params, train_set=train_set, device=device)
    if init_trees:
        booster._gbdt.load_initial_models(init_trees)
    is_valid_contain_train = False
    train_data_name = "training"
    if isinstance(valid_sets, Dataset):
        valid_sets = [valid_sets]
    for i, vs in enumerate(valid_sets or []):
        name = (valid_names[i] if valid_names and i < len(valid_names)
                else f"valid_{i}")
        if vs is train_set:
            is_valid_contain_train = True
            train_data_name = name
        else:
            booster.add_valid(vs, name)
    booster._train_data_name = train_data_name

    cbs = set(callbacks or [])
    if early_stopping_rounds is not None and early_stopping_rounds > 0:
        cbs.add(callback.early_stopping(early_stopping_rounds,
                                        verbose=bool(verbose_eval)))
    if verbose_eval is True:
        cbs.add(callback.print_evaluation())
    elif isinstance(verbose_eval, int) and verbose_eval > 0:
        cbs.add(callback.print_evaluation(verbose_eval))
    if learning_rates is not None:
        cbs.add(callback.reset_parameter(learning_rate=learning_rates))
    if evals_result is not None:
        cbs.add(callback.record_evaluation(evals_result))
    cbs_before = sorted((c for c in cbs
                         if getattr(c, "before_iteration", False)),
                        key=lambda c: getattr(c, "order", 0))
    cbs_after = sorted((c for c in cbs
                        if not getattr(c, "before_iteration", False)),
                       key=lambda c: getattr(c, "order", 0))

    evaluation_result_list: List = []
    for i in range(num_boost_round):
        for cb in cbs_before:
            cb(callback.CallbackEnv(model=booster, params=params, iteration=i,
                                    begin_iteration=0,
                                    end_iteration=num_boost_round,
                                    evaluation_result_list=None))
        if booster.update(fobj=fobj):
            break  # no leaf can split any more
        evaluation_result_list = []
        # evaluate only what something reads: attached valid sets, or the
        # training data asked for through valid_sets (a metric pass costs
        # a device-to-host copy of the scores)
        if is_valid_contain_train:
            evaluation_result_list += booster.eval_train(feval)
        if booster.valid_sets:
            evaluation_result_list += booster.eval_valid(feval)
        try:
            for cb in cbs_after:
                cb(callback.CallbackEnv(
                    model=booster, params=params, iteration=i,
                    begin_iteration=0, end_iteration=num_boost_round,
                    evaluation_result_list=evaluation_result_list))
        except callback.EarlyStopException as es:
            booster.best_iteration = es.best_iteration + 1
            evaluation_result_list = es.best_score
            break
    booster.best_score = collections.defaultdict(collections.OrderedDict)
    for ds_name, mname, value, _ in evaluation_result_list or []:
        booster.best_score[ds_name][mname] = value
    return booster


def _init_trees(init_model):
    """The forest ``init_model`` continues: a Booster's trees, or a model
    file's (reference: boosting.cpp:35-69; reference package: engine.py
    :39-68)."""
    if init_model is None:
        return None
    if isinstance(init_model, Booster):
        return list(init_model._gbdt.models)
    if isinstance(init_model, (str, bytes)) or hasattr(init_model,
                                                       "__fspath__"):
        from .io.model_io import load_model_file
        return list(load_model_file(os.fsdecode(init_model), "cpu").models)
    raise TypeError("init_model should be a Booster or a model file path, "
                    f"met {type(init_model).__name__}")


class CVBooster:
    """The boosters of the folds (reference: engine.py:253-278
    ``_CVBooster``); a method call runs on every booster and returns the
    list of results."""

    def __init__(self):
        self.boosters: List[Booster] = []
        self.best_iteration = -1

    def append(self, booster: Booster) -> None:
        self.boosters.append(booster)

    def __getattr__(self, name):
        def handler_function(*args, **kwargs):
            return [getattr(b, name)(*args, **kwargs) for b in self.boosters]
        return handler_function


def _make_n_folds(full_data: Dataset, folds, nfold: int, stratified: bool,
                  shuffle: bool, seed: int):
    """(train rows, test rows) of each fold (reference: engine.py:281-341):
    the caller's folds, or ``nfold`` folds drawn from
    ``np.random.default_rng(seed)`` as the JAX package draws them,
    stratified by label when asked."""
    full_data.free_raw_data = False
    full_data.construct()
    num_data = full_data.num_data()
    if folds is not None:
        if not hasattr(folds, "__iter__") and not hasattr(folds, "split"):
            raise AttributeError("folds should be a generator or iterator "
                                 "of (train_idx, test_idx) tuples or an "
                                 "object with a split method")
        if hasattr(folds, "split"):
            group_info = full_data.get_group()
            group = (np.repeat(np.arange(len(group_info)), group_info)
                     if group_info is not None else None)
            folds = folds.split(X=np.empty(num_data),
                                y=full_data.get_label(), groups=group)
        return list(folds)
    rng = np.random.default_rng(seed)
    if stratified:
        label = np.asarray(full_data.get_label())
        idx_per_fold = [[] for _ in range(nfold)]
        for c in np.unique(label):
            cidx = np.flatnonzero(label == c)
            if shuffle:
                cidx = rng.permutation(cidx)
            for i, chunk in enumerate(np.array_split(cidx, nfold)):
                idx_per_fold[i].extend(chunk.tolist())
        test_sets = [np.asarray(sorted(f)) for f in idx_per_fold]
    else:
        idx = rng.permutation(num_data) if shuffle else np.arange(num_data)
        test_sets = [np.sort(chunk) for chunk in np.array_split(idx, nfold)]
    out = []
    for test_idx in test_sets:
        mask = np.ones(num_data, dtype=bool)
        mask[test_idx] = False
        out.append((np.flatnonzero(mask), test_idx))
    return out


def _agg_cv_result(raw_results):
    """Mean and standard deviation of each metric over the folds
    (reference: engine.py:344-370), as ("cv_agg", "<data> <metric>", mean,
    higher_is_better, stdv)."""
    cvmap = collections.OrderedDict()
    metric_type = {}
    for one_result in raw_results:
        for ds_name, mname, value, hib in one_result:
            key = f"{ds_name} {mname}"
            metric_type[key] = hib
            cvmap.setdefault(key, []).append(value)
    return [("cv_agg", k, float(np.mean(v)), metric_type[k],
             float(np.std(v))) for k, v in cvmap.items()]


def cv(params: Dict[str, Any], train_set: Dataset, num_boost_round: int = 100,
       folds=None, nfold: int = 5, stratified: bool = True,
       shuffle: bool = True, metrics=None, fobj=None, feval=None,
       init_model=None, early_stopping_rounds: Optional[int] = None,
       fpreproc=None, verbose_eval=None, show_stdv: bool = True,
       seed: int = 0, callbacks: Optional[List] = None,
       eval_train_metric: bool = False, return_cvbooster: bool = False,
       device=None):
    """Cross-validation (reference: engine.py:373-580): one booster a fold,
    each trained on the other folds' rows in the full set's bin space and
    evaluated on its own; returns ``{"<data> <metric>-mean": [...],
    "-stdv": [...]}`` per round (and the ``cvbooster``)."""
    if not isinstance(train_set, Dataset):
        raise TypeError(f"Training only accepts Dataset object, "
                        f"met {type(train_set).__name__}")
    params = dict(params or {})
    for alias in _ROUND_ALIASES:
        if alias in params:
            num_boost_round = int(params.pop(alias))
    if fobj is not None:
        params["objective"] = "none"
    if metrics is not None:
        params["metric"] = metrics
    if train_set.data is None:
        raise LightGBMError("cv needs raw data; construct Dataset with "
                            "free_raw_data=False")
    init_trees = _init_trees(init_model)
    results = collections.defaultdict(list)
    boosters = CVBooster()
    for train_idx, test_idx in _make_n_folds(train_set, folds, nfold,
                                             stratified, shuffle, seed):
        tr = train_set.subset(train_idx)
        va = train_set.subset(test_idx)
        if fpreproc is not None:
            tr, va, params = fpreproc(tr, va, params.copy())
        else:
            va.reference = tr
        bst = Booster(params=params, train_set=tr, device=device)
        if init_trees:
            bst._gbdt.load_initial_models(init_trees)
        bst.add_valid(va, "valid")
        if eval_train_metric:
            bst._train_data_name = "train"
        boosters.append(bst)

    cbs = set(callbacks or [])
    if early_stopping_rounds is not None and early_stopping_rounds > 0:
        cbs.add(callback.early_stopping(early_stopping_rounds, verbose=False))
    if verbose_eval is True:
        cbs.add(callback.print_evaluation(show_stdv=show_stdv))
    elif isinstance(verbose_eval, int) and verbose_eval:
        cbs.add(callback.print_evaluation(verbose_eval, show_stdv))
    cbs_before = sorted((c for c in cbs
                         if getattr(c, "before_iteration", False)),
                        key=lambda c: getattr(c, "order", 0))
    cbs_after = sorted((c for c in cbs
                        if not getattr(c, "before_iteration", False)),
                       key=lambda c: getattr(c, "order", 0))
    for i in range(num_boost_round):
        for cb in cbs_before:
            cb(callback.CallbackEnv(model=boosters, params=params,
                                    iteration=i, begin_iteration=0,
                                    end_iteration=num_boost_round,
                                    evaluation_result_list=None))
        fold_results = []
        for bst in boosters.boosters:
            bst.update(fobj=fobj)
            entries = bst.eval_valid(feval)
            if eval_train_metric:
                entries = bst.eval_train(feval) + entries
            fold_results.append(entries)
        res = _agg_cv_result(fold_results)
        for _, key, mean, _, std in res:
            results[key + "-mean"].append(mean)
            results[key + "-stdv"].append(std)
        try:
            for cb in cbs_after:
                cb(callback.CallbackEnv(model=boosters, params=params,
                                        iteration=i, begin_iteration=0,
                                        end_iteration=num_boost_round,
                                        evaluation_result_list=res))
        except callback.EarlyStopException as es:
            boosters.best_iteration = es.best_iteration + 1
            for bst in boosters.boosters:
                bst.best_iteration = boosters.best_iteration
            for k in results:
                results[k] = results[k][:boosters.best_iteration]
            break
    out = dict(results)
    if return_cvbooster:
        out["cvbooster"] = boosters
    return out
