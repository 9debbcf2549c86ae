"""Training and cross-validation entry points (counterpart of
lightgbm_tpu/engine.py ``train`` and ``cv``; reference:
python-package/lightgbm/engine.py:18, :373)."""
from __future__ import annotations

import collections
import os
import signal
import threading
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
          fobj=None, feval=None, init_model=None,
          feature_name="auto", categorical_feature="auto",
          early_stopping_rounds: Optional[int] = None,
          evals_result: Optional[Dict] = None,
          verbose_eval=True, learning_rates=None,
          keep_training_booster: bool = False,
          callbacks: Optional[List] = None, device=None) -> Booster:
    """Train a booster on ``device`` ("cuda" unless the caller or the
    ``device_type`` parameter asks for "cpu"); the arguments before
    ``device`` are LightGBM v2.3.2's, in its order.  ``feature_name`` and
    ``categorical_feature`` (other than "auto") replace the Dataset's, and
    without ``keep_training_booster`` the returned booster lets go of its
    training Dataset (``free_dataset``).  ``valid_sets`` may hold
    ``train_set`` itself to evaluate the training data; ``evals_result``
    collects every metric per iteration; ``early_stopping_rounds`` stops
    when no validation metric improved for that many rounds and sets
    ``best_iteration``.  ``fobj(raw_scores, train_set) -> (grad, hess)``
    replaces the objective, ``feval(preds, dataset)`` adds metrics,
    ``init_model`` (a Booster or a model file) continues its forest, and
    ``learning_rates`` (a list, one a round, or a function of the round)
    schedules the shrinkage.

    With ``tpu_checkpoint_dir`` set, a checkpoint is written every
    ``tpu_checkpoint_freq`` rounds (``robust/checkpoint.py``), and a run
    resumes from the newest valid one of the same config, which
    supersedes ``init_model``; the recorded evaluations are replayed
    through the stateful callbacks.  A fatal device error then leaves a
    checkpoint of the last iteration boundary, and SIGTERM or SIGINT
    finishes the round, checkpoints and exits (a second signal kills)."""
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
    if feature_name != "auto":
        train_set.feature_name = feature_name
    if categorical_feature != "auto":
        train_set.categorical_feature = categorical_feature
    init_trees = _init_trees(init_model)
    booster = Booster(params=params, train_set=train_set, device=device)
    from .robust.checkpoint import CheckpointManager
    ckpt_mgr = CheckpointManager.from_config(booster.config)
    ckpt_peeked = ckpt_mgr.peek(booster.config) if ckpt_mgr else None
    if init_trees:
        if ckpt_peeked is not None:
            log.warning("init_model ignored: resuming from checkpoint %s (a "
                        "checkpoint is this run's own progress and "
                        "supersedes the init model; delete the checkpoint "
                        "directory to restart from the init model)",
                        ckpt_peeked[0])
        else:
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
    eval_history: List = []
    start_round = 0
    stopped_in_replay = False
    if ckpt_peeked is not None:
        resume = ckpt_mgr.resume(booster, ckpt_peeked)
        start_round = resume.iteration
        eval_history = list(resume.eval_history)
        # a learning-rate schedule compares against env.params
        params["learning_rate"] = booster._gbdt.shrinkage_rate
        try:
            for it, entries in eval_history:
                env = callback.CallbackEnv(
                    model=booster, params=params, iteration=it,
                    begin_iteration=0, end_iteration=num_boost_round,
                    evaluation_result_list=entries)
                for cb in cbs_after:
                    if not getattr(cb, "skip_on_resume", False):
                        cb(env)
                evaluation_result_list = entries
        except callback.EarlyStopException as es:
            booster.best_iteration = es.best_iteration + 1
            evaluation_result_list = es.best_score
            stopped_in_replay = True

    preempted: Dict[str, int] = {}
    prev_handlers = _arm_signals(preempted) if ckpt_mgr else {}
    completed = start_round
    if ckpt_mgr is not None:
        # checkpoints are numbered by this loop's rounds: under init_model
        # the trainer's iteration count includes the seeded ones
        num_init = booster._gbdt.iter_ - start_round
        booster._gbdt._ckpt_hook = (
            lambda reason: ckpt_mgr.save(
                booster, booster._gbdt.iter_ - num_init, eval_history,
                reason=reason))
    try:
        if not stopped_in_replay:
            completed, evaluation_result_list = _boost(
                booster, params, fobj, feval, num_boost_round, start_round,
                cbs_before, cbs_after, is_valid_contain_train, ckpt_mgr,
                eval_history, evaluation_result_list, preempted)
    finally:
        for s, h in prev_handlers.items():
            signal.signal(s, h)
    if preempted:
        ckpt_mgr.save(booster, completed, eval_history, reason="preempted")
        sig = preempted["sig"]
        log.warning("training preempted by signal %d at iteration %d; "
                    "checkpoint written to %s: rerun with the same "
                    "tpu_checkpoint_dir to resume", sig, completed,
                    ckpt_mgr.dir)
        if sig == signal.SIGINT:
            raise KeyboardInterrupt
        raise SystemExit(128 + sig)
    booster.best_score = collections.defaultdict(collections.OrderedDict)
    for ds_name, mname, value, _ in evaluation_result_list or []:
        booster.best_score[ds_name][mname] = value
    if not keep_training_booster:
        booster.free_dataset()
    return booster


def _arm_signals(preempted: Dict[str, int]) -> dict:
    """SIGTERM and SIGINT finish the current round, then checkpoint; the
    second signal takes the previous handler.  Only in the main thread."""
    if threading.current_thread() is not threading.main_thread():
        return {}
    prev = {}

    def on_signal(signum, frame):
        preempted["sig"] = signum
        for s, h in prev.items():
            signal.signal(s, h)
        log.warning("signal %d: finishing the current iteration, then "
                    "checkpointing and exiting (send again to kill "
                    "immediately)", signum)
    for s in (signal.SIGTERM, signal.SIGINT):
        try:
            prev[s] = signal.signal(s, on_signal)
        except (ValueError, OSError):
            prev.pop(s, None)
    return prev


def _boost(booster, params, fobj, feval, num_boost_round, start_round,
           cbs_before, cbs_after, is_valid_contain_train, ckpt_mgr,
           eval_history, evaluation_result_list, preempted):
    """The boosting rounds from ``start_round``: (rounds completed, the
    last evaluation list)."""
    completed = start_round
    for i in range(start_round, num_boost_round):
        if preempted:
            break
        for cb in cbs_before:
            cb(callback.CallbackEnv(model=booster, params=params, iteration=i,
                                    begin_iteration=0,
                                    end_iteration=num_boost_round,
                                    evaluation_result_list=None))
        if booster.update(fobj=fobj):
            break  # no leaf can split any more
        completed = i + 1
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
        if ckpt_mgr is not None:
            eval_history.append((i, list(evaluation_result_list)))
            if ckpt_mgr.should_save(i + 1):
                ckpt_mgr.save(booster, i + 1, eval_history)
    return completed, evaluation_result_list


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
       init_model=None, feature_name="auto", categorical_feature="auto",
       early_stopping_rounds: Optional[int] = None,
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
    if feature_name != "auto":
        train_set.feature_name = feature_name
    if categorical_feature != "auto":
        train_set.categorical_feature = categorical_feature
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
