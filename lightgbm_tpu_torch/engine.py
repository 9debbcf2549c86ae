"""Training entry point (counterpart of lightgbm_tpu/engine.py ``train``;
reference: python-package/lightgbm/engine.py:18)."""
from __future__ import annotations

import collections
from typing import Any, Dict, List, Optional

from . import callback
from .basic import Booster, Dataset
from .utils import log

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
    ``best_iteration``."""
    for arg, what in ((fobj, "custom objectives"), (feval, "custom metrics"),
                      (init_model, "init_model"),
                      (learning_rates, "learning-rate schedules")):
        if arg is not None:
            log.refuse(what, "the rest of queue 1")
    params = dict(params or {})
    for alias in _ROUND_ALIASES:
        if alias in params:
            num_boost_round = int(params.pop(alias))
            log.warning(f"Found `{alias}` in params. Will use it instead of argument")
    if not isinstance(train_set, Dataset):
        raise TypeError(f"Training only accepts Dataset object, "
                        f"met {type(train_set).__name__}")
    booster = Booster(params=params, train_set=train_set, device=device)
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
        if booster.update():
            break  # no leaf can split any more
        evaluation_result_list = []
        # evaluate only what something reads: attached valid sets, or the
        # training data asked for through valid_sets (a metric pass costs
        # a device-to-host copy of the scores)
        if is_valid_contain_train:
            evaluation_result_list += booster.eval_train()
        if booster.valid_sets:
            evaluation_result_list += booster.eval_valid()
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
