"""Training callbacks (counterpart of lightgbm_tpu/callback.py:
``CallbackEnv``, ``EarlyStopException``, ``print_evaluation``,
``record_evaluation``, ``reset_parameter``, ``early_stopping``).

The public contract is the reference's callback bus (reference:
python-package/lightgbm/callback.py — ``CallbackEnv`` fields, the factory
functions, ``order`` / ``before_iteration`` attributes), as callable
classes holding explicit state.

An evaluation entry is the tuple ``(dataset_name, metric_name, value,
higher_is_better)`` — cv would add a fifth stdv element.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple


class EarlyStopException(Exception):
    """Signals the training loop to stop at ``best_iteration``."""

    def __init__(self, best_iteration: int, best_score):
        super().__init__()
        self.best_iteration = best_iteration
        self.best_score = best_score


@dataclass
class CallbackEnv:
    """Snapshot passed to every callback once per iteration."""
    model: Any
    params: Dict[str, Any]
    iteration: int
    begin_iteration: int
    end_iteration: int
    evaluation_result_list: List[Tuple]


def _entry_to_str(entry: Tuple, show_stdv: bool = True) -> str:
    name, metric, value = entry[0], entry[1], entry[2]
    if len(entry) == 5 and show_stdv:
        return f"{name}'s {metric}: {value:g} + {entry[4]:g}"
    if len(entry) not in (4, 5):
        raise ValueError(f"Wrong metric value: {entry!r}")
    return f"{name}'s {metric}: {value:g}"


def _results_to_str(entries: List[Tuple], show_stdv: bool = True) -> str:
    return "\t".join(_entry_to_str(e, show_stdv) for e in entries)


class _LogEvaluation:
    """Logs the evaluation line every ``period`` iterations."""

    order = 10
    before_iteration = False

    def __init__(self, period: int, show_stdv: bool):
        self.period = period
        self.show_stdv = show_stdv

    def __call__(self, env: CallbackEnv) -> None:
        from .utils import log
        it = env.iteration + 1
        if self.period > 0 and env.evaluation_result_list and it % self.period == 0:
            log.info("[%d]\t%s", it,
                     _results_to_str(env.evaluation_result_list, self.show_stdv))


def print_evaluation(period: int = 1, show_stdv: bool = True) -> Callable:
    """Create a callback that logs evaluation results every ``period`` iters."""
    return _LogEvaluation(period, show_stdv)


class _RecordEvaluation:
    """Appends each metric value into a nested ``{data: {metric: [...]}}`` dict."""

    order = 20
    before_iteration = False

    def __init__(self, store: Dict):
        if not isinstance(store, dict):
            raise TypeError("eval_result should be a dictionary")
        store.clear()
        self.store = store

    def __call__(self, env: CallbackEnv) -> None:
        for entry in env.evaluation_result_list:
            data_name, metric_name, value = entry[0], entry[1], entry[2]
            self.store.setdefault(data_name, {}).setdefault(metric_name, []).append(value)
            if len(entry) == 5:
                self.store[data_name].setdefault(f"{metric_name}-stdv", []).append(entry[4])


def record_evaluation(eval_result: Dict) -> Callable:
    """Create a callback recording evaluation history into ``eval_result``."""
    return _RecordEvaluation(eval_result)


class _ResetParameter:
    """Applies per-iteration parameter schedules (lists or callables)
    before each iteration (reference package: callback.py:103-140)."""

    order = 10
    before_iteration = True

    def __init__(self, schedules: Dict[str, Any]):
        self.schedules = schedules

    def _value_at(self, key: str, value, step: int, total: int):
        if isinstance(value, list):
            if len(value) != total:
                raise ValueError(f"Length of list {key!r} has to equal to "
                                 "'num_boost_round'.")
            return value[step]
        if callable(value):
            return value(step)
        raise ValueError(f"Schedule for {key!r} must be a list or a "
                         "callable")

    def __call__(self, env: CallbackEnv) -> None:
        step = env.iteration - env.begin_iteration
        total = env.end_iteration - env.begin_iteration
        changed = {}
        for key, sched in self.schedules.items():
            new = self._value_at(key, sched, step, total)
            if env.params.get(key) != new:
                changed[key] = new
        if changed:
            if env.model is not None:
                env.model.reset_parameter(changed)
            env.params.update(changed)


def reset_parameter(**kwargs) -> Callable:
    """A callback that resets parameters on a schedule each iteration: a
    list of one value per round, or a function of the round."""
    return _ResetParameter(kwargs)


@dataclass
class _MetricState:
    """Best-so-far tracking for one (dataset, metric) pair."""
    higher_is_better: bool
    best_score: float = None  # type: ignore[assignment]
    best_iter: int = 0
    best_results: Optional[List[Tuple]] = field(default=None)

    def update(self, score: float, iteration: int, results: List[Tuple]) -> bool:
        better = (self.best_results is None
                  or (score > self.best_score if self.higher_is_better
                      else score < self.best_score))
        if better:
            self.best_score = score
            self.best_iter = iteration
            self.best_results = results
        return better


class _EarlyStopping:
    """Stops training when no validation metric improves for N rounds.

    Train-set entries never trigger a stop (they almost always improve);
    they only take part in the final-iteration report, as in the reference
    (DART, where the reference disables early stopping, is refused by
    ``Config``).
    """

    order = 30
    before_iteration = False

    def __init__(self, stopping_rounds: int, first_metric_only: bool, verbose: bool):
        self.stopping_rounds = stopping_rounds
        self.first_metric_only = first_metric_only
        self.verbose = verbose
        self.states: Optional[List[_MetricState]] = None
        self.first_metric = ""

    # -- helpers -------------------------------------------------------
    def _setup(self, env: CallbackEnv) -> None:
        from .utils import log
        if not env.evaluation_result_list:
            raise ValueError("For early stopping, at least one dataset and eval "
                             "metric is required for evaluation")
        if self.verbose:
            log.info("Training until validation scores don't improve for %d rounds",
                     self.stopping_rounds)
        self.first_metric = self._metric_key(env.evaluation_result_list[0])
        self.states = [_MetricState(higher_is_better=bool(e[3]))
                       for e in env.evaluation_result_list]

    @staticmethod
    def _metric_key(entry: Tuple) -> str:
        return entry[1].split(" ")[-1]

    def _is_train_entry(self, env: CallbackEnv, entry: Tuple) -> bool:
        train_name = getattr(env.model, "_train_data_name", "training")
        return entry[0] == train_name

    def _report_and_stop(self, state: _MetricState, reason: str) -> None:
        from .utils import log
        if self.verbose:
            log.info("%s, best iteration is:\n[%d]\t%s", reason,
                     state.best_iter + 1, _results_to_str(state.best_results))
            if self.first_metric_only:
                log.info("Evaluated only: %s", self.first_metric)
        raise EarlyStopException(state.best_iter, state.best_results)

    # -- main ----------------------------------------------------------
    def __call__(self, env: CallbackEnv) -> None:
        if self.states is None:
            self._setup(env)
        last_iter = env.iteration == env.end_iteration - 1
        for state, entry in zip(self.states, env.evaluation_result_list):
            state.update(float(entry[2]), env.iteration, env.evaluation_result_list)
            if self.first_metric_only and self.first_metric != self._metric_key(entry):
                continue
            if self._is_train_entry(env, entry):
                if last_iter:
                    self._report_and_stop(state, "Did not meet early stopping")
                continue
            if env.iteration - state.best_iter >= self.stopping_rounds:
                self._report_and_stop(state, "Early stopping")
            if last_iter:
                self._report_and_stop(state, "Did not meet early stopping")


def early_stopping(stopping_rounds: int, first_metric_only: bool = False,
                   verbose: bool = True) -> Callable:
    """Create a callback that stops training when no validation metric has
    improved for ``stopping_rounds`` consecutive rounds."""
    return _EarlyStopping(stopping_rounds, first_metric_only, verbose)
