"""Command line: ``python -m lightgbm_tpu_torch task=train config=train.conf``
(counterpart of lightgbm_tpu/app.py: ``run_train``, ``run_predict``,
``main``).

The analog of the reference CLI (reference: src/main.cpp,
src/application/application.cpp:48-81 task dispatch, :198-218 Train with
snapshots, :221-247 Predict).  Arguments are ``key=value`` pairs; a
``config=FILE`` pair loads a LightGBM .conf file, and pairs on the command
line win over the file's (reference: config.cpp Config::Set ordering).
Training and prediction run on the card unless ``device_type=cpu``.
"""
from __future__ import annotations

import sys
from typing import Dict, List

import numpy as np

from . import callback
from .basic import Booster, Dataset
from .config import Config, read_config_file
from .engine import train as train_api
from .io.text_loader import load_text
from .utils import log

# tasks of the reference CLI the port does not run yet -> ROADMAP.md item
_UNPORTED_TASKS = {
    "serve": "forest predict and serving: serve/",
    "online": "the rest of queue 1: online and serve",
    "refit": "the rest of queue 1: online and serve",
    "convert_model": "model_to_if_else and convert_model",
}


def _parse_args(argv: List[str]) -> Dict[str, str]:
    params: Dict[str, str] = {}
    conf_file = None
    for arg in argv:
        k, eq, v = arg.partition("=")
        if not eq:
            log.fatal(f"Unknown argument {arg!r}; expected key=value")
        k = k.strip()
        if k in ("config", "config_file", "conf"):
            conf_file = v.strip()
        else:
            params[k] = v.strip()
    if conf_file:
        for k, v in read_config_file(conf_file).items():
            params.setdefault(k, v)  # command-line pairs win
    return params


def _dataset_from_file(path: str, cfg: Config, params: Dict,
                       reference=None) -> Dataset:
    X, label, weight, group, names = load_text(path, cfg)
    return Dataset(X, label=label, weight=weight, group=group,
                   feature_name=names, params=dict(params),
                   reference=reference)


def run_train(cfg: Config, params: Dict) -> None:
    if cfg.input_model:
        log.refuse("continued training from input_model",
                   "the rest of queue 1")
    if cfg.initscore_filename:
        log.refuse("init scores", "the rest of queue 1")
    train_set = _dataset_from_file(cfg.data, cfg, params)
    valid_sets = [_dataset_from_file(v, cfg, params, reference=train_set)
                  for v in cfg.valid]
    valid_names = ([f"valid_{i + 1}" for i in range(len(valid_sets))]
                   if len(valid_sets) > 1 else ["valid"] * len(valid_sets))
    cbs = []
    if cfg.metric_freq > 0 and (valid_sets or cfg.is_provide_training_metric):
        cbs.append(callback.print_evaluation(period=cfg.metric_freq))
    if cfg.snapshot_freq > 0:
        # reference: gbdt.cpp:290-294, <output_model>.snapshot_iter_N
        def snapshot_cb(env):
            it = env.iteration + 1
            if it % cfg.snapshot_freq == 0:
                out = f"{cfg.output_model}.snapshot_iter_{it}"
                env.model.save_model(out)
                log.info("Saved snapshot to %s", out)
        snapshot_cb.order = 100
        cbs.append(snapshot_cb)
    if cfg.is_provide_training_metric:
        valid_sets = [train_set] + valid_sets
        valid_names = ["training"] + valid_names
    bst = train_api(params, train_set, num_boost_round=int(cfg.num_iterations),
                    valid_sets=valid_sets or None,
                    valid_names=valid_names or None,
                    early_stopping_rounds=(cfg.early_stopping_round
                                           if cfg.early_stopping_round > 0
                                           else None),
                    verbose_eval=False, callbacks=cbs)
    bst.save_model(cfg.output_model)
    log.info("Finished training; model saved to %s", cfg.output_model)


def run_predict(cfg: Config, params: Dict) -> None:
    """Predict a data file from ``input_model`` alone: the model file
    carries the objective.  ``Booster.predict`` routes the work: rows x
    trees of 2,000,000 or more walk the stacked forest on the device, as
    the JAX package's CLI sends such work to its serving session."""
    if not cfg.input_model:
        log.fatal("task=predict needs input_model (alias: model_file)")
    if cfg.predict_contrib:
        log.refuse("predict_contrib", "the rest of queue 1: explain")
    bst = Booster(model_file=cfg.input_model, device=cfg.device_type)
    # prediction-time knobs come from the CLI's config, not the model's
    bst.reset_parameter({"pred_early_stop": cfg.pred_early_stop,
                         "pred_early_stop_freq": cfg.pred_early_stop_freq,
                         "pred_early_stop_margin": cfg.pred_early_stop_margin})
    X = load_text(cfg.data, cfg)[0]
    num_it = cfg.num_iteration_predict if cfg.num_iteration_predict > 0 \
        else None
    pred = np.atleast_1d(bst.predict(
        X, num_iteration=num_it, raw_score=bool(cfg.predict_raw_score),
        pred_leaf=bool(cfg.predict_leaf_index)))
    fmt = "%d" if pred.dtype.kind in "iu" else "%.18g"
    np.savetxt(cfg.output_result, pred, fmt=fmt, delimiter="\t")
    log.info("Finished prediction; results saved to %s", cfg.output_result)


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    params = _parse_args(argv)
    cfg = Config.from_params(params)
    task = cfg.task
    if task == "train":
        run_train(cfg, params)
    elif task in ("predict", "prediction", "test"):
        run_predict(cfg, params)
    elif task in _UNPORTED_TASKS:
        log.refuse(f"task={task}", _UNPORTED_TASKS[task])
    else:
        log.fatal(f"Unknown task {task!r} (supported: train, predict)")
