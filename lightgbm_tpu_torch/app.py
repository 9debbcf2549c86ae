"""Command line: ``python -m lightgbm_tpu_torch task=train config=train.conf``
(counterpart of lightgbm_tpu/app.py: ``run_train``, ``run_predict``,
``run_serve``, ``run_convert_model``, ``run_refit``, ``main``).

The analog of the reference CLI (reference: src/main.cpp,
src/application/application.cpp:48-81 task dispatch, :198-218 Train with
snapshots, :221-247 Predict).  Arguments are ``key=value`` pairs; a
``config=FILE`` pair loads a LightGBM .conf file, and pairs on the command
line win over the file's (reference: config.cpp Config::Set ordering).
Training, prediction, serving and refit run on the card unless
``device_type=cpu``.  ``task=serve`` serves ``input_model`` over HTTP
(``serve/``); ``task=online`` serves it too and feeds a label stream
back into refreshed versions (``online/loop.py``); ``task=refit`` refits
its leaves to the rows of ``data``; ``task=convert_model`` writes
``input_model`` as standalone C scoring code to ``convert_model``.
``input_model`` continues a model's forest in ``task=train``; init scores
come from ``initscore_filename`` (``valid_data_initscores`` for the valid
sets) or a ``<data>.init`` file;
``two_round=true`` bins the data while streaming the file;
``save_binary=true`` writes the training set's binned dataset to
``<data>.bin``, and a data file that is such a file loads without parsing
or binning.
"""
from __future__ import annotations

import os
import sys
from typing import Dict, List

import numpy as np

from . import callback
from .basic import Booster, Dataset, parse_categorical_spec
from .config import Config, read_config_file
from .engine import train as train_api
from .io.dataset_io import is_dataset_file
from .io.text_loader import load_init_scores, load_text, load_text_two_round
from .utils import log


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
                       reference=None, initscore_path: str = "") -> Dataset:
    """A data file as a Dataset (reference package: app.py
    ``_dataset_from_file``): a binned dataset file as it is, else the text
    loaded in memory or, with ``two_round``, binned while streaming."""
    if is_dataset_file(path):
        log.info("Loading the binned dataset %s", path)
        ds = Dataset(path, params=dict(params), reference=reference)
    elif cfg.two_round:
        ref = reference.construct()._handle if reference is not None else None
        handle, label, weight, group, names = load_text_two_round(
            path, cfg, parse_categorical_spec(cfg.categorical_feature), ref)
        ds = Dataset(None, params=dict(params), feature_name=names,
                     reference=reference)
        ds._handle = handle
        ds.set_label(label)
        ds.set_weight(weight)
        ds.set_group(group)
    else:
        X, label, weight, group, names = load_text(path, cfg)
        ds = Dataset(X, label=label, weight=weight, group=group,
                     feature_name=names, params=dict(params),
                     reference=reference)
    init_score = load_init_scores(path, initscore_path)
    if init_score is not None:
        ds.set_init_score(init_score)
    return ds


def run_train(cfg: Config, params: Dict) -> None:
    train_set = _dataset_from_file(cfg.data, cfg, params,
                                   initscore_path=cfg.initscore_filename)
    if cfg.save_binary:
        out = cfg.data + ".bin"
        train_set.save_binary(out)
        log.info("Saved the binned dataset to %s", out)
    valid_sets = [
        _dataset_from_file(v, cfg, params, reference=train_set,
                           initscore_path=(cfg.valid_data_initscores[i]
                                           if i < len(cfg.valid_data_initscores)
                                           else ""))
        for i, v in enumerate(cfg.valid)]
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
                    init_model=cfg.input_model or None,
                    early_stopping_rounds=(cfg.early_stopping_round
                                           if cfg.early_stopping_round > 0
                                           else None),
                    verbose_eval=False, callbacks=cbs)
    bst.save_model(cfg.output_model)
    log.info("Finished training; model saved to %s", cfg.output_model)


def run_predict(cfg: Config, params: Dict) -> None:
    """Predict a data file from ``input_model`` alone: the model file
    carries the objective.  As in the JAX package's CLI, value predictions
    of ``LGBM_TPU_PREDICT_MIN_WORK`` rows x trees or more (default
    ``PredictorBase._DEVICE_PREDICT_MIN_WORK``; 0 sends everything)
    go through a ``PredictorSession``, the engine ``task=serve`` runs
    behind HTTP; smaller ones, leaf indices and contributions through
    ``Booster.predict``."""
    if not cfg.input_model:
        log.fatal("task=predict needs input_model (alias: model_file)")
    bst = Booster(model_file=cfg.input_model, device=cfg.device_type)
    # prediction-time knobs come from the CLI's config, not the model's
    bst.reset_parameter({"pred_early_stop": cfg.pred_early_stop,
                         "pred_early_stop_freq": cfg.pred_early_stop_freq,
                         "pred_early_stop_margin": cfg.pred_early_stop_margin})
    X = load_text(cfg.data, cfg)[0]
    num_it = cfg.num_iteration_predict if cfg.num_iteration_predict > 0 \
        else None
    from .boosting.gbdt import PredictorBase
    K = bst.num_model_per_iteration()
    n_iters = bst.num_trees() // max(K, 1)
    window = min(num_it, n_iters) if num_it else n_iters
    try:
        min_work = int(os.environ.get("LGBM_TPU_PREDICT_MIN_WORK", "")
                       or PredictorBase._DEVICE_PREDICT_MIN_WORK)
    except ValueError:
        min_work = PredictorBase._DEVICE_PREDICT_MIN_WORK
    if cfg.predict_leaf_index or cfg.predict_contrib \
            or X.shape[0] * window * K < min_work:
        pred = bst.predict(X, num_iteration=num_it,
                           raw_score=bool(cfg.predict_raw_score),
                           pred_leaf=bool(cfg.predict_leaf_index),
                           pred_contrib=bool(cfg.predict_contrib))
    else:
        from .serve import PredictorSession
        with PredictorSession(bst, config=bst.config, num_iteration=num_it,
                              device=cfg.device_type) as sess:
            log.info("Predicting %d rows through a PredictorSession on %s",
                     X.shape[0], sess.device)
            pred = sess.predict(X, raw_score=bool(cfg.predict_raw_score))
    pred = np.atleast_1d(pred)
    fmt = "%d" if pred.dtype.kind in "iu" else "%.18g"
    np.savetxt(cfg.output_result, pred, fmt=fmt, delimiter="\t")
    log.info("Finished prediction; results saved to %s", cfg.output_result)


def run_serve(cfg: Config) -> None:
    """task=serve: ``input_model`` registered as ``default`` in a
    ``ModelRegistry`` with ``tpu_serve_replicas`` sessions behind the
    failover router, a ``ForestArena`` attached, every pow2 bucket warmed,
    then served over HTTP until interrupted (``serve/server.py``)."""
    if not cfg.input_model:
        log.fatal("task=serve needs input_model (alias: model_file)")
    from .serve import ForestArena, ModelRegistry, PredictServer
    reg = ModelRegistry(config=cfg)
    try:
        reg.add_model("default", cfg.input_model)
        # arena tenants ride the same fleet surface: POST
        # /models/{name}/swap with {"arena": true} admits one
        reg.attach_arena(ForestArena(config=cfg))
        router = reg.resolve(None).router
        n = router.warmup()
    except BaseException:
        reg.close()
        raise
    log.info("serve: %d replica(s) on %s warmed %d bucket shapes "
             "(max_batch=%d); arena attached (budget %s)",
             len(router.replicas), router.session.device, n,
             router.max_batch, reg.arena.budget_bytes or "unbounded")
    server = PredictServer(reg, host=cfg.tpu_serve_host,
                           port=cfg.tpu_serve_port)
    log.info("serve: listening on %s", server.url)
    server.serve_forever()


def run_convert_model(cfg: Config) -> None:
    """task=convert_model: a model file as standalone C scoring code
    (reference: Application::ConvertModel, application.cpp:233-241)."""
    if not cfg.input_model:
        log.fatal("task=convert_model needs input_model")
    bst = Booster(model_file=cfg.input_model, device=cfg.device_type)
    with open(cfg.convert_model, "w") as fh:
        fh.write(bst.model_to_if_else())
    log.info("Finished converting model; code saved to %s", cfg.convert_model)


def run_refit(cfg: Config) -> None:
    """task=refit: ``input_model``'s trees refit to the rows of ``data``,
    mixed by ``refit_decay_rate``, saved to ``output_model`` (reference:
    Application task kRefitTree -> GBDT::RefitTree, gbdt.cpp:298-321)."""
    if not cfg.input_model:
        log.fatal("task=refit needs input_model")
    bst = Booster(model_file=cfg.input_model, device=cfg.device_type)
    X, label = load_text(cfg.data, cfg)[:2]
    new_bst = bst.refit(X, label, decay_rate=cfg.refit_decay_rate)
    new_bst.save_model(cfg.output_model)
    log.info("Finished refit; model saved to %s", cfg.output_model)


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    params = _parse_args(argv)
    cfg = Config.from_params(params)
    task = cfg.task
    if task == "train":
        run_train(cfg, params)
    elif task in ("predict", "prediction", "test"):
        run_predict(cfg, params)
    elif task == "serve":
        run_serve(cfg)
    elif task == "online":
        from .online import run_online
        run_online(cfg, params)
    elif task == "refit":
        run_refit(cfg)
    elif task == "convert_model":
        run_convert_model(cfg)
    else:
        log.fatal(f"Unknown task {task!r} (supported: train, predict, "
                  "serve, online, refit, convert_model)")
