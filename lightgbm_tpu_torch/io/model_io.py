"""Model text in the LightGBM v2.3.2 format (counterpart of
lightgbm_tpu/io/model_io.py).

Save mirrors ``GBDT::SaveModelToString`` (reference:
src/boosting/gbdt_model_text.cpp:271-368, Tree::ToString
src/io/tree.cpp:341); load mirrors ``GBDT::LoadModelFromString`` (:380-480)
and ``Tree``'s parsing constructor (src/io/tree.cpp:398-607).  Files
written here load in the JAX package and the reference CLI, and their
files, categorical ones included, load here.
"""
from __future__ import annotations

import io as _io
from typing import Dict, List

import numpy as np

from ..boosting.gbdt import PredictorBase
from ..core.tree import Tree
from .binning import BIN_CATEGORICAL
from ..utils import log


def _fmt(x: float) -> str:
    """Shortest round-trip float formatting."""
    return np.format_float_positional(
        float(x), unique=True, trim="0") if np.isfinite(x) else repr(float(x))


def _fmt_list(arr) -> str:
    return " ".join(_fmt(v) for v in arr)


def _int_list(arr) -> str:
    return " ".join(str(int(v)) for v in arr)


def tree_to_string(tree: Tree, index: int) -> str:
    """One ``Tree=i`` block (reference: Tree::ToString, src/io/tree.cpp:341)."""
    nn = max(tree.num_leaves - 1, 0)
    nl = tree.num_leaves
    cats = ([f"cat_boundaries={_int_list(tree.cat_boundaries)}\n",
             f"cat_threshold={_int_list(tree.cat_threshold)}\n"]
            if tree.num_cat > 0 else [])
    return "".join([
        f"Tree={index}\n",
        f"num_leaves={nl}\n",
        f"num_cat={tree.num_cat}\n",
        f"split_feature={_int_list(tree.split_feature[:nn])}\n",
        f"split_gain={_fmt_list(tree.split_gain[:nn])}\n",
        f"threshold={_fmt_list(tree.threshold[:nn])}\n",
        f"decision_type={_int_list(tree.decision_type[:nn])}\n",
        f"left_child={_int_list(tree.left_child[:nn])}\n",
        f"right_child={_int_list(tree.right_child[:nn])}\n",
        f"leaf_value={_fmt_list(tree.leaf_value[:nl])}\n",
        f"leaf_weight={_fmt_list(tree.leaf_weight[:nl])}\n",
        f"leaf_count={_int_list(tree.leaf_count[:nl])}\n",
        f"internal_value={_fmt_list(tree.internal_value[:nn])}\n",
        f"internal_weight={_fmt_list(tree.internal_weight[:nn])}\n",
        f"internal_count={_int_list(tree.internal_count[:nn])}\n",
        *cats,
        f"shrinkage={_fmt(tree.shrinkage)}\n",
        "\n\n",
    ])


def _feature_info(m) -> str:
    """A mapper's ``feature_infos`` entry: ``none`` (trivial), the sorted
    categories (categorical) or ``[min:max]``."""
    if m.is_trivial:
        return "none"
    if m.bin_type == BIN_CATEGORICAL:
        return ":".join(str(c) for c in sorted(
            c for c in m.bin_2_categorical if c >= 0))
    return f"[{_fmt(m.min_val)}:{_fmt(m.max_val)}]"


def model_to_string(gbdt, num_iteration: int = -1,
                    start_iteration: int = 0) -> str:
    """(reference: GBDT::SaveModelToString, gbdt_model_text.cpp:271-368).
    A trained booster writes its dataset's feature names and ranges; a
    loaded one writes back those of its file."""
    K = gbdt.num_tpi
    start, stop = gbdt._iter_window(num_iteration, start_iteration)
    trees = gbdt.models[start * K:stop * K]
    ds = gbdt.train_ds
    if ds is not None:
        feature_names = list(ds.feature_names)
        infos = [_feature_info(m) for m in ds.bin_mappers]
    else:
        feature_names = list(gbdt.feature_names)
        infos = list(gbdt.feature_infos)
    max_feature_idx = (len(feature_names) - 1 if feature_names
                       else gbdt.num_features - 1)

    buf = _io.StringIO()
    buf.write("tree\n")
    buf.write("version=v3\n")
    buf.write(f"num_class={gbdt.num_class}\n")
    buf.write(f"num_tree_per_iteration={K}\n")
    buf.write("label_index=0\n")
    buf.write(f"max_feature_idx={max_feature_idx}\n")
    buf.write(f"objective={gbdt.objective_string}\n")
    if getattr(gbdt, "average_output", False):
        buf.write("average_output\n")
    buf.write(f"feature_names={' '.join(feature_names)}\n")
    buf.write(f"feature_infos={' '.join(infos)}\n")
    tree_strs = [tree_to_string(t, i) for i, t in enumerate(trees)]
    buf.write(f"tree_sizes={' '.join(str(len(s)) for s in tree_strs)}\n\n")
    for s in tree_strs:
        buf.write(s)
    buf.write("end of trees\n")
    # feature importances, descending (gbdt_model_text.cpp:330-358)
    if ds is not None:
        imp = gbdt.feature_importance("split", start, stop)
        order = np.argsort(-imp, kind="stable")
        buf.write("\nfeature_importances:\n")
        for j in order:
            if imp[j] > 0:
                buf.write(f"{feature_names[int(j)]}={int(imp[int(j)])}\n")
    buf.write("\nparameters:\n")
    if gbdt.config is not None:
        for k, v in gbdt.config.to_params().items():
            if isinstance(v, (list, tuple)):
                v = ",".join(str(x) for x in v)
            buf.write(f"[{k}: {v}]\n")
    buf.write("\nend of parameters\n")
    return buf.getvalue()


# ----------------------------------------------------------------------
def _parse_tree_block(lines: Dict[str, str]) -> Tree:
    nl = int(lines["num_leaves"])
    nn = max(nl - 1, 0)

    def farr(key, n, default=0.0):
        if key not in lines or not lines[key].strip():
            return np.full(n, default, dtype=np.float64)
        return np.asarray([float(x) for x in lines[key].split()],
                          dtype=np.float64)

    def iarr(key, n, default=0):
        if key not in lines or not lines[key].strip():
            return np.full(n, default, dtype=np.int32)
        return np.asarray([int(float(x)) for x in lines[key].split()],
                          dtype=np.int32)

    num_cat = int(lines.get("num_cat", "0"))
    return Tree(
        num_leaves=nl,
        split_feature=iarr("split_feature", nn),
        threshold=farr("threshold", nn),
        threshold_bin=np.zeros(nn, np.int32),
        decision_type=iarr("decision_type", nn),
        left_child=iarr("left_child", nn),
        right_child=iarr("right_child", nn),
        leaf_value=farr("leaf_value", nl),
        leaf_count=iarr("leaf_count", nl),
        leaf_weight=farr("leaf_weight", nl),
        split_gain=farr("split_gain", nn),
        internal_value=farr("internal_value", nn),
        internal_count=iarr("internal_count", nn),
        internal_weight=farr("internal_weight", nn),
        shrinkage=float(lines.get("shrinkage", "1")),
        cat_boundaries=(iarr("cat_boundaries", 1) if num_cat > 0
                        else np.zeros(1, np.int32)),
        cat_threshold=(np.asarray([int(x) for x in
                                   lines["cat_threshold"].split()],
                                  dtype=np.uint32)
                       if num_cat > 0 else np.zeros(0, np.uint32)),
    )


class LoadedGBDT(PredictorBase):
    """Prediction-only booster built from model text (the reference
    rebuilds a whole GBDT; prediction needs only the trees and the
    objective).  Everything is inherited from ``PredictorBase``: with no
    dataset, small inputs walk the trees on the host, and larger ones walk
    them on ``device`` in a bin space rebuilt from the model itself
    (serve/packing.py)."""

    def __init__(self, models: List[Tree], num_tpi: int, objective,
                 objective_string: str, num_class: int,
                 feature_names: List[str], feature_infos: List[str],
                 average_output: bool, max_feature_idx: int, device):
        self.models = models
        self.num_tpi = num_tpi
        self.objective = objective
        self.objective_string = objective_string
        self.num_class = num_class
        self.feature_names = feature_names
        self.feature_infos = feature_infos
        self.average_output = average_output
        # the declared width of the feature space (model header)
        self.num_features = (max_feature_idx + 1 if max_feature_idx >= 0
                             else len(feature_names))
        self.device = device
        self.train_ds = None
        self.config = None

    def predict_raw(self, X, num_iteration=None, start_iteration: int = 0,
                    early_stop=None):
        raw = super().predict_raw(X, num_iteration, start_iteration,
                                  early_stop)
        if self.average_output:
            start, stop = self._iter_window(num_iteration, start_iteration)
            raw /= max(stop - start, 1)
        return raw


def load_model_string(model_str: str, device) -> LoadedGBDT:
    """Parse LightGBM model text (the port's, the JAX package's or the
    reference's) into a booster that predicts on ``device``.  The header's
    objective is built for prediction (``objective_from_model``); a name
    the port cannot build leaves raw scores only, and asking for converted
    predictions then raises."""
    from ..objective import objective_from_model

    header: Dict[str, str] = {}
    pos = model_str.find("\nTree=")
    head_part = model_str[:pos] if pos >= 0 else model_str
    for line in head_part.splitlines():
        if "=" in line:
            k, _, v = line.partition("=")
            header[k.strip()] = v.strip()
    average_output = "average_output" in head_part.splitlines()

    obj_str = header.get("objective", "custom") or "custom"
    num_class = int(header.get("num_class", "1"))
    objective, objective_error = None, None
    try:
        objective = objective_from_model(obj_str, num_class)
    except log.LightGBMError as exc:
        objective_error = (f"the model's objective {obj_str!r} is not built "
                           f"({exc}); predict with raw_score=True")

    models: List[Tree] = []
    for chunk in model_str.split("\nTree=")[1:]:
        lines: Dict[str, str] = {}
        for line in chunk.split("end of trees")[0].splitlines():
            if "=" in line:
                k, _, v = line.partition("=")
                lines[k.strip()] = v.strip()
        models.append(_parse_tree_block(lines))

    try:
        max_feature_idx = int(header.get("max_feature_idx", "-1"))
    except ValueError:
        max_feature_idx = -1
    gbdt = LoadedGBDT(models, int(header.get("num_tree_per_iteration", "1")),
                      objective, obj_str, num_class,
                      header.get("feature_names", "").split(),
                      header.get("feature_infos", "").split(),
                      average_output, max_feature_idx, device)
    gbdt.objective_error = objective_error
    return gbdt


def load_model_file(path: str, device) -> LoadedGBDT:
    with open(path) as fh:
        return load_model_string(fh.read(), device)
