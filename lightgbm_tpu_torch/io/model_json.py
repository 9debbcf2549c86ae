"""Model dump to a JSON-ready dict, and the forest as C scoring code
(counterpart of lightgbm_tpu/io/model_json.py: ``dump_model``,
``tree_to_dict``, ``node_to_dict``, ``model_to_if_else``).

The key set and nesting are the reference's (reference: GBDT::DumpModel
src/boosting/gbdt_model_text.cpp:20-85, Tree::ToJSON / Tree::NodeToJSON
src/io/tree.cpp:248-321), so consumers of ``Booster.dump_model()`` read
either package's dump.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..core.tree import Tree

_MISSING_STR = {0: "None", 1: "Zero", 2: "NaN"}


def _avoid_inf(v: float) -> float:
    if np.isinf(v):
        return 1.7976931348623157e308 if v > 0 else -1.7976931348623157e308
    return float(v)


def _node_cats(tree: Tree, node: int) -> List[int]:
    ci = int(tree.threshold[node])
    lo, hi = int(tree.cat_boundaries[ci]), int(tree.cat_boundaries[ci + 1])
    return [(w - lo) * 32 + j for w in range(lo, hi) for j in range(32)
            if (int(tree.cat_threshold[w]) >> j) & 1]


def node_to_dict(tree: Tree, index: int) -> dict:
    """Recursive node dict (reference: Tree::NodeToJSON, tree.cpp:263-321)."""
    if index >= 0:
        d = {
            "split_index": int(index),
            "split_feature": int(tree.split_feature[index]),
            "split_gain": _avoid_inf(tree.split_gain[index]),
        }
        if tree.is_categorical(index):
            d["threshold"] = "||".join(str(c) for c in _node_cats(tree, index))
            d["decision_type"] = "=="
        else:
            d["threshold"] = _avoid_inf(tree.threshold[index])
            d["decision_type"] = "<="
        d["default_left"] = tree.default_left(index)
        d["missing_type"] = _MISSING_STR[tree.missing_type(index)]
        d["internal_value"] = float(tree.internal_value[index])
        d["internal_weight"] = float(tree.internal_weight[index])
        d["internal_count"] = int(tree.internal_count[index])
        d["left_child"] = node_to_dict(tree, int(tree.left_child[index]))
        d["right_child"] = node_to_dict(tree, int(tree.right_child[index]))
        return d
    index = ~index
    return {
        "leaf_index": int(index),
        "leaf_value": float(tree.leaf_value[index]),
        "leaf_weight": float(tree.leaf_weight[index]),
        "leaf_count": int(tree.leaf_count[index]),
    }


def tree_to_dict(tree: Tree, tree_index: int) -> dict:
    """(reference: Tree::ToJSON, tree.cpp:248-261)."""
    d = {
        "tree_index": int(tree_index),
        "num_leaves": int(tree.num_leaves),
        "num_cat": tree.num_cat if tree.cat_threshold.size else 0,
        "shrinkage": float(tree.shrinkage),
    }
    if tree.num_leaves == 1:
        d["tree_structure"] = {"leaf_value": float(tree.leaf_value[0])}
    else:
        d["tree_structure"] = node_to_dict(tree, 0)
    return d


def dump_model(gbdt, num_iteration: Optional[int] = None,
               start_iteration: int = 0) -> dict:
    """The whole model as a dict (reference: GBDT::DumpModel,
    gbdt_model_text.cpp:20-85; the Python package's Booster.dump_model
    returns the parsed dict)."""
    K = gbdt.num_tpi
    total_iteration = len(gbdt.models) // max(K, 1)
    start_iteration = min(max(start_iteration, 0), total_iteration)
    stop = total_iteration if not num_iteration or num_iteration <= 0 \
        else min(start_iteration + num_iteration, total_iteration)
    ds = gbdt.train_ds
    feature_names = list(ds.feature_names if ds is not None
                         else gbdt.feature_names)
    max_feature_idx = (ds.num_total_features - 1 if ds is not None
                       else max(len(feature_names) - 1, 0))
    cfg = gbdt.config
    d = {
        "name": "tree",
        "version": "v3",
        "num_class": int(cfg.num_class) if cfg is not None else K,
        "num_tree_per_iteration": K,
        "label_index": 0,
        "max_feature_idx": int(max_feature_idx),
        "average_output": bool(getattr(gbdt, "average_output", False)),
        "feature_names": feature_names,
        "monotone_constraints": (list(cfg.monotone_constraints)
                                 if cfg is not None else []),
    }
    if gbdt.objective is not None:
        d["objective"] = gbdt.objective_string
    d["tree_info"] = [tree_to_dict(gbdt.models[i], i)
                      for i in range(start_iteration * K, stop * K)]
    imp = gbdt.feature_importance("split", start_iteration, stop)
    d["feature_importances"] = {
        feature_names[i] if i < len(feature_names) else f"Column_{i}": int(v)
        for i, v in enumerate(imp) if v > 0
    }
    return d


# ----------------------------------------------------------------------
# if-else code generation (reference: Tree::ToIfElse tree.cpp:323-420,
# GBDT::ModelToIfElse gbdt_model_text.cpp:88-270).  Generates standalone
# dependency-free C so the output compiles anywhere (the reference emits
# code against its own headers; the traversal logic is identical).

def _node_code(tree: Tree, index: int, indent: str) -> str:
    if index < 0:
        return f"{indent}return {float(tree.leaf_value[~index])!r};\n"
    f = int(tree.split_feature[index])
    out = f"{indent}fval = row[{f}];\n"
    if tree.is_categorical(index):
        cats = _node_cats(tree, index)
        cond = " || ".join(f"ival == {c}" for c in cats) or "0"
        out += (f"{indent}ival = (isnan(fval) || fval < 0) ? -1 : (int)fval;\n"
                f"{indent}if ({cond}) {{\n")
    else:
        thr = _avoid_inf(tree.threshold[index])
        mt = tree.missing_type(index)
        dl = tree.default_left(index)
        if mt == 0:
            cond = f"fval <= {thr!r}"
        elif mt == 1:  # Zero
            if dl:
                cond = f"fval <= {thr!r} || fabs(fval) < 1e-35 || isnan(fval)"
            else:
                cond = f"fval <= {thr!r} && fabs(fval) >= 1e-35 && !isnan(fval)"
        else:          # NaN
            cond = (f"fval <= {thr!r} || isnan(fval)" if dl
                    else f"fval <= {thr!r} && !isnan(fval)")
        out += f"{indent}if ({cond}) {{\n"
    out += _node_code(tree, int(tree.left_child[index]), indent + "  ")
    out += f"{indent}}} else {{\n"
    out += _node_code(tree, int(tree.right_child[index]), indent + "  ")
    out += f"{indent}}}\n"
    return out


def model_to_if_else(gbdt, num_iteration: Optional[int] = None) -> str:
    """Standalone C source scoring the forest row-by-row (reference:
    GBDT::ModelToIfElse, gbdt_model_text.cpp:88-270)."""
    K = gbdt.num_tpi
    models = list(gbdt.models)
    n = len(models)
    if num_iteration and num_iteration > 0:
        n = min(num_iteration * K, n)
    out = ["#include <math.h>", ""]
    for i in range(n):
        t = models[i]
        out.append(f"static double PredictTree{i}(const double* row) {{")
        if t.num_leaves <= 1:
            out.append(f"  return {float(t.leaf_value[0])!r};")
        else:
            out.append("  double fval; int ival; (void)fval; (void)ival;")
            out.append(_node_code(t, 0, "  ").rstrip("\n"))
        out.append("}")
        out.append("")
    out.append(f"#define NUM_TREES {n}")
    out.append(f"#define NUM_CLASS {K}")
    out.append("typedef double (*TreeFn)(const double*);")
    out.append("static const TreeFn PredictTreePtr[NUM_TREES] = {")
    out.append("  " + ", ".join(f"PredictTree{i}" for i in range(n)))
    out.append("};")
    out.append("""
void PredictRaw(const double* row, double* output) {
  for (int k = 0; k < NUM_CLASS; ++k) output[k] = 0.0;
  for (int i = 0; i < NUM_TREES; ++i)
    output[i % NUM_CLASS] += PredictTreePtr[i](row);
}""")
    return "\n".join(out)
