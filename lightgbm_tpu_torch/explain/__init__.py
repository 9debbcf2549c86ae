"""TreeSHAP over stacked forests on the training device (counterpart of
lightgbm_tpu/explain/): ``paths`` packs each tree's root-to-leaf path
metadata on the host, ``kernel`` runs the EXTEND/UNWIND recurrence over
all rows x leaves as torch ops, emitting ``[N, K, F+1]`` contributions
(the last column is the expected value, as ``predict_contrib``).
``core/shap.py`` is the host recursion and the oracle; the cost model is
``ops/treeshap.py``."""
from .kernel import forest_shap_fn
from .paths import ExplainArrays, stack_explain, tree_path_arrays

__all__ = ["ExplainArrays", "forest_shap_fn", "stack_explain",
           "tree_path_arrays"]
