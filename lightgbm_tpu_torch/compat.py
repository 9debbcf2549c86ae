"""Optional-dependency flags and the JSON fallback for numpy values
(counterpart of lightgbm_tpu/compat.py; reference:
python-package/lightgbm/compat.py).  Scripts branch on the flags
(``compat.MATPLOTLIB_INSTALLED`` and so on)."""
from __future__ import annotations

import importlib.util


def json_default_with_numpy(obj):
    """``json.dumps`` fallback for numpy scalars and arrays (reference:
    compat.py:51-60)."""
    if hasattr(obj, "item") and not hasattr(obj, "__len__"):
        return obj.item()
    if hasattr(obj, "tolist"):
        return obj.tolist()
    raise TypeError(f"{type(obj).__name__} is not JSON serializable")


def _installed(name: str) -> bool:
    return importlib.util.find_spec(name) is not None


PANDAS_INSTALLED = _installed("pandas")
MATPLOTLIB_INSTALLED = _installed("matplotlib")
GRAPHVIZ_INSTALLED = _installed("graphviz")
DATATABLE_INSTALLED = False  # datatable is not supported
SKLEARN_INSTALLED = _installed("sklearn")


class LGBMDeprecationWarning(UserWarning):
    """(reference: compat.py:161)."""
