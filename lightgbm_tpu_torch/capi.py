"""The C API's surface: the reference's ``LGBM_*`` exports over handles
(counterpart of lightgbm_tpu/capi.py, over the port's ``Dataset`` and
``Booster``).

Mirrors LightGBM's ``include/LightGBM/c_api.h`` (``src/c_api.cpp``) with
its calling conventions, as Python functions:

* every function returns an ``int`` status, ``0`` on success and ``-1``
  on error with the message from :func:`LGBM_GetLastError` (the
  reference's ``API_BEGIN``/``API_END``);
* objects are opaque integer handles from a registry (``DatasetHandle``,
  ``BoosterHandle``);
* a scalar out-parameter is written through any object with a ``.value``
  (a ``ctypes.c_int64()`` or :class:`Ref`); an array out-parameter is a
  caller's numpy buffer, written in place (the C ``double*`` contract).

The device is the ``device_type`` of the parameter string (``cuda``, the
card, unless it says ``cpu``).  A call without a parameter string (a
model file loaded, a model string) takes the device of the last one that
named a ``device_type``, else the card.  ``native/capi_abi.c`` loads this
module into a C program through ``capi_embed.py``.
"""
from __future__ import annotations

import ctypes
import itertools
import json
import threading
from typing import Any, Dict, List, Optional

import numpy as np

from .basic import Booster, Dataset
from .config import Config
from .utils.log import LightGBMError

# ---- dtype / predict-type constants (c_api.h:25-34) ----------------------
C_API_DTYPE_FLOAT32 = 0
C_API_DTYPE_FLOAT64 = 1
C_API_DTYPE_INT32 = 2
C_API_DTYPE_INT64 = 3
C_API_DTYPE_INT8 = 4

C_API_PREDICT_NORMAL = 0
C_API_PREDICT_RAW_SCORE = 1
C_API_PREDICT_LEAF_INDEX = 2
C_API_PREDICT_CONTRIB = 3

_NUMPY_OF_DTYPE = {
    C_API_DTYPE_FLOAT32: np.float32,
    C_API_DTYPE_FLOAT64: np.float64,
    C_API_DTYPE_INT32: np.int32,
    C_API_DTYPE_INT64: np.int64,
    C_API_DTYPE_INT8: np.int8,
}


class Ref:
    """Scalar out-parameter: ``Ref()`` then read ``.value`` after the call.

    Any ``ctypes`` scalar instance is accepted interchangeably.
    """

    __slots__ = ("value",)

    def __init__(self, value: Any = None):
        self.value = value


_tls = threading.local()
_handles: Dict[int, Any] = {}
_next_handle = itertools.count(1)
_lock = threading.Lock()


def _set_err(msg: str) -> int:
    _tls.err = str(msg)
    return -1


def LGBM_GetLastError() -> str:
    """Reference: ``c_api.cpp`` ``LGBM_GetLastError`` (thread-local)."""
    return getattr(_tls, "err", "Everything is fine")


def LGBM_SetLastError(msg: str) -> None:
    _set_err(msg)


def _alloc(obj: Any, out_handle) -> int:
    with _lock:
        h = next(_next_handle)
        _handles[h] = obj
    _store(out_handle, h)
    return 0


def _get(handle, want) -> Any:
    h = handle.value if hasattr(handle, "value") else handle
    obj = _handles.get(int(h))
    if obj is None or not isinstance(obj, want):
        raise LightGBMError(f"invalid {want.__name__} handle: {h!r}")
    return obj


def _store(out, value) -> None:
    if out is None:
        return
    if isinstance(out, np.ndarray):
        flat = np.asarray(value).ravel()
        out.ravel()[: flat.size] = flat
    else:
        out.value = value


def _capi(fn):
    """API_BEGIN/API_END analog: exceptions -> -1 + last-error string."""

    def wrapper(*args, **kwargs):
        try:
            r = fn(*args, **kwargs)
            return 0 if r is None else r
        except Exception as e:  # noqa: BLE001 - C boundary swallows all
            return _set_err(f"{type(e).__name__}: {e}")

    wrapper.__name__ = fn.__name__
    wrapper.__doc__ = fn.__doc__
    return wrapper


def _params_dict(parameters: Optional[str]) -> Dict[str, Any]:
    """``key=value key2=value2`` C-API parameter string -> dict; a
    ``device_type`` in it becomes the device of later calls without
    one."""
    out: Dict[str, Any] = {}
    for tok in (parameters or "").replace("\n", " ").split():
        if "=" in tok:
            k, v = tok.split("=", 1)
            out[k.strip()] = v.strip()
    named = {k: v for k, v in out.items() if k in ("device_type", "device")}
    if named:
        _device[0] = Config.from_params(named).device_type
    return out


# the device of a call whose parameters name none (module docstring)
_device = ["cuda"]


def _as_matrix(data, n_row: int, n_col: int, data_type: int,
               is_row_major: int = 1) -> np.ndarray:
    arr = np.frombuffer(data, dtype=_NUMPY_OF_DTYPE[data_type]) \
        if isinstance(data, (bytes, bytearray, memoryview)) \
        else np.asarray(data, dtype=_NUMPY_OF_DTYPE[data_type])
    arr = arr.ravel()[: n_row * n_col]
    mat = arr.reshape((n_row, n_col) if is_row_major else (n_col, n_row))
    return mat if is_row_major else mat.T


def _csr_to_dense(indptr, indices, data, num_col: int) -> np.ndarray:
    indptr = np.asarray(indptr, np.int64)
    indices = np.asarray(indices, np.int32)
    data = np.asarray(data, np.float64)
    n = len(indptr) - 1
    dense = np.zeros((n, num_col), np.float64)
    for i in range(n):
        lo, hi = indptr[i], indptr[i + 1]
        dense[i, indices[lo:hi]] = data[lo:hi]
    return dense


class _PushState:
    """Dataset being filled row-block-wise (LGBM_DatasetPushRows*)."""

    def __init__(self, num_row: int, num_col: int, params: Dict[str, Any],
                 reference: Optional[Dataset]):
        self.mat = np.full((num_row, num_col), np.nan, np.float64)
        self.seen = 0
        self.params = params
        self.reference = reference


class _CDataset:
    """Handle target: either a constructed Dataset or a push-mode buffer."""

    def __init__(self, ds: Optional[Dataset] = None,
                 push: Optional[_PushState] = None):
        self.ds = ds
        self.push = push
        self.feature_names: Optional[List[str]] = None
        self.fields: Dict[str, np.ndarray] = {}

    def require(self) -> Dataset:
        if self.ds is None:
            if self.push is None or self.push.seen < len(self.push.mat):
                raise LightGBMError("dataset is not constructed yet "
                                    f"({0 if self.push is None else self.push.seen}"
                                    " rows pushed)")
            self._finish_push()
        return self.ds

    def _finish_push(self) -> None:
        p = self.push
        self.ds = Dataset(p.mat, params=dict(p.params),
                          reference=p.reference,
                          feature_name=self.feature_names or "auto",
                          free_raw_data=False)
        for k, v in self.fields.items():
            _set_field(self, k, v)
        self.ds.construct()

    def maybe_finish(self) -> None:
        if self.ds is None and self.push is not None \
                and self.push.seen >= len(self.push.mat):
            self._finish_push()


def _set_field(cds: "_CDataset", name: str, arr: np.ndarray) -> None:
    ds = cds.ds if cds.ds is not None else None
    if ds is None:
        cds.fields[name] = arr
        return
    if name == "label":
        ds.set_label(arr)
    elif name == "weight":
        ds.set_weight(arr)
    elif name in ("group", "query"):
        ds.set_group(arr)
    elif name == "init_score":
        ds.set_init_score(arr)
    else:
        raise LightGBMError(f"unknown field name: {name}")


# ======================= Dataset functions ================================

@_capi
def LGBM_DatasetCreateFromFile(filename: str, parameters: str,
                               reference, out_handle) -> int:
    """Reference: ``c_api.cpp LGBM_DatasetCreateFromFile``."""
    from .io.text_loader import load_text
    params = _params_dict(parameters)
    cfg = Config.from_params(params)
    X, y, w, grp, names = load_text(str(filename), cfg)
    ref = _get(reference, _CDataset).require() if reference else None
    ds = Dataset(X, label=y, weight=w, group=grp, feature_name=names,
                 params=params, reference=ref, free_raw_data=False)
    ds.construct()
    return _alloc(_CDataset(ds), out_handle)


@_capi
def LGBM_DatasetCreateFromMat(data, data_type: int, nrow: int, ncol: int,
                              is_row_major: int, parameters: str,
                              reference, out_handle) -> int:
    mat = _as_matrix(data, nrow, ncol, data_type, is_row_major)
    ref = _get(reference, _CDataset).require() if reference else None
    ds = Dataset(mat, params=_params_dict(parameters), reference=ref,
                 free_raw_data=False)
    ds.construct()
    return _alloc(_CDataset(ds), out_handle)


@_capi
def LGBM_DatasetCreateFromMats(nmat: int, data_list, data_type: int,
                               nrow_list, ncol: int, is_row_major: int,
                               parameters: str, reference,
                               out_handle) -> int:
    mats = [_as_matrix(d, int(nr), ncol, data_type, is_row_major)
            for d, nr in zip(data_list, nrow_list)]
    mat = np.concatenate(mats, axis=0)
    ref = _get(reference, _CDataset).require() if reference else None
    ds = Dataset(mat, params=_params_dict(parameters), reference=ref,
                 free_raw_data=False)
    ds.construct()
    return _alloc(_CDataset(ds), out_handle)


@_capi
def LGBM_DatasetCreateFromCSR(indptr, indptr_type: int, indices, data,
                              data_type: int, nindptr: int, nelem: int,
                              num_col: int, parameters: str, reference,
                              out_handle) -> int:
    # stays sparse: BinnedDataset.from_csr bins its stored entries without
    # a dense raw matrix (the reference's SparseBin, src/io/sparse_bin.hpp)
    import scipy.sparse as sp
    mat = sp.csr_matrix(
        (np.asarray(data, np.float64), np.asarray(indices, np.int32),
         np.asarray(indptr, np.int64)),
        shape=(len(np.asarray(indptr)) - 1, int(num_col)))
    ref = _get(reference, _CDataset).require() if reference else None
    ds = Dataset(mat, params=_params_dict(parameters), reference=ref,
                 free_raw_data=False)
    ds.construct()
    return _alloc(_CDataset(ds), out_handle)


@_capi
def LGBM_DatasetCreateFromCSRFunc(get_row_fun, num_rows: int, num_col: int,
                                  parameters: str, reference,
                                  out_handle) -> int:
    """``get_row_fun(i) -> [(col, value), ...]`` per-row iterator form."""
    mat = np.zeros((int(num_rows), int(num_col)), np.float64)
    for i in range(int(num_rows)):
        for c, v in get_row_fun(i):
            mat[i, int(c)] = v
    ref = _get(reference, _CDataset).require() if reference else None
    ds = Dataset(mat, params=_params_dict(parameters), reference=ref,
                 free_raw_data=False)
    ds.construct()
    return _alloc(_CDataset(ds), out_handle)


@_capi
def LGBM_DatasetCreateFromCSC(col_ptr, col_ptr_type: int, indices, data,
                              data_type: int, ncol_ptr: int, nelem: int,
                              num_row: int, parameters: str, reference,
                              out_handle) -> int:
    import scipy.sparse as sp
    mat = sp.csc_matrix(
        (np.asarray(data, np.float64), np.asarray(indices, np.int32),
         np.asarray(col_ptr, np.int64)),
        shape=(int(num_row), len(np.asarray(col_ptr)) - 1))
    ref = _get(reference, _CDataset).require() if reference else None
    ds = Dataset(mat, params=_params_dict(parameters), reference=ref,
                 free_raw_data=False)
    ds.construct()
    return _alloc(_CDataset(ds), out_handle)


@_capi
def LGBM_DatasetCreateFromSampledColumn(sample_data, sample_indices,
                                        ncol: int, num_per_col,
                                        num_sample_row: int,
                                        num_total_row: int, parameters: str,
                                        out_handle) -> int:
    """Streaming creation: bin mappers from a column sample, rows pushed
    later (reference: ``c_api.cpp LGBM_DatasetCreateFromSampledColumn``).

    As in the JAX package, the mappers are built when the last
    ``PushRows`` completes the rows; the sample gives the shape only.
    """
    push = _PushState(int(num_total_row), int(ncol),
                      _params_dict(parameters), None)
    return _alloc(_CDataset(push=push), out_handle)


@_capi
def LGBM_DatasetCreateByReference(reference, num_total_row,
                                  out_handle) -> int:
    ref = _get(reference, _CDataset).require()
    push = _PushState(int(getattr(num_total_row, "value", num_total_row)),
                      ref.num_feature(), dict(ref.params or {}), ref)
    return _alloc(_CDataset(push=push), out_handle)


@_capi
def LGBM_DatasetPushRows(dataset, data, data_type: int, nrow: int,
                         ncol: int, start_row: int) -> int:
    cds = _get(dataset, _CDataset)
    if cds.push is None:
        raise LightGBMError("dataset was not created in push mode")
    mat = _as_matrix(data, nrow, ncol, data_type, 1)
    cds.push.mat[int(start_row): int(start_row) + nrow] = mat
    cds.push.seen += nrow
    cds.maybe_finish()
    return 0


@_capi
def LGBM_DatasetPushRowsByCSR(dataset, indptr, indptr_type: int, indices,
                              data, data_type: int, nindptr: int,
                              nelem: int, num_col: int,
                              start_row: int) -> int:
    cds = _get(dataset, _CDataset)
    if cds.push is None:
        raise LightGBMError("dataset was not created in push mode")
    mat = _csr_to_dense(indptr, indices, data, int(num_col))
    cds.push.mat[int(start_row): int(start_row) + len(mat)] = mat
    cds.push.seen += len(mat)
    cds.maybe_finish()
    return 0


@_capi
def LGBM_DatasetGetSubset(handle, used_row_indices, num_used_row_indices,
                          parameters: str, out_handle) -> int:
    cds = _get(handle, _CDataset)
    idx = np.asarray(used_row_indices, np.int32)[: int(num_used_row_indices)]
    sub = cds.require().subset(idx, params=_params_dict(parameters))
    sub.construct()
    return _alloc(_CDataset(sub), out_handle)


@_capi
def LGBM_DatasetSetFeatureNames(handle, feature_names,
                                num_feature_names: int) -> int:
    cds = _get(handle, _CDataset)
    names = [str(s) for s in feature_names][: int(num_feature_names)]
    cds.feature_names = names
    if cds.ds is not None:
        cds.ds.feature_name = names
        if cds.ds._handle is not None:
            cds.ds._handle.feature_names = list(names)
    return 0


@_capi
def LGBM_DatasetGetFeatureNames(handle, out_strs) -> int:
    cds = _get(handle, _CDataset)
    _store(out_strs, cds.require().get_feature_name())
    return 0


@_capi
def LGBM_DatasetFree(handle) -> int:
    h = int(handle.value if hasattr(handle, "value") else handle)
    with _lock:
        _handles.pop(h, None)
    return 0


@_capi
def LGBM_DatasetSaveBinary(handle, filename: str) -> int:
    _get(handle, _CDataset).require().save_binary(str(filename))
    return 0


@_capi
def LGBM_DatasetDumpText(handle, filename: str) -> int:
    """Reference: ``dataset.cpp Dataset::DumpTextFile`` — bin values +
    mapper summary for debugging."""
    ds = _get(handle, _CDataset).require()._handle
    with open(str(filename), "w") as f:
        f.write(f"num_data: {ds.num_data}\n")
        f.write(f"num_features: {ds.num_features}\n")
        for i in range(ds.num_features):
            m = ds.bin_mappers[int(ds.real_feature_idx[i])]
            f.write(f"feature {i} num_bin={m.num_bin}\n")
        for r in range(min(ds.num_data, 1000)):
            f.write(" ".join(str(int(v)) for v in ds.X_bin[r]) + "\n")
    return 0


@_capi
def LGBM_DatasetSetField(handle, field_name: str, field_data,
                         num_element: int, type: int) -> int:
    cds = _get(handle, _CDataset)
    arr = np.asarray(field_data, _NUMPY_OF_DTYPE[type]).ravel()
    arr = arr[: int(num_element)]
    _set_field(cds, str(field_name), arr)
    return 0


@_capi
def LGBM_DatasetGetField(handle, field_name: str, out_len, out_ptr,
                         out_type) -> int:
    cds = _get(handle, _CDataset)
    name = str(field_name)
    ds = cds.require()
    if name == "label":
        arr, t = ds.get_label(), C_API_DTYPE_FLOAT32
    elif name == "weight":
        arr, t = ds.get_weight(), C_API_DTYPE_FLOAT32
    elif name in ("group", "query"):
        # C API returns query BOUNDARIES (nq+1 cumulative), not sizes
        # (reference: c_api.cpp LGBM_DatasetGetField -> query_boundaries)
        sizes = ds.get_group()
        arr = None if sizes is None else \
            np.concatenate([[0], np.cumsum(np.asarray(sizes, np.int64))])
        t = C_API_DTYPE_INT32
    elif name == "init_score":
        arr, t = ds.get_init_score(), C_API_DTYPE_FLOAT64
    else:
        raise LightGBMError(f"unknown field name: {name}")
    if arr is None:
        _store(out_len, 0)
        return 0
    arr = np.asarray(arr, _NUMPY_OF_DTYPE[t])
    _store(out_len, len(arr))
    _store(out_ptr, arr)
    _store(out_type, t)
    return 0


@_capi
def LGBM_DatasetUpdateParam(handle, parameters: str) -> int:
    cds = _get(handle, _CDataset)
    new = _params_dict(parameters)
    # binning-relevant params cannot change after construction
    # (reference: c_api.cpp checks via Dataset::CheckCanUpdateParams)
    frozen = {"max_bin", "min_data_in_bin", "bin_construct_sample_cnt",
              "enable_bundle", "use_missing", "zero_as_missing"}
    if cds.ds is not None and cds.ds._handle is not None:
        cur = cds.ds.params or {}
        for k in new:
            if k in frozen and str(cur.get(k)) != str(new[k]):
                raise LightGBMError(
                    f"cannot change {k} after constructed Dataset")
    (cds.ds.params if cds.ds is not None else cds.push.params).update(new)
    return 0


@_capi
def LGBM_DatasetGetNumData(handle, out) -> int:
    _store(out, _get(handle, _CDataset).require().num_data())
    return 0


@_capi
def LGBM_DatasetGetNumFeature(handle, out) -> int:
    _store(out, _get(handle, _CDataset).require().num_feature())
    return 0


@_capi
def LGBM_DatasetAddFeaturesFrom(target, source) -> int:
    """Reference: ``dataset.cpp Dataset::AddFeaturesFrom`` — column-wise
    merge of two constructed datasets with equal row counts."""
    t = _get(target, _CDataset)
    s = _get(source, _CDataset).require()
    tds = t.require()
    if tds.num_data() != s.num_data():
        raise LightGBMError("cannot add features from dataset with "
                            "different number of rows")
    merged = np.concatenate([np.asarray(tds.data, np.float64),
                             np.asarray(s.data, np.float64)], axis=1)
    out = Dataset(merged, label=tds.get_label(), params=dict(tds.params or {}))
    out.weight = tds.get_weight()
    out.group = tds.get_group()
    out.construct()
    t.ds = out
    return 0


# ======================= Booster functions ================================

class _CBooster:
    def __init__(self, booster: Booster):
        self.b = booster
        self.last_predict: Dict[int, np.ndarray] = {}


@_capi
def LGBM_BoosterCreate(train_data, parameters: str, out_handle) -> int:
    ds = _get(train_data, _CDataset).require()
    params = _params_dict(parameters)
    b = Booster(params=params, train_set=ds, device=_device[0])
    return _alloc(_CBooster(b), out_handle)


@_capi
def LGBM_BoosterCreateFromModelfile(filename: str, out_num_iterations,
                                    out_handle) -> int:
    b = Booster(model_file=str(filename), device=_device[0])
    _store(out_num_iterations, b.current_iteration())
    return _alloc(_CBooster(b), out_handle)


@_capi
def LGBM_BoosterLoadModelFromString(model_str: str, out_num_iterations,
                                    out_handle) -> int:
    b = Booster(model_str=str(model_str), device=_device[0])
    _store(out_num_iterations, b.current_iteration())
    return _alloc(_CBooster(b), out_handle)


@_capi
def LGBM_BoosterFree(handle) -> int:
    h = int(handle.value if hasattr(handle, "value") else handle)
    with _lock:
        _handles.pop(h, None)
    return 0


@_capi
def LGBM_BoosterShuffleModels(handle, start_iter: int, end_iter: int) -> int:
    """Reference: ``gbdt.cpp GBDT::ShuffleModels`` — random permutation of
    the tree order inside ``[start_iter, end_iter)``."""
    b = _get(handle, _CBooster).b
    g = b._gbdt
    k = g.num_tpi
    trees = list(g.models)
    n_iter = len(trees) // k
    end = n_iter if end_iter <= 0 else min(int(end_iter), n_iter)
    start = max(0, int(start_iter))
    idx = np.arange(n_iter)
    rng = np.random.default_rng(g.config.seed if g.config else 0)
    idx[start:end] = rng.permutation(idx[start:end])
    g.models[:] = [trees[i * k + j] for i in idx for j in range(k)]
    _models_changed(g)
    return 0


def _models_changed(g) -> None:
    """The forest was edited in place: the device forest's cache key
    moves, and a trainer's replay state follows the trees."""
    g._model_version = getattr(g, "_model_version", 0) + 1
    if hasattr(g, "_refresh_replay_state"):
        g._refresh_replay_state()


@_capi
def LGBM_BoosterMerge(handle, other_handle) -> int:
    """Append ``other``'s trees (reference: ``gbdt.h GBDT::MergeFrom``)."""
    a = _get(handle, _CBooster).b._gbdt
    o = _get(other_handle, _CBooster).b._gbdt
    if a.num_tpi != o.num_tpi:
        raise LightGBMError("cannot merge boosters with different "
                            "models per iteration")
    a.models.extend(list(o.models))
    _models_changed(a)
    return 0


@_capi
def LGBM_BoosterAddValidData(handle, valid_data) -> int:
    cb = _get(handle, _CBooster)
    ds = _get(valid_data, _CDataset).require()
    cb.b.add_valid(ds, f"valid_{len(cb.b.valid_sets)}")
    return 0


@_capi
def LGBM_BoosterResetTrainingData(handle, train_data) -> int:
    """Keep the forest, swap the training data (reference:
    ``gbdt.cpp GBDT::ResetTrainingData``): rebuild the trainer on the new
    dataset and replay the existing trees onto its scores."""
    import copy
    cb = _get(handle, _CBooster)
    ds = _get(train_data, _CDataset).require()
    old = cb.b
    trees = [copy.deepcopy(t) for t in old._gbdt.models]
    nb = Booster(params=dict(old.params or {}), train_set=ds,
                 device=old.device)
    if trees:
        nb._gbdt.load_initial_models(trees, replay_scores=True)
    nb.best_iteration = old.best_iteration
    cb.b = nb
    return 0


@_capi
def LGBM_BoosterResetParameter(handle, parameters: str) -> int:
    _get(handle, _CBooster).b.reset_parameter(_params_dict(parameters))
    return 0


@_capi
def LGBM_BoosterGetNumClasses(handle, out_len) -> int:
    g = _get(handle, _CBooster).b._gbdt
    _store(out_len, g.config.num_class if g.config else g.num_tpi)
    return 0


@_capi
def LGBM_BoosterUpdateOneIter(handle, is_finished) -> int:
    fin = _get(handle, _CBooster).b.update()
    _store(is_finished, 1 if fin else 0)
    return 0


@_capi
def LGBM_BoosterUpdateOneIterCustom(handle, grad, hess,
                                    is_finished) -> int:
    cb = _get(handle, _CBooster)
    g = np.asarray(grad, np.float32)
    h = np.asarray(hess, np.float32)

    def fobj(score, ds):
        return g, h

    fin = cb.b.update(fobj=fobj)
    _store(is_finished, 1 if fin else 0)
    return 0


@_capi
def LGBM_BoosterRollbackOneIter(handle) -> int:
    _get(handle, _CBooster).b.rollback_one_iter()
    return 0


@_capi
def LGBM_BoosterGetCurrentIteration(handle, out_iteration) -> int:
    _store(out_iteration, _get(handle, _CBooster).b.current_iteration())
    return 0


@_capi
def LGBM_BoosterNumModelPerIteration(handle, out_tree_per_iteration) -> int:
    _store(out_tree_per_iteration,
           _get(handle, _CBooster).b.num_model_per_iteration())
    return 0


@_capi
def LGBM_BoosterNumberOfTotalModel(handle, out_models) -> int:
    _store(out_models, _get(handle, _CBooster).b.num_trees())
    return 0


@_capi
def LGBM_BoosterGetEvalCounts(handle, out_len) -> int:
    b = _get(handle, _CBooster).b
    _store(out_len, len(b._gbdt.metrics))
    return 0


@_capi
def LGBM_BoosterGetEvalNames(handle, out_len, out_strs) -> int:
    b = _get(handle, _CBooster).b
    names = [m.name for m in b._gbdt.metrics]
    _store(out_len, len(names))
    _store(out_strs, names)
    return 0


@_capi
def LGBM_BoosterGetFeatureNames(handle, out_len, out_strs) -> int:
    names = _get(handle, _CBooster).b.feature_name()
    _store(out_len, len(names))
    _store(out_strs, names)
    return 0


@_capi
def LGBM_BoosterGetNumFeature(handle, out_len) -> int:
    _store(out_len, _get(handle, _CBooster).b.num_feature())
    return 0


@_capi
def LGBM_BoosterGetEval(handle, data_idx: int, out_len, out_results) -> int:
    """``data_idx`` 0 = train, 1.. = valid sets (c_api.h:765)."""
    b = _get(handle, _CBooster).b
    res = b.eval_train() if data_idx == 0 else None
    if data_idx > 0:
        allv = b.eval_valid()
        per = len(b._gbdt.metrics)
        res = allv[(data_idx - 1) * per: data_idx * per]
    vals = np.asarray([r[2] for r in res], np.float64)
    _store(out_len, len(vals))
    _store(out_results, vals)
    return 0


@_capi
def LGBM_BoosterGetNumPredict(handle, data_idx: int, out_len) -> int:
    cb = _get(handle, _CBooster)
    arr = cb.last_predict.get(int(data_idx))
    _store(out_len, 0 if arr is None else arr.size)
    return 0


@_capi
def LGBM_BoosterGetPredict(handle, data_idx: int, out_len,
                           out_result) -> int:
    """Raw scores for the given in-training dataset (0=train)."""
    cb = _get(handle, _CBooster)
    b = cb.b
    if data_idx == 0:
        arr = b._raw_train_score()
    else:
        arr = b._gbdt._valid_scores[data_idx - 1].cpu().numpy()
    arr = np.asarray(arr, np.float64).ravel()
    cb.last_predict[int(data_idx)] = arr
    _store(out_len, arr.size)
    _store(out_result, arr)
    return 0


def _predict_mat(cb: _CBooster, mat: np.ndarray, predict_type: int,
                 start_iteration: int, num_iteration: int,
                 parameter: str) -> np.ndarray:
    kw = _params_dict(parameter)
    ni = None if num_iteration <= 0 else int(num_iteration)
    out = cb.b.predict(
        mat, num_iteration=ni,
        raw_score=(predict_type == C_API_PREDICT_RAW_SCORE),
        pred_leaf=(predict_type == C_API_PREDICT_LEAF_INDEX),
        pred_contrib=(predict_type == C_API_PREDICT_CONTRIB),
        start_iteration=int(start_iteration), **kw)
    return np.asarray(out, np.float64)


@_capi
def LGBM_BoosterCalcNumPredict(handle, num_row: int, predict_type: int,
                               start_iteration: int, num_iteration: int,
                               out_len) -> int:
    """Reference: ``c_api.cpp LGBM_BoosterCalcNumPredict``."""
    g = _get(handle, _CBooster).b._gbdt
    k = g.config.num_class if g.config else g.num_tpi
    if predict_type == C_API_PREDICT_LEAF_INDEX:
        total = len(g.models)
        if num_iteration > 0:
            total = min(total, num_iteration * g.num_tpi)
        per = total
    elif predict_type == C_API_PREDICT_CONTRIB:
        per = k * (_get(handle, _CBooster).b.num_feature() + 1)
    else:
        per = k
    _store(out_len, int(num_row) * per)
    return 0


@_capi
def LGBM_BoosterPredictForMat(handle, data, data_type: int, nrow: int,
                              ncol: int, is_row_major: int,
                              predict_type: int, start_iteration: int,
                              num_iteration: int, parameter: str, out_len,
                              out_result) -> int:
    cb = _get(handle, _CBooster)
    mat = _as_matrix(data, nrow, ncol, data_type, is_row_major)
    out = _predict_mat(cb, mat, predict_type, start_iteration,
                       num_iteration, parameter)
    _store(out_len, out.size)
    _store(out_result, out)
    return 0


@_capi
def LGBM_BoosterPredictForMatSingleRow(handle, data, data_type: int,
                                       ncol: int, is_row_major: int,
                                       predict_type: int,
                                       start_iteration: int,
                                       num_iteration: int, parameter: str,
                                       out_len, out_result) -> int:
    return LGBM_BoosterPredictForMat(handle, data, data_type, 1, ncol,
                                     is_row_major, predict_type,
                                     start_iteration, num_iteration,
                                     parameter, out_len, out_result)


@_capi
def LGBM_BoosterPredictForMats(handle, nmat: int, data_list,
                               data_type: int, nrow_list, ncol: int,
                               predict_type: int, start_iteration: int,
                               num_iteration: int, parameter: str, out_len,
                               out_result) -> int:
    mats = [_as_matrix(d, int(nr), ncol, data_type, 1)
            for d, nr in zip(data_list, nrow_list)]
    return LGBM_BoosterPredictForMat(handle, np.concatenate(mats, 0),
                                     C_API_DTYPE_FLOAT64,
                                     sum(int(n) for n in nrow_list), ncol,
                                     1, predict_type, start_iteration,
                                     num_iteration, parameter, out_len,
                                     out_result)


@_capi
def LGBM_BoosterPredictForCSR(handle, indptr, indptr_type: int, indices,
                              data, data_type: int, nindptr: int,
                              nelem: int, num_col: int, predict_type: int,
                              start_iteration: int, num_iteration: int,
                              parameter: str, out_len, out_result) -> int:
    cb = _get(handle, _CBooster)
    # stays sparse: Booster.predict densifies in cell-bounded row blocks
    import scipy.sparse as sp
    mat = sp.csr_matrix(
        (np.asarray(data, np.float64), np.asarray(indices, np.int32),
         np.asarray(indptr, np.int64)),
        shape=(len(np.asarray(indptr)) - 1, int(num_col)))
    out = _predict_mat(cb, mat, predict_type, start_iteration,
                       num_iteration, parameter)
    _store(out_len, out.size)
    _store(out_result, out)
    return 0


@_capi
def LGBM_BoosterPredictForCSRSingleRow(handle, indptr, indptr_type: int,
                                       indices, data, data_type: int,
                                       nindptr: int, nelem: int,
                                       num_col: int, predict_type: int,
                                       start_iteration: int,
                                       num_iteration: int, parameter: str,
                                       out_len, out_result) -> int:
    return LGBM_BoosterPredictForCSR(handle, indptr, indptr_type, indices,
                                     data, data_type, nindptr, nelem,
                                     num_col, predict_type,
                                     start_iteration, num_iteration,
                                     parameter, out_len, out_result)


@_capi
def LGBM_BoosterPredictForCSC(handle, col_ptr, col_ptr_type: int, indices,
                              data, data_type: int, ncol_ptr: int,
                              nelem: int, num_row: int, predict_type: int,
                              start_iteration: int, num_iteration: int,
                              parameter: str, out_len, out_result) -> int:
    cb = _get(handle, _CBooster)
    import scipy.sparse as sp
    mat = sp.csc_matrix(
        (np.asarray(data, np.float64), np.asarray(indices, np.int32),
         np.asarray(col_ptr, np.int64)),
        shape=(int(num_row), len(np.asarray(col_ptr)) - 1)).tocsr()
    out = _predict_mat(cb, mat, predict_type, start_iteration,
                       num_iteration, parameter)
    _store(out_len, out.size)
    _store(out_result, out)
    return 0


@_capi
def LGBM_BoosterPredictForFile(handle, data_filename: str,
                               data_has_header: int, predict_type: int,
                               start_iteration: int, num_iteration: int,
                               parameter: str,
                               result_filename: str) -> int:
    """Reference: ``c_api.cpp LGBM_BoosterPredictForFile`` via Predictor."""
    from .io.text_loader import load_text
    cb = _get(handle, _CBooster)
    cfg = Config.from_params({**_params_dict(parameter),
                              "header": bool(data_has_header)})
    X, _, _, _, _ = load_text(str(data_filename), cfg)
    out = _predict_mat(cb, X, predict_type, start_iteration, num_iteration,
                       parameter)
    out2 = out.reshape(X.shape[0], -1)  # X may be sparse (LibSVM input)
    with open(str(result_filename), "w") as f:
        for row in out2:
            f.write("\t".join(repr(float(v)) for v in row) + "\n")
    return 0


@_capi
def LGBM_BoosterSaveModel(handle, start_iteration: int, num_iteration: int,
                          filename: str) -> int:
    b = _get(handle, _CBooster).b
    ni = None if num_iteration <= 0 else int(num_iteration)
    b.save_model(str(filename), num_iteration=ni,
                 start_iteration=int(start_iteration))
    return 0


@_capi
def LGBM_BoosterSaveModelToString(handle, start_iteration: int,
                                  num_iteration: int, buffer_len: int,
                                  out_len, out_str) -> int:
    b = _get(handle, _CBooster).b
    ni = None if num_iteration <= 0 else int(num_iteration)
    s = b.model_to_string(num_iteration=ni,
                          start_iteration=int(start_iteration))
    _store(out_len, len(s))
    _store(out_str, s)
    return 0


@_capi
def LGBM_BoosterDumpModel(handle, start_iteration: int, num_iteration: int,
                          buffer_len: int, out_len, out_str) -> int:
    b = _get(handle, _CBooster).b
    ni = None if num_iteration <= 0 else int(num_iteration)
    s = json.dumps(b.dump_model(num_iteration=ni,
                                start_iteration=int(start_iteration)))
    _store(out_len, len(s))
    _store(out_str, s)
    return 0


@_capi
def LGBM_BoosterGetLeafValue(handle, tree_idx: int, leaf_idx: int,
                             out_val) -> int:
    g = _get(handle, _CBooster).b._gbdt
    _store(out_val, float(g.models[int(tree_idx)].leaf_value[int(leaf_idx)]))
    return 0


@_capi
def LGBM_BoosterSetLeafValue(handle, tree_idx: int, leaf_idx: int,
                             val: float) -> int:
    g = _get(handle, _CBooster).b._gbdt
    g.models[int(tree_idx)].leaf_value[int(leaf_idx)] = float(val)
    _models_changed(g)
    return 0


@_capi
def LGBM_BoosterFeatureImportance(handle, num_iteration: int,
                                  importance_type: int,
                                  out_results) -> int:
    """``importance_type`` 0=split, 1=gain (c_api.h:1035)."""
    b = _get(handle, _CBooster).b
    kind = "gain" if importance_type == 1 else "split"
    ni = None if num_iteration <= 0 else int(num_iteration)
    imp = b.feature_importance(importance_type=kind, iteration=ni)
    _store(out_results, np.asarray(imp, np.float64))
    return 0


@_capi
def LGBM_BoosterRefit(handle, leaf_preds, nrow: int, ncol: int) -> int:
    """Reference: ``gbdt.cpp GBDT::RefitTree``: the leaf outputs estimated
    again on the attached training data.  As in the JAX package, the leaf
    of each row comes from a walk of the forest on the device
    (``GBDT.refit_models``), not from ``leaf_preds``: the same leaves in
    the supported use, ``predict(..., pred_leaf=True)`` on the training
    data."""
    b = _get(handle, _CBooster).b
    if b._gbdt.train_ds is None:
        raise LightGBMError("Refit requires a booster with training data")
    decay = float(getattr(b._gbdt.config, "refit_decay_rate", 0.9))
    b._gbdt.refit_models(decay)
    return 0


# ======================= Network functions ================================

@_capi
def LGBM_NetworkInit(machines: str, local_listen_port: int,
                     listen_time_out: int, num_machines: int) -> int:
    """Reference: ``c_api.cpp LGBM_NetworkInit`` -> ``Network::Init``.
    As ``Booster.set_network``: the topology is recorded
    (``parallel/mesh.py NETWORK``), and a parallel learner brings the
    process group up from it when it binds to data."""
    from .parallel import mesh as _mesh
    from .parallel.distributed import parse_machine_list
    hosts = parse_machine_list(str(machines),
                               default_port=int(local_listen_port))
    _mesh.NETWORK.update(machines=",".join(hosts),
                         local_listen_port=int(local_listen_port),
                         num_machines=int(num_machines),
                         time_out=int(listen_time_out))
    return 0


@_capi
def LGBM_NetworkFree() -> int:
    """As ``Booster.free_network``: the process group is shut down and
    the topology reset."""
    from .parallel.distributed import shutdown
    shutdown()
    return 0


@_capi
def LGBM_NetworkInitWithFunctions(num_machines: int, rank: int,
                                  reduce_scatter_ext_fun,
                                  allgather_ext_fun) -> int:
    """The rank and the world are recorded; the collectives are
    ``torch.distributed``'s, so the external functions go unused, as in
    the JAX package."""
    from .parallel import mesh as _mesh
    _mesh.NETWORK.update(num_machines=int(num_machines), rank=int(rank))
    return 0


__all__ = [n for n in dir() if n.startswith("LGBM_")] + [
    "Ref",
    "C_API_DTYPE_FLOAT32", "C_API_DTYPE_FLOAT64", "C_API_DTYPE_INT32",
    "C_API_DTYPE_INT64", "C_API_DTYPE_INT8",
    "C_API_PREDICT_NORMAL", "C_API_PREDICT_RAW_SCORE",
    "C_API_PREDICT_LEAF_INDEX", "C_API_PREDICT_CONTRIB",
]
