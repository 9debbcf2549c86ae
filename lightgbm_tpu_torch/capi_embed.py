"""The raw-pointer bridge of the loadable C ABI (counterpart of
lightgbm_tpu/capi_embed.py; ``native/capi_abi.c`` calls it).

``capi.py`` keeps the C API's contract over Python objects; this module
adapts it to raw pointers, so that the shared library can forward C
calls: every function takes addresses as ints (``intptr_t`` on the C
side), builds numpy views or ctypes slots over the caller's memory, and
returns the LGBM status int.

As in the reference, the caller owns and sizes every output buffer (a
prediction holds ``nrow x num_class`` doubles).
"""
from __future__ import annotations

import ctypes

import numpy as np

from . import capi


def _i32_slot(addr: int):
    return ctypes.cast(int(addr), ctypes.POINTER(ctypes.c_int32)).contents


def _i64_slot(addr: int):
    return ctypes.cast(int(addr), ctypes.POINTER(ctypes.c_int64)).contents


def _f64_view(addr: int, n: int):
    return np.ctypeslib.as_array(
        ctypes.cast(int(addr), ctypes.POINTER(ctypes.c_double)), (int(n),))


def _typed_view(addr: int, n: int, dtype_code: int):
    np_dtype = capi._NUMPY_OF_DTYPE[int(dtype_code)]
    ct = {np.float32: ctypes.c_float, np.float64: ctypes.c_double,
          np.int32: ctypes.c_int32, np.int64: ctypes.c_int64,
          np.int8: ctypes.c_int8}[np.dtype(np_dtype).type]
    return np.ctypeslib.as_array(
        ctypes.cast(int(addr), ctypes.POINTER(ct)), (int(n),))


def get_last_error() -> str:
    return capi.LGBM_GetLastError()


def dataset_create_from_file(filename: str, parameters: str,
                             ref_handle: int, out_addr: int) -> int:
    return capi.LGBM_DatasetCreateFromFile(
        filename, parameters, int(ref_handle) or None, _i64_slot(out_addr))


def dataset_create_from_mat(data_addr: int, data_type: int, nrow: int,
                            ncol: int, is_row_major: int, parameters: str,
                            ref_handle: int, out_addr: int) -> int:
    # COPY: the dataset outlives this call and the reference contract
    # lets the C caller free its buffer immediately after it returns
    data = _typed_view(data_addr, int(nrow) * int(ncol), data_type).copy()
    return capi.LGBM_DatasetCreateFromMat(
        data, data_type, nrow, ncol, is_row_major, parameters,
        int(ref_handle) or None, _i64_slot(out_addr))


def dataset_set_field(handle: int, name: str, data_addr: int,
                      num_element: int, dtype_code: int) -> int:
    # COPY: fields are retained by the dataset (see dataset_create_from_mat)
    view = _typed_view(data_addr, num_element, dtype_code).copy()
    return capi.LGBM_DatasetSetField(int(handle), name, view, num_element,
                                     dtype_code)


def dataset_get_num_data(handle: int, out_addr: int) -> int:
    return capi.LGBM_DatasetGetNumData(int(handle), _i32_slot(out_addr))


def dataset_get_num_feature(handle: int, out_addr: int) -> int:
    return capi.LGBM_DatasetGetNumFeature(int(handle), _i32_slot(out_addr))


def dataset_free(handle: int) -> int:
    return capi.LGBM_DatasetFree(int(handle))


def booster_create(train_handle: int, parameters: str,
                   out_addr: int) -> int:
    return capi.LGBM_BoosterCreate(int(train_handle), parameters,
                                   _i64_slot(out_addr))


def booster_create_from_modelfile(filename: str, out_iters_addr: int,
                                  out_addr: int) -> int:
    return capi.LGBM_BoosterCreateFromModelfile(
        filename, _i32_slot(out_iters_addr), _i64_slot(out_addr))


def booster_update_one_iter(handle: int, is_finished_addr: int) -> int:
    return capi.LGBM_BoosterUpdateOneIter(int(handle),
                                          _i32_slot(is_finished_addr))


def booster_get_current_iteration(handle: int, out_addr: int) -> int:
    return capi.LGBM_BoosterGetCurrentIteration(int(handle),
                                                _i32_slot(out_addr))


def booster_save_model(handle: int, start_iteration: int,
                       num_iteration: int, filename: str) -> int:
    return capi.LGBM_BoosterSaveModel(int(handle), start_iteration,
                                      num_iteration, filename)


def booster_predict_for_mat(handle: int, data_addr: int, data_type: int,
                            nrow: int, ncol: int, is_row_major: int,
                            predict_type: int, start_iteration: int,
                            num_iteration: int, parameter: str,
                            out_len_addr: int, out_addr: int) -> int:
    try:
        cb = capi._get(int(handle), capi._CBooster)
        data = _typed_view(data_addr, int(nrow) * int(ncol), data_type)
        mat = capi._as_matrix(data, nrow, ncol, data_type, is_row_major)
        out = capi._predict_mat(cb, mat, predict_type, start_iteration,
                                num_iteration, parameter)
        _i64_slot(out_len_addr).value = out.size
        _f64_view(out_addr, out.size)[:] = out.ravel()
        return 0
    except Exception as e:  # C boundary: status code + last-error
        return capi._set_err(f"{type(e).__name__}: {e}")


def booster_free(handle: int) -> int:
    return capi.LGBM_BoosterFree(int(handle))
