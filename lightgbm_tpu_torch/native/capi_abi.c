/* The loadable C ABI of lightgbm_tpu_torch: LightGBM's liblightgbm
 * symbols (include/LightGBM/c_api.h) as a shared library (counterpart of
 * lightgbm_tpu/native/capi_abi.c).
 *
 * The library embeds CPython and forwards each export to
 * lightgbm_tpu_torch.capi (the reference's handle, status and last-error
 * contract) through the pointer bridge lightgbm_tpu_torch/capi_embed.py;
 * training and prediction then run on the card through the port's CUDA
 * kernels (device_type=cpu in the parameter string: on the CPU).  The
 * exports here are the core set (datasets from files and matrices,
 * fields, boosting, prediction, model files); the rest of the C API is
 * callable from Python through lightgbm_tpu_torch.capi.
 *
 * Built by lightgbm_tpu_torch/native/__init__.py capi_abi_lib() with gcc
 * against libpython3.12 into build/.  A program linking it needs
 * PYTHONPATH to hold the repository root and the site-packages that
 * hold torch and numpy.
 */
#include <Python.h>
#include <pthread.h>
#include <stdarg.h>
#include <stdint.h>
#include <string.h>

static PyObject *g_bridge = NULL;
static pthread_mutex_t g_init_lock = PTHREAD_MUTEX_INITIALIZER;
/* thread-local, matching the reference's thread-local last-error
 * (c_api.cpp): concurrent marshalling failures never cross-wire */
static __thread char g_err[4096] = "lightgbm_tpu_torch C ABI: not initialized";
static __thread int g_err_native = 1;  /* g_err holds the live error */

static void capture_pyerr(const char *where) {
    PyObject *etype = NULL, *eval = NULL, *etb = NULL;
    PyErr_Fetch(&etype, &eval, &etb);
    const char *detail = "";
    PyObject *s = eval ? PyObject_Str(eval) : NULL;
    if (s) detail = PyUnicode_AsUTF8(s);
    snprintf(g_err, sizeof(g_err), "bridge failure in %s: %s", where,
             detail ? detail : "");
    g_err_native = 1;
    Py_XDECREF(s);
    Py_XDECREF(etype);
    Py_XDECREF(eval);
    Py_XDECREF(etb);
}

static int ensure(void) {
    if (g_bridge) return 0;
    /* serialize first-call init: a second thread running
     * PyEval_SaveThread without the GIL is a CPython fatal abort */
    pthread_mutex_lock(&g_init_lock);
    if (g_bridge) {
        pthread_mutex_unlock(&g_init_lock);
        return 0;
    }
    if (!Py_IsInitialized()) {
        Py_InitializeEx(0);
        /* release the GIL the init acquired, or every other thread's
         * PyGILState_Ensure deadlocks (the reference library is
         * multithread-callable; so is this one) */
        PyEval_SaveThread();
    }
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject *m = PyImport_ImportModule("lightgbm_tpu_torch.capi_embed");
    if (!m) {
        capture_pyerr("import lightgbm_tpu_torch.capi_embed "
                      "(is PYTHONPATH set to the repository root?)");
        PyGILState_Release(st);
        pthread_mutex_unlock(&g_init_lock);
        return -1;
    }
    g_bridge = m;
    PyGILState_Release(st);
    pthread_mutex_unlock(&g_init_lock);
    return 0;
}

/* Call bridge.<name>(<args built from fmt>) -> int status. */
static int callf(const char *name, const char *fmt, ...) {
    if (ensure()) return -1;
    PyGILState_STATE st = PyGILState_Ensure();
    va_list va;
    va_start(va, fmt);
    PyObject *args = Py_VaBuildValue(fmt, va);
    va_end(va);
    int rc = -1;
    if (args) {
        PyObject *fn = PyObject_GetAttrString(g_bridge, name);
        if (fn) {
            PyObject *r = PyObject_CallObject(fn, args);
            if (r) {
                rc = (int)PyLong_AsLong(r);
                Py_DECREF(r);
                g_err_native = 0;  /* bridge-level error state applies */
            } else {
                capture_pyerr(name);
            }
            Py_DECREF(fn);
        } else {
            capture_pyerr(name);
        }
        Py_DECREF(args);
    } else {
        capture_pyerr(name);
    }
    PyGILState_Release(st);
    return rc;
}

#define H(x) ((long long)(intptr_t)(x))
#define EXPORT __attribute__((visibility("default")))

EXPORT const char *LGBM_GetLastError(void) {
    if (ensure()) return g_err;
    if (g_err_native) return g_err;  /* marshalling-layer failure */
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject *fn = PyObject_GetAttrString(g_bridge, "get_last_error");
    if (fn) {
        PyObject *r = PyObject_CallObject(fn, NULL);
        if (r) {
            const char *s = PyUnicode_AsUTF8(r);
            if (s) {
                strncpy(g_err, s, sizeof(g_err) - 1);
                g_err[sizeof(g_err) - 1] = '\0';
            }
            Py_DECREF(r);
        }
        Py_DECREF(fn);
    }
    PyGILState_Release(st);
    return g_err;
}

EXPORT int LGBM_DatasetCreateFromFile(const char *filename,
                                      const char *parameters,
                                      const void *reference, void **out) {
    return callf("dataset_create_from_file", "(ssLL)", filename, parameters,
                 H(reference), H(out));
}

EXPORT int LGBM_DatasetCreateFromMat(const void *data, int data_type,
                                     int32_t nrow, int32_t ncol,
                                     int is_row_major,
                                     const char *parameters,
                                     const void *reference, void **out) {
    return callf("dataset_create_from_mat", "(LiiiisLL)", H(data), data_type,
                 (int)nrow, (int)ncol, is_row_major, parameters,
                 H(reference), H(out));
}

EXPORT int LGBM_DatasetSetField(void *handle, const char *field_name,
                                const void *field_data, int num_element,
                                int type) {
    return callf("dataset_set_field", "(LsLii)", H(handle), field_name,
                 H(field_data), num_element, type);
}

EXPORT int LGBM_DatasetGetNumData(void *handle, int32_t *out) {
    return callf("dataset_get_num_data", "(LL)", H(handle), H(out));
}

EXPORT int LGBM_DatasetGetNumFeature(void *handle, int32_t *out) {
    return callf("dataset_get_num_feature", "(LL)", H(handle), H(out));
}

EXPORT int LGBM_DatasetFree(void *handle) {
    return callf("dataset_free", "(L)", H(handle));
}

EXPORT int LGBM_BoosterCreate(const void *train_data,
                              const char *parameters, void **out) {
    return callf("booster_create", "(LsL)", H(train_data), parameters,
                 H(out));
}

EXPORT int LGBM_BoosterCreateFromModelfile(const char *filename,
                                           int32_t *out_num_iterations,
                                           void **out) {
    return callf("booster_create_from_modelfile", "(sLL)", filename,
                 H(out_num_iterations), H(out));
}

EXPORT int LGBM_BoosterUpdateOneIter(void *handle, int *is_finished) {
    return callf("booster_update_one_iter", "(LL)", H(handle),
                 H(is_finished));
}

EXPORT int LGBM_BoosterGetCurrentIteration(void *handle,
                                           int32_t *out_iteration) {
    return callf("booster_get_current_iteration", "(LL)", H(handle),
                 H(out_iteration));
}

EXPORT int LGBM_BoosterSaveModel(void *handle, int start_iteration,
                                 int num_iteration, const char *filename) {
    return callf("booster_save_model", "(Liis)", H(handle), start_iteration,
                 num_iteration, filename);
}

EXPORT int LGBM_BoosterPredictForMat(void *handle, const void *data,
                                     int data_type, int32_t nrow,
                                     int32_t ncol, int is_row_major,
                                     int predict_type, int start_iteration,
                                     int num_iteration,
                                     const char *parameter,
                                     int64_t *out_len, double *out_result) {
    return callf("booster_predict_for_mat", "(LLiiiiiiisLL)", H(handle),
                 H(data), data_type, (int)nrow, (int)ncol, is_row_major,
                 predict_type, start_iteration, num_iteration, parameter,
                 H(out_len), H(out_result));
}

EXPORT int LGBM_BoosterFree(void *handle) {
    return callf("booster_free", "(L)", H(handle));
}
