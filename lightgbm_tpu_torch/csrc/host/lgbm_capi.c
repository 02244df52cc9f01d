/* C API shim of the PyTorch port: the reference's FFI surface
 * (include/LightGBM/c_api.h:60-607), the 40 LGBM_* entry points, over
 * lightgbm_tpu_torch's Booster and Dataset through an embedded Python
 * interpreter.  The port's copy of src/capi/lgbm_capi.c.
 *
 * Design: this file only marshals.  Every LGBM_* entry point forwards
 * its scalar arguments, with pointers passed as integer addresses, to
 * lightgbm_tpu_torch.capi_impl, which does the work and writes results
 * straight into the caller's buffers through ctypes.  Handles are
 * integer ids into a Python-side registry (the reference's opaque
 * DatasetHandle/BoosterHandle, c_api.cpp:28-232).  Errors set a
 * process-wide message returned by LGBM_GetLastError (the reference's
 * thread-local string, c_api.cpp:270).
 *
 * Works both loaded into a running Python process (ctypes, like the
 * reference's own tests/c_api_test/test.py) and from a plain C host,
 * where the first call initializes the interpreter; the build
 * (ops/_build.build_host("capi")) links libpython only where the
 * interpreter has it as a shared library.
 */

#include <Python.h>

#include <stdarg.h>
#include <stdint.h>
#include <stdio.h>
#include <string.h>

#define DllExport __attribute__((visibility("default")))

typedef void *DatasetHandle;
typedef void *BoosterHandle;

static char g_last_error[4096] = "everything is fine";
static PyObject *g_impl = NULL; /* lightgbm_tpu_torch.capi_impl */

static void set_last_error(const char *msg) {
  snprintf(g_last_error, sizeof(g_last_error), "%s", msg);
}

DllExport const char *LGBM_GetLastError() { return g_last_error; }

/* The checkout's root, set at build time, so a plain-C host finds the
 * package without PYTHONPATH. */
#ifndef LGBM_TPU_ROOT
#define LGBM_TPU_ROOT ""
#endif

static int ensure_impl(void) {
  if (g_impl != NULL) return 0;
  if (!Py_IsInitialized()) {
    Py_InitializeEx(0);
    /* release the GIL the initializing thread holds, so OTHER host
     * threads' PyGILState_Ensure calls don't deadlock; all access below
     * goes through the GILState API */
    PyEval_SaveThread();
  }
  PyGILState_STATE st = PyGILState_Ensure();
  int rc = -1;
  PyObject *sys_path = NULL, *root = NULL;
  if (strlen(LGBM_TPU_ROOT) > 0) {
    sys_path = PySys_GetObject("path"); /* borrowed */
    root = PyUnicode_FromString(LGBM_TPU_ROOT);
    if (sys_path && root && !PySequence_Contains(sys_path, root)) {
      PyList_Insert(sys_path, 0, root);
    }
    Py_XDECREF(root);
  }
  g_impl = PyImport_ImportModule("lightgbm_tpu_torch.capi_impl");
  if (g_impl == NULL) {
    PyObject *t, *v, *tb;
    PyErr_Fetch(&t, &v, &tb);
    PyObject *s = v ? PyObject_Str(v) : NULL;
    set_last_error(s ? PyUnicode_AsUTF8(s) : "capi_impl import failed");
    Py_XDECREF(s);
    Py_XDECREF(t);
    Py_XDECREF(v);
    Py_XDECREF(tb);
  } else {
    rc = 0;
  }
  PyGILState_Release(st);
  return rc;
}

/* Call capi_impl.<name>(*args built from fmt).  The Python function
 * returns None/int on success; an exception becomes -1 + last error. */
static int lgbm_call(const char *name, const char *fmt, ...) {
  if (ensure_impl() != 0) return -1;
  PyGILState_STATE st = PyGILState_Ensure();
  int rc = -1;
  va_list va;
  va_start(va, fmt);
  PyObject *args = Py_VaBuildValue(fmt, va);
  va_end(va);
  if (args != NULL) {
    if (!PyTuple_Check(args)) { /* single-arg fmt yields a bare object */
      PyObject *t = PyTuple_Pack(1, args);
      Py_DECREF(args);
      args = t;
    }
  }
  PyObject *fn = args ? PyObject_GetAttrString(g_impl, name) : NULL;
  PyObject *res = fn ? PyObject_Call(fn, args, NULL) : NULL;
  if (res != NULL) {
    rc = 0;
  } else {
    PyObject *t, *v, *tb;
    PyErr_Fetch(&t, &v, &tb);
    PyObject *s = v ? PyObject_Str(v) : NULL;
    set_last_error(s ? PyUnicode_AsUTF8(s) : "unknown exception");
    Py_XDECREF(s);
    Py_XDECREF(t);
    Py_XDECREF(v);
    Py_XDECREF(tb);
  }
  Py_XDECREF(res);
  Py_XDECREF(fn);
  Py_XDECREF(args);
  PyGILState_Release(st);
  return rc;
}

#define ADDR(p) ((long long)(intptr_t)(p))

/* ------------------------------------------------------------ dataset */

DllExport int LGBM_DatasetCreateFromFile(const char *filename,
                                         const char *parameters,
                                         const DatasetHandle reference,
                                         DatasetHandle *out) {
  return lgbm_call("dataset_create_from_file", "(ssLL)", filename, parameters,
                   ADDR(reference), ADDR(out));
}

DllExport int LGBM_DatasetCreateFromMat(const void *data, int data_type,
                                        int32_t nrow, int32_t ncol,
                                        int is_row_major,
                                        const char *parameters,
                                        const DatasetHandle reference,
                                        DatasetHandle *out) {
  return lgbm_call("dataset_create_from_mat", "(LiiiisLL)", ADDR(data),
                   data_type, (int)nrow, (int)ncol, is_row_major, parameters,
                   ADDR(reference), ADDR(out));
}

DllExport int LGBM_DatasetCreateFromCSR(const void *indptr, int indptr_type,
                                        const int32_t *indices,
                                        const void *data, int data_type,
                                        int64_t nindptr, int64_t nelem,
                                        int64_t num_col,
                                        const char *parameters,
                                        const DatasetHandle reference,
                                        DatasetHandle *out) {
  return lgbm_call("dataset_create_from_csr", "(LiLLiLLLsLL)", ADDR(indptr),
                   indptr_type, ADDR(indices), ADDR(data), data_type,
                   (long long)nindptr, (long long)nelem, (long long)num_col,
                   parameters, ADDR(reference), ADDR(out));
}

DllExport int LGBM_DatasetCreateFromCSC(const void *col_ptr, int col_ptr_type,
                                        const int32_t *indices,
                                        const void *data, int data_type,
                                        int64_t ncol_ptr, int64_t nelem,
                                        int64_t num_row,
                                        const char *parameters,
                                        const DatasetHandle reference,
                                        DatasetHandle *out) {
  return lgbm_call("dataset_create_from_csc", "(LiLLiLLLsLL)", ADDR(col_ptr),
                   col_ptr_type, ADDR(indices), ADDR(data), data_type,
                   (long long)ncol_ptr, (long long)nelem, (long long)num_row,
                   parameters, ADDR(reference), ADDR(out));
}

DllExport int LGBM_DatasetGetSubset(const DatasetHandle handle,
                                    const int32_t *used_row_indices,
                                    int32_t num_used_row_indices,
                                    const char *parameters,
                                    DatasetHandle *out) {
  return lgbm_call("dataset_get_subset", "(LLisL)", ADDR(handle),
                   ADDR(used_row_indices), (int)num_used_row_indices,
                   parameters, ADDR(out));
}

DllExport int LGBM_DatasetSetFeatureNames(DatasetHandle handle,
                                          const char **feature_names,
                                          int64_t num_feature_names) {
  return lgbm_call("dataset_set_feature_names", "(LLL)", ADDR(handle),
                   ADDR(feature_names), (long long)num_feature_names);
}

DllExport int LGBM_DatasetGetFeatureNames(DatasetHandle handle,
                                          char **feature_names,
                                          int64_t *num_feature_names) {
  return lgbm_call("dataset_get_feature_names", "(LLL)", ADDR(handle),
                   ADDR(feature_names), ADDR(num_feature_names));
}

DllExport int LGBM_DatasetSetField(DatasetHandle handle,
                                   const char *field_name,
                                   const void *field_data,
                                   int64_t num_element, int type) {
  return lgbm_call("dataset_set_field", "(LsLLi)", ADDR(handle), field_name,
                   ADDR(field_data), (long long)num_element, type);
}

DllExport int LGBM_DatasetGetField(DatasetHandle handle,
                                   const char *field_name, int64_t *out_len,
                                   const void **out_ptr, int *out_type) {
  return lgbm_call("dataset_get_field", "(LsLLL)", ADDR(handle), field_name,
                   ADDR(out_len), ADDR(out_ptr), ADDR(out_type));
}

DllExport int LGBM_DatasetGetNumData(DatasetHandle handle, int64_t *out) {
  return lgbm_call("dataset_get_num_data", "(LL)", ADDR(handle), ADDR(out));
}

DllExport int LGBM_DatasetGetNumFeature(DatasetHandle handle, int64_t *out) {
  return lgbm_call("dataset_get_num_feature", "(LL)", ADDR(handle), ADDR(out));
}

DllExport int LGBM_DatasetSaveBinary(DatasetHandle handle,
                                     const char *filename) {
  return lgbm_call("dataset_save_binary", "(Ls)", ADDR(handle), filename);
}

DllExport int LGBM_DatasetFree(DatasetHandle handle) {
  return lgbm_call("free_handle", "(L)", ADDR(handle));
}

/* ------------------------------------------------------------ booster */

DllExport int LGBM_BoosterCreate(const DatasetHandle train_data,
                                 const char *parameters, BoosterHandle *out) {
  return lgbm_call("booster_create", "(LsL)", ADDR(train_data), parameters,
                   ADDR(out));
}

DllExport int LGBM_BoosterCreateFromModelfile(const char *filename,
                                              int64_t *out_num_iterations,
                                              BoosterHandle *out) {
  return lgbm_call("booster_create_from_modelfile", "(sLL)", filename,
                   ADDR(out_num_iterations), ADDR(out));
}

DllExport int LGBM_BoosterFree(BoosterHandle handle) {
  return lgbm_call("free_handle", "(L)", ADDR(handle));
}

DllExport int LGBM_BoosterMerge(BoosterHandle handle,
                                BoosterHandle other_handle) {
  return lgbm_call("booster_merge", "(LL)", ADDR(handle), ADDR(other_handle));
}

DllExport int LGBM_BoosterResetTrainingData(BoosterHandle handle,
                                            const DatasetHandle train_data) {
  return lgbm_call("booster_reset_training_data", "(LL)", ADDR(handle),
                   ADDR(train_data));
}

DllExport int LGBM_BoosterResetParameter(BoosterHandle handle,
                                         const char *parameters) {
  return lgbm_call("booster_reset_parameter", "(Ls)", ADDR(handle),
                   parameters);
}

DllExport int LGBM_BoosterUpdateOneIterCustom(BoosterHandle handle,
                                              const float *grad,
                                              const float *hess,
                                              int *is_finished) {
  return lgbm_call("booster_update_one_iter_custom", "(LLLL)", ADDR(handle),
                   ADDR(grad), ADDR(hess), ADDR(is_finished));
}

DllExport int LGBM_BoosterGetNumPredict(BoosterHandle handle, int data_idx,
                                        int64_t *out_len) {
  return lgbm_call("booster_get_num_predict", "(LiL)", ADDR(handle), data_idx,
                   ADDR(out_len));
}

DllExport int LGBM_BoosterGetPredict(BoosterHandle handle, int data_idx,
                                     int64_t *out_len, double *out_result) {
  return lgbm_call("booster_get_predict", "(LiLL)", ADDR(handle), data_idx,
                   ADDR(out_len), ADDR(out_result));
}

DllExport int LGBM_BoosterCalcNumPredict(BoosterHandle handle, int64_t num_row,
                                         int predict_type,
                                         int64_t num_iteration,
                                         int64_t *out_len) {
  return lgbm_call("booster_calc_num_predict", "(LLiLL)", ADDR(handle),
                   (long long)num_row, predict_type,
                   (long long)num_iteration, ADDR(out_len));
}

DllExport int LGBM_BoosterPredictForCSR(BoosterHandle handle,
                                        const void *indptr, int indptr_type,
                                        const int32_t *indices,
                                        const void *data, int data_type,
                                        int64_t nindptr, int64_t nelem,
                                        int64_t num_col, int predict_type,
                                        int64_t num_iteration,
                                        int64_t *out_len, double *out_result) {
  return lgbm_call("booster_predict_for_csr", "(LLiLLiLLLiLLL)", ADDR(handle),
                   ADDR(indptr), indptr_type, ADDR(indices), ADDR(data),
                   data_type, (long long)nindptr, (long long)nelem,
                   (long long)num_col, predict_type, (long long)num_iteration,
                   ADDR(out_len), ADDR(out_result));
}

DllExport int LGBM_BoosterPredictForCSC(BoosterHandle handle,
                                        const void *col_ptr, int col_ptr_type,
                                        const int32_t *indices,
                                        const void *data, int data_type,
                                        int64_t ncol_ptr, int64_t nelem,
                                        int64_t num_row, int predict_type,
                                        int64_t num_iteration,
                                        int64_t *out_len, double *out_result) {
  return lgbm_call("booster_predict_for_csc", "(LLiLLiLLLiLLL)", ADDR(handle),
                   ADDR(col_ptr), col_ptr_type, ADDR(indices), ADDR(data),
                   data_type, (long long)ncol_ptr, (long long)nelem,
                   (long long)num_row, predict_type, (long long)num_iteration,
                   ADDR(out_len), ADDR(out_result));
}

DllExport int LGBM_BoosterDumpModel(BoosterHandle handle, int num_iteration,
                                    int buffer_len, int64_t *out_len,
                                    char *out_str) {
  return lgbm_call("booster_dump_model", "(LiiLL)", ADDR(handle),
                   num_iteration, buffer_len, ADDR(out_len), ADDR(out_str));
}

DllExport int LGBM_BoosterGetLeafValue(BoosterHandle handle, int tree_idx,
                                       int leaf_idx, double *out_val) {
  return lgbm_call("booster_get_leaf_value", "(LiiL)", ADDR(handle), tree_idx,
                   leaf_idx, ADDR(out_val));
}

DllExport int LGBM_BoosterSetLeafValue(BoosterHandle handle, int tree_idx,
                                       int leaf_idx, double val) {
  return lgbm_call("booster_set_leaf_value", "(Liid)", ADDR(handle), tree_idx,
                   leaf_idx, val);
}

DllExport int LGBM_BoosterAddValidData(BoosterHandle handle,
                                       const DatasetHandle valid_data) {
  return lgbm_call("booster_add_valid_data", "(LL)", ADDR(handle),
                   ADDR(valid_data));
}

DllExport int LGBM_BoosterUpdateOneIter(BoosterHandle handle,
                                        int *is_finished) {
  return lgbm_call("booster_update_one_iter", "(LL)", ADDR(handle),
                   ADDR(is_finished));
}

DllExport int LGBM_BoosterRollbackOneIter(BoosterHandle handle) {
  return lgbm_call("booster_rollback_one_iter", "(L)", ADDR(handle));
}

DllExport int LGBM_BoosterGetCurrentIteration(BoosterHandle handle,
                                              int64_t *out_iteration) {
  return lgbm_call("booster_get_current_iteration", "(LL)", ADDR(handle),
                   ADDR(out_iteration));
}

DllExport int LGBM_BoosterGetNumClasses(BoosterHandle handle,
                                        int64_t *out_len) {
  return lgbm_call("booster_get_num_classes", "(LL)", ADDR(handle),
                   ADDR(out_len));
}

DllExport int LGBM_BoosterGetEvalCounts(BoosterHandle handle,
                                        int64_t *out_len) {
  return lgbm_call("booster_get_eval_counts", "(LL)", ADDR(handle),
                   ADDR(out_len));
}

DllExport int LGBM_BoosterGetEvalNames(BoosterHandle handle, int64_t *out_len,
                                       char **out_strs) {
  return lgbm_call("booster_get_eval_names", "(LLL)", ADDR(handle),
                   ADDR(out_len), ADDR(out_strs));
}

DllExport int LGBM_BoosterGetEval(BoosterHandle handle, int data_idx,
                                  int64_t *out_len, double *out_results) {
  return lgbm_call("booster_get_eval", "(LiLL)", ADDR(handle), data_idx,
                   ADDR(out_len), ADDR(out_results));
}

DllExport int LGBM_BoosterPredictForMat(BoosterHandle handle, const void *data,
                                        int data_type, int32_t nrow,
                                        int32_t ncol, int is_row_major,
                                        int predict_type, int64_t num_iteration,
                                        int64_t *out_len, double *out_result) {
  return lgbm_call("booster_predict_for_mat", "(LLiiiiiLLL)", ADDR(handle),
                   ADDR(data), data_type, (int)nrow, (int)ncol, is_row_major,
                   predict_type, (long long)num_iteration, ADDR(out_len),
                   ADDR(out_result));
}

DllExport int LGBM_BoosterPredictForFile(BoosterHandle handle,
                                         const char *data_filename,
                                         int data_has_header, int predict_type,
                                         int64_t num_iteration,
                                         const char *result_filename) {
  return lgbm_call("booster_predict_for_file", "(LsiiLs)", ADDR(handle),
                   data_filename, data_has_header, predict_type,
                   (long long)num_iteration, result_filename);
}

DllExport int LGBM_BoosterSaveModel(BoosterHandle handle, int num_iteration,
                                    const char *filename) {
  return lgbm_call("booster_save_model", "(Lis)", ADDR(handle), num_iteration,
                   filename);
}
