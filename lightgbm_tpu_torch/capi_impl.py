"""Python side of the port's C API shim (``csrc/host/lgbm_capi.c``).

Counterpart of lightgbm_tpu/capi_impl.py: the reference's ``LGBM_*``
semantics (include/LightGBM/c_api.h:60-607, src/c_api.cpp) over the
port's ``Booster`` and ``Dataset``.  Handles are integer ids in a
registry; caller buffers are read and written through ctypes at the raw
addresses the C layer forwards.  The shim holds the interpreter lock for
each call, which serializes mutations as the reference Booster's mutex
does (c_api.cpp:231).

The device is the card: ``LGBM_CAPI_PLATFORM`` (read at each call)
``cuda`` or unset resolves it through ``backend.resolve_device``, which
raises without one (the message then comes back through
``LGBM_GetLastError``); ``cpu`` selects the CPU.  There is no probe and no
silent fallback to the CPU.

``library_path()`` builds the shim (``build/native/lib_lightgbm_tpu_torch
.so``) and returns its path, for a host that loads it with ctypes.
"""

from __future__ import annotations

import ctypes
import json
import os
from typing import Any, Dict, List

import numpy as np
import torch

from .backend import resolve_device
from .basic import Booster, Dataset, LightGBMError
from .config import key_alias_transform

# c_api.h:32-39
_DTYPE_F32, _DTYPE_F64, _DTYPE_I32, _DTYPE_I64 = 0, 1, 2, 3
_PREDICT_NORMAL, _PREDICT_RAW, _PREDICT_LEAF = 0, 1, 2

_NP_OF_DTYPE = {
    _DTYPE_F32: np.float32,
    _DTYPE_F64: np.float64,
    _DTYPE_I32: np.int32,
    _DTYPE_I64: np.int64,
}

_registry: Dict[int, Any] = {}
_next_id = [1]
# per-handle keep-alive store for LGBM_DatasetGetField out pointers
_field_cache: Dict[int, Dict[str, np.ndarray]] = {}


def library_path() -> str:
    """The shim, built from ``csrc/host/lgbm_capi.c`` if needed."""
    from .ops import _build

    return _build.build_host("capi")


def _device() -> torch.device:
    """``LGBM_CAPI_PLATFORM``: ``cpu``, or ``cuda`` / unset for the card."""
    try:
        return resolve_device(os.environ.get("LGBM_CAPI_PLATFORM") or None)
    except RuntimeError as e:
        raise RuntimeError(f"{e} (through the C API: set "
                           "LGBM_CAPI_PLATFORM=cpu)") from None


def _register(obj: Any) -> int:
    h = _next_id[0]
    _next_id[0] += 1
    _registry[h] = obj
    return h


def _get(handle: int):
    try:
        return _registry[handle]
    except KeyError:
        raise LightGBMError(f"invalid handle {handle}") from None


def _write_i64(addr: int, value: int) -> None:
    ctypes.c_int64.from_address(addr).value = int(value)


def _write_i32(addr: int, value: int) -> None:
    ctypes.c_int32.from_address(addr).value = int(value)


def _write_ptr(addr: int, value: int) -> None:
    ctypes.c_void_p.from_address(addr).value = int(value)


def _read_array(addr: int, count: int, dtype) -> np.ndarray:
    n = int(count)
    if n < 0:
        raise LightGBMError(f"negative element count {n}")
    buf = (ctypes.c_char * (n * np.dtype(dtype).itemsize)).from_address(addr)
    return np.frombuffer(buf, dtype=dtype, count=n).copy()


def _write_array(addr: int, arr: np.ndarray) -> None:
    arr = np.ascontiguousarray(arr)
    ctypes.memmove(addr, arr.ctypes.data, arr.nbytes)


def _params_dict(parameters: str) -> Dict[str, str]:
    """The CLI's key=value string form (Str2Map, c_api.cpp:36)."""
    out: Dict[str, str] = {}
    for tok in (parameters or "").split():
        if "=" in tok:
            k, v = tok.split("=", 1)
            out[k] = v
    return key_alias_transform(out)


def _write_string_array(addr: int, names) -> None:
    """Write strings into a caller-allocated char*[] (the reference's
    GetEvalNames/GetFeatureNames out convention)."""
    ptrs = _read_array(addr, len(names), np.int64)
    for p, name in zip(ptrs, names):
        raw = name.encode() + b"\0"
        ctypes.memmove(int(p), raw, len(raw))


def _read_matrix(addr, data_type, nrow, ncol, is_row_major) -> np.ndarray:
    X = _read_array(addr, nrow * ncol, _NP_OF_DTYPE[data_type])
    X = X.reshape((nrow, ncol) if is_row_major else (ncol, nrow))
    return np.asarray(X if is_row_major else X.T, np.float64)


def _read_sparse_csr(ptr_addr, ptr_type, indices_addr, data_addr, data_type,
                     nptr, nelem, other_dim, order):
    """Rebuild a scipy matrix from caller CSR/CSC buffers; returns CSR."""
    import scipy.sparse as sp

    ptr = _read_array(ptr_addr, nptr, _NP_OF_DTYPE[ptr_type]).astype(np.int64)
    indices = _read_array(indices_addr, nelem, np.int32)
    values = _read_array(data_addr, nelem, _NP_OF_DTYPE[data_type]).astype(
        np.float64)
    if order == "csr":
        return sp.csr_matrix((values, indices, ptr),
                             shape=(int(nptr) - 1, int(other_dim)))
    return sp.csc_matrix((values, indices, ptr),
                         shape=(int(other_dim), int(nptr) - 1)).tocsr()


def free_handle(handle: int) -> None:
    _registry.pop(handle, None)
    _field_cache.pop(handle, None)


# ------------------------------------------------------------------ dataset
def _new_dataset(data, n_rows, parameters, reference, out_addr) -> None:
    """A dataset built now, aligned to ``reference``; in-memory data gets
    zero labels, to be set with LGBM_DatasetSetField before training
    (c_api.cpp:292-340)."""
    ref = _get(reference) if reference else None
    label = None if isinstance(data, str) else np.zeros(n_rows, np.float32)
    ds = Dataset(data, label=label, reference=ref,
                 params=_params_dict(parameters), device=_device())
    ds.construct()
    _write_ptr(out_addr, _register(ds))


def dataset_create_from_file(filename, parameters, reference, out_addr):
    _new_dataset(filename, 0, parameters, reference, out_addr)


def dataset_create_from_mat(data_addr, data_type, nrow, ncol, is_row_major,
                            parameters, reference, out_addr):
    X = _read_matrix(data_addr, data_type, nrow, ncol, is_row_major)
    _new_dataset(X, nrow, parameters, reference, out_addr)


def dataset_create_from_csr(indptr_addr, indptr_type, indices_addr, data_addr,
                            data_type, nindptr, nelem, num_col, parameters,
                            reference, out_addr):
    csr = _read_sparse_csr(indptr_addr, indptr_type, indices_addr, data_addr,
                           data_type, nindptr, nelem, num_col, "csr")
    _new_dataset(csr, csr.shape[0], parameters, reference, out_addr)


def dataset_create_from_csc(col_ptr_addr, col_ptr_type, indices_addr,
                            data_addr, data_type, ncol_ptr, nelem, num_row,
                            parameters, reference, out_addr):
    csr = _read_sparse_csr(col_ptr_addr, col_ptr_type, indices_addr,
                           data_addr, data_type, ncol_ptr, nelem, num_row,
                           "csc")
    _new_dataset(csr, csr.shape[0], parameters, reference, out_addr)


def dataset_set_field(handle, field_name, data_addr, num_element, dtype):
    ds: Dataset = _get(handle)
    ds.set_field(field_name,
                 _read_array(data_addr, num_element, _NP_OF_DTYPE[dtype]))
    _field_cache.pop(handle, None)


def dataset_get_field(handle, field_name, out_len_addr, out_ptr_addr,
                      out_type_addr):
    ds: Dataset = _get(handle)
    val = ds.get_field(field_name)
    if val is None:
        raise LightGBMError(f"field {field_name} is empty")
    if field_name in ("group", "query"):
        # the reference hands out query BOUNDARIES (num_queries + 1,
        # dataset.cpp GetIntField); the port stores sizes
        sizes = np.ascontiguousarray(val, dtype=np.int64)
        arr = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
        out_type = _DTYPE_I32
    else:
        arr = np.ascontiguousarray(val, dtype=np.float32)
        out_type = _DTYPE_F32
    # the pointer must outlive the call (the reference hands out its
    # vectors' storage): kept per handle and field
    _field_cache.setdefault(handle, {})[field_name] = arr
    _write_i64(out_len_addr, arr.shape[0])
    _write_ptr(out_ptr_addr, arr.ctypes.data)
    _write_i32(out_type_addr, out_type)


def dataset_get_num_data(handle, out_addr):
    _write_i64(out_addr, _get(handle).num_data())


def dataset_get_num_feature(handle, out_addr):
    _write_i64(out_addr, _get(handle).num_feature())


def dataset_save_binary(handle, filename):
    _get(handle).save_binary(filename)


def dataset_get_subset(handle, indices_addr, num_indices, parameters,
                       out_addr):
    ds: Dataset = _get(handle)
    idx = _read_array(indices_addr, num_indices, np.int32)
    sub = ds.subset(idx, params=_params_dict(parameters) or None)
    _write_ptr(out_addr, _register(sub))


def dataset_set_feature_names(handle, names_addr, num_names):
    ptrs = _read_array(names_addr, num_names, np.int64)
    _get(handle).set_feature_name(
        [ctypes.c_char_p(int(p)).value.decode() for p in ptrs])


def dataset_get_feature_names(handle, names_addr, out_num_addr):
    names = _get(handle).construct().feature_names
    _write_i64(out_num_addr, len(names))
    _write_string_array(names_addr, names)


# ------------------------------------------------------------------ booster
def booster_create(train_data, parameters, out_addr):
    ds: Dataset = _get(train_data)
    bst = Booster(params=_params_dict(parameters), train_set=ds,
                  device=ds.device)
    _write_ptr(out_addr, _register(bst))


def booster_create_from_modelfile(filename, out_num_iter_addr, out_addr):
    bst = Booster(model_file=filename, device=_device())
    _write_i64(out_num_iter_addr, bst.current_iteration)
    _write_ptr(out_addr, _register(bst))


def booster_merge(handle, other_handle):
    _get(handle)._gbdt.merge_from(_get(other_handle)._gbdt)


def booster_reset_training_data(handle, train_data):
    _get(handle)._reset_train_data(_get(train_data))


def booster_reset_parameter(handle, parameters):
    _get(handle).reset_parameter(_params_dict(parameters))


def booster_add_valid_data(handle, valid_data):
    bst: Booster = _get(handle)
    bst.add_valid(_get(valid_data), name=f"valid_{len(bst.name_valid_sets)}")


def booster_update_one_iter(handle, is_finished_addr):
    finished = _get(handle).update()
    _write_i32(is_finished_addr, 1 if finished else 0)


def booster_update_one_iter_custom(handle, grad_addr, hess_addr,
                                   is_finished_addr):
    """The caller's float32 ``[K·n]`` gradients, class-major, moved to the
    booster's device as tensors."""
    gb = _get(handle)._gbdt
    n = gb.num_data * gb.num_class
    grad, hess = (torch.from_numpy(_read_array(a, n, np.float32))
                  .to(gb.device) for a in (grad_addr, hess_addr))
    finished = gb.train_one_iter(grad, hess)
    _write_i32(is_finished_addr, 1 if finished else 0)


def booster_rollback_one_iter(handle):
    _get(handle).rollback_one_iter()


def booster_get_current_iteration(handle, out_addr):
    _write_i64(out_addr, _get(handle).current_iteration)


def booster_get_num_classes(handle, out_addr):
    _write_i64(out_addr, _get(handle)._gbdt.num_class)


def _eval_names(bst: Booster) -> List[str]:
    """Metric names without evaluating (c_api.cpp GetEvalNames); none for
    a booster loaded from a model file, which carries no metrics."""
    names: List[str] = []
    for m in bst._gbdt.train_metrics:
        if hasattr(m, "eval_multi"):
            names.extend(f"{m.name}@{k}" for k in m.eval_at)
        else:
            names.append(m.name)
    return names


def booster_get_eval_counts(handle, out_addr):
    _write_i64(out_addr, len(_eval_names(_get(handle))))


def booster_get_eval_names(handle, out_len_addr, out_strs_addr):
    names = _eval_names(_get(handle))
    _write_i64(out_len_addr, len(names))
    _write_string_array(out_strs_addr, names)


def booster_get_eval(handle, data_idx, out_len_addr, out_results_addr):
    vals = [t[2] for t in _get(handle).eval(int(data_idx), "")]
    arr = np.asarray(vals, np.float64)
    _write_i64(out_len_addr, arr.shape[0])
    _write_array(out_results_addr, arr)


def booster_get_num_predict(handle, data_idx, out_len_addr):
    gb = _get(handle)._gbdt
    n = gb.num_data if data_idx == 0 else gb.valid_sets[data_idx - 1].num_data
    _write_i64(out_len_addr, int(n) * gb.num_class)


def booster_get_predict(handle, data_idx, out_len_addr, out_result_addr):
    """The objective-transformed scores of the training (0) or a valid set,
    row-major ``[num_data, num_class]`` (GBDT::GetPredictAt,
    gbdt.cpp:388-426): one copy of the device scores to the host, the
    transform in float64 there."""
    gb = _get(handle)._gbdt
    scores = gb.predict_at(int(data_idx)).astype(np.float64)  # [K, n]
    if gb.sigmoid > 0 and gb.num_class == 1 and gb.objective_name() == "binary":
        out = 1.0 / (1.0 + np.exp(-2.0 * gb.sigmoid * scores[0]))
    elif gb.num_class > 1:
        e = np.exp(scores - scores.max(axis=0, keepdims=True))
        out = (e / e.sum(axis=0, keepdims=True)).T
    else:
        out = scores[0]
    arr = np.ascontiguousarray(out, np.float64).reshape(-1)
    _write_i64(out_len_addr, arr.shape[0])
    _write_array(out_result_addr, arr)


def booster_calc_num_predict(handle, num_row, predict_type, num_iteration,
                             out_len_addr):
    gb = _get(handle)._gbdt
    K = gb.num_class
    per_row = K
    if predict_type == _PREDICT_LEAF:
        total_iter = gb.num_trees // max(1, K)
        n_iter = total_iter if num_iteration <= 0 else min(
            int(num_iteration), total_iter)
        per_row = n_iter * K
    _write_i64(out_len_addr, int(num_row) * per_row)


def _predict_into(bst: Booster, data, predict_type, num_iteration,
                  out_len_addr, out_result_addr) -> None:
    res = bst.predict(data, num_iteration=num_iteration,
                      raw_score=predict_type == _PREDICT_RAW,
                      pred_leaf=predict_type == _PREDICT_LEAF)
    arr = np.ascontiguousarray(res, np.float64).reshape(-1)
    _write_i64(out_len_addr, arr.shape[0])
    _write_array(out_result_addr, arr)


def booster_predict_for_mat(handle, data_addr, data_type, nrow, ncol,
                            is_row_major, predict_type, num_iteration,
                            out_len_addr, out_result_addr):
    X = _read_matrix(data_addr, data_type, nrow, ncol, is_row_major)
    _predict_into(_get(handle), X, predict_type, num_iteration,
                  out_len_addr, out_result_addr)


def booster_predict_for_csr(handle, indptr_addr, indptr_type, indices_addr,
                            data_addr, data_type, nindptr, nelem, num_col,
                            predict_type, num_iteration, out_len_addr,
                            out_result_addr):
    csr = _read_sparse_csr(indptr_addr, indptr_type, indices_addr, data_addr,
                           data_type, nindptr, nelem, num_col, "csr")
    _predict_into(_get(handle), csr, predict_type, num_iteration,
                  out_len_addr, out_result_addr)


def booster_predict_for_csc(handle, col_ptr_addr, col_ptr_type, indices_addr,
                            data_addr, data_type, ncol_ptr, nelem, num_row,
                            predict_type, num_iteration, out_len_addr,
                            out_result_addr):
    csr = _read_sparse_csr(col_ptr_addr, col_ptr_type, indices_addr,
                           data_addr, data_type, ncol_ptr, nelem, num_row,
                           "csc")
    _predict_into(_get(handle), csr, predict_type, num_iteration,
                  out_len_addr, out_result_addr)


def booster_predict_for_file(handle, data_filename, data_has_header,
                             predict_type, num_iteration, result_filename):
    """``task=predict``'s path (``cli.Predictor``), so the result file is
    the CLI's byte for byte."""
    from .cli import Predictor

    Predictor(_get(handle), predict_type == _PREDICT_RAW,
              predict_type == _PREDICT_LEAF).predict_file(
        data_filename, result_filename, bool(data_has_header),
        num_iteration=num_iteration)


def booster_save_model(handle, num_iteration, filename):
    _get(handle).save_model(filename, num_iteration=num_iteration)


def booster_dump_model(handle, num_iteration, buffer_len, out_len_addr,
                       out_str_addr):
    raw = json.dumps(_get(handle).dump_model(
        num_iteration=num_iteration)).encode() + b"\0"
    _write_i64(out_len_addr, len(raw))
    if buffer_len >= len(raw):
        ctypes.memmove(out_str_addr, raw, len(raw))


def booster_get_leaf_value(handle, tree_idx, leaf_idx, out_val_addr):
    tree = _get(handle)._gbdt.models[tree_idx]
    ctypes.c_double.from_address(out_val_addr).value = float(
        tree.leaf_value[int(leaf_idx)])


def booster_set_leaf_value(handle, tree_idx, leaf_idx, val):
    """The leaf's value as float32 in a new tree; the model version moves,
    so P1's packed trees are rebuilt (P2's tables are built from the
    trees at each walk)."""
    gb = _get(handle)._gbdt
    tree = gb.models[tree_idx]
    leaf_value = tree.leaf_value.clone()
    leaf_value[int(leaf_idx)] = float(np.float32(val))
    gb.models[tree_idx] = tree.replace(leaf_value=leaf_value)
    gb._models_changed()
