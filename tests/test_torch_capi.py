"""The port's C API shim (csrc/host/lgbm_capi.c over
lightgbm_tpu_torch/capi_impl.py) through ctypes, on the CPU
(``LGBM_CAPI_PLATFORM=cpu``), as tests/test_c_api.py drives the JAX
package's, with seeded files in place of the reference's examples: the
round trip (datasets from files, training with evaluation, prediction
through the live booster, a saved model and a result file), the rest of
the 40-function surface, and the query boundaries of ``GetField``.

The model the C API trains is held bitwise to ``lt.train`` with the same
parameters and files, and its trees to the JAX package's with
``assert_same_trees`` at ``hist_impl="matmul"`` (structure exact, floats
to rtol 1e-5); the training rows carry a random init score (a side file)
for the reason test_torch_booster_api gives.  ``PredictForFile`` writes
``task=predict``'s bytes.  Without a card and without
``LGBM_CAPI_PLATFORM=cpu`` a call fails with the device's message.
"""

import ctypes
import json
import os

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu.engine as jax_engine

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import capi_impl, cli

from test_torch_objectives import assert_same_trees

F32, F64, I32, I64 = 0, 1, 2, 3
PRED_NORMAL, PRED_RAW, PRED_LEAF = 0, 1, 2
PARAMS = {"objective": "binary", "num_leaves": 15, "min_data_in_leaf": 20,
          "metric": "binary_logloss,auc", "hist_impl": "matmul",
          "verbose": -1}
PARAM_STR = " ".join(f"{k}={v}" for k, v in PARAMS.items()).encode()


@pytest.fixture(scope="module")
def lib():
    dll = ctypes.CDLL(capi_impl.library_path())
    dll.LGBM_GetLastError.restype = ctypes.c_char_p
    return dll


@pytest.fixture(autouse=True)
def cpu(monkeypatch):
    monkeypatch.setenv("LGBM_CAPI_PLATFORM", "cpu")


def _ok(dll, rc):
    assert rc == 0, dll.LGBM_GetLastError().decode()


def _files(tmp_path, n=2000, n_valid=500, seed=7):
    """Tab-separated train / valid files (label first, ``%.17g``) and the
    training rows' init scores in ``train.tsv.init``."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n + n_valid, 8)
    z = X[:, 0] + 0.6 * X[:, 1] * X[:, 2] + 0.5 * (X[:, 7] > 0.3)
    y = (z + 0.5 * rng.randn(n + n_valid) > 0).astype(float)
    paths = []
    for name, rows in (("train", slice(0, n)), ("valid", slice(n, None))):
        path = str(tmp_path / f"{name}.tsv")
        np.savetxt(path, np.column_stack([y[rows], X[rows]]), fmt="%.17g",
                   delimiter="\t")
        paths.append(path)
    init = 0.3 * rng.randn(n)
    np.savetxt(paths[0] + ".init", init, fmt="%.17g")
    return paths, X, y, init


def _dataset_from_file(lib, path, reference=None, params=PARAM_STR):
    out = ctypes.c_void_p()
    _ok(lib, lib.LGBM_DatasetCreateFromFile(path.encode(), params, reference,
                                            ctypes.byref(out)))
    return out


def _predict_mat(lib, bst, X, kind=PRED_NORMAL):
    X = np.ascontiguousarray(X, np.float64)
    out = (ctypes.c_double * len(X))()
    n = ctypes.c_int64()
    _ok(lib, lib.LGBM_BoosterPredictForMat(
        bst, X.ctypes.data_as(ctypes.c_void_p), ctypes.c_int(F64),
        ctypes.c_int32(X.shape[0]), ctypes.c_int32(X.shape[1]),
        ctypes.c_int(1), ctypes.c_int(kind), ctypes.c_int64(-1),
        ctypes.byref(n), out))
    assert n.value == len(X)
    return np.frombuffer(out, np.float64).copy()


def test_c_api_full_round_trip(lib, tmp_path):
    (train_path, valid_path), X, y, init = _files(tmp_path)
    Xv = X[2000:]
    train = _dataset_from_file(lib, train_path)
    valid = _dataset_from_file(lib, valid_path, reference=train)
    n = ctypes.c_int64()
    _ok(lib, lib.LGBM_DatasetGetNumData(train, ctypes.byref(n)))
    assert n.value == 2000
    _ok(lib, lib.LGBM_DatasetGetNumFeature(train, ctypes.byref(n)))
    assert n.value == 8

    bst = ctypes.c_void_p()
    _ok(lib, lib.LGBM_BoosterCreate(train, PARAM_STR, ctypes.byref(bst)))
    _ok(lib, lib.LGBM_BoosterAddValidData(bst, valid))
    fin = ctypes.c_int()
    for _ in range(10):
        _ok(lib, lib.LGBM_BoosterUpdateOneIter(bst, ctypes.byref(fin)))
    it = ctypes.c_int64()
    _ok(lib, lib.LGBM_BoosterGetCurrentIteration(bst, ctypes.byref(it)))
    assert it.value == 10

    cnt = ctypes.c_int64()
    _ok(lib, lib.LGBM_BoosterGetEvalCounts(bst, ctypes.byref(cnt)))
    assert cnt.value == 2
    bufs = [ctypes.create_string_buffer(64) for _ in range(cnt.value)]
    arr = (ctypes.c_char_p * cnt.value)(*[ctypes.addressof(b) for b in bufs])
    _ok(lib, lib.LGBM_BoosterGetEvalNames(bst, ctypes.byref(cnt), arr))
    names = [b.value.decode() for b in bufs]
    assert names == ["binary_logloss", "auc"]
    res = (ctypes.c_double * cnt.value)()
    _ok(lib, lib.LGBM_BoosterGetEval(bst, 1, ctypes.byref(cnt), res))
    evals = dict(zip(names, res))
    assert 0 < evals["binary_logloss"] < 0.7 and 0.7 < evals["auc"] <= 1.0

    # the model: bitwise lt.train's on the same files, and the JAX
    # package's trees
    port = capi_impl._registry[bst.value]
    want = lt.train(dict(PARAMS), lt.Dataset(train_path, device="cpu"), 10,
                    device="cpu")
    assert port.model_to_string() == want.model_to_string()
    # the JAX package on the same floats in memory (its file reader may
    # fall back to pandas, which does not round every float correctly)
    bj = jax_engine.train(dict(PARAMS), lgb.Dataset(
        X[:2000], label=y[:2000], init_score=init), 10, verbose_eval=False)
    assert_same_trees(bj._gbdt.models, port._gbdt.models)

    # inner predictions: sigmoid-transformed, the valid set's the live
    # booster's prediction of its rows
    np_len = ctypes.c_int64()
    _ok(lib, lib.LGBM_BoosterGetNumPredict(bst, 0, ctypes.byref(np_len)))
    assert np_len.value == 2000
    inner = (ctypes.c_double * 2000)()
    _ok(lib, lib.LGBM_BoosterGetPredict(bst, 0, ctypes.byref(np_len), inner))
    assert 0.0 < min(inner) and max(inner) < 1.0
    inner_v = (ctypes.c_double * 500)()
    _ok(lib, lib.LGBM_BoosterGetPredict(bst, 1, ctypes.byref(np_len),
                                        inner_v))
    p_live = _predict_mat(lib, bst, Xv)
    np.testing.assert_allclose(np.frombuffer(inner_v), p_live, rtol=1e-6)
    assert p_live.tobytes() == want.predict(Xv).tobytes()

    # an in-memory dataset, labels through SetField
    rng = np.random.RandomState(0)
    Xm = rng.randn(500, 6)
    ym = (Xm[:, 0] > 0).astype(np.float32)
    dmat = ctypes.c_void_p()
    _ok(lib, lib.LGBM_DatasetCreateFromMat(
        np.ascontiguousarray(Xm).ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int(F64), ctypes.c_int32(500), ctypes.c_int32(6),
        ctypes.c_int(1), b"num_leaves=7 verbose=-1", None, ctypes.byref(dmat)))
    _ok(lib, lib.LGBM_DatasetSetField(
        dmat, b"label", ym.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int64(500), ctypes.c_int(F32)))
    out_len, out_ptr, out_type = ctypes.c_int64(), ctypes.c_void_p(), \
        ctypes.c_int()
    _ok(lib, lib.LGBM_DatasetGetField(
        dmat, b"label", ctypes.byref(out_len), ctypes.byref(out_ptr),
        ctypes.byref(out_type)))
    assert out_len.value == 500 and out_type.value == F32
    got = np.frombuffer(
        (ctypes.c_char * (500 * 4)).from_address(out_ptr.value), np.float32)
    np.testing.assert_array_equal(got, ym)

    # a saved and reloaded model, and a result file
    model = str(tmp_path / "capi_model.txt")
    _ok(lib, lib.LGBM_BoosterSaveModel(bst, ctypes.c_int(-1),
                                       model.encode()))
    assert open(model).read() == want.model_to_string()
    n_iter, bst2 = ctypes.c_int64(), ctypes.c_void_p()
    _ok(lib, lib.LGBM_BoosterCreateFromModelfile(
        model.encode(), ctypes.byref(n_iter), ctypes.byref(bst2)))
    assert n_iter.value == 10
    _ok(lib, lib.LGBM_BoosterGetEvalCounts(bst2, ctypes.byref(cnt)))
    assert cnt.value == 0
    assert _predict_mat(lib, bst2, Xv).tobytes() == p_live.tobytes()
    result = str(tmp_path / "capi_pred.txt")
    _ok(lib, lib.LGBM_BoosterPredictForFile(
        bst, valid_path.encode(), ctypes.c_int(0), ctypes.c_int(PRED_NORMAL),
        ctypes.c_int64(-1), result.encode()))
    cli_result = str(tmp_path / "cli_pred.txt")
    assert cli.main(["task=predict", f"data={valid_path}",
                     f"input_model={model}", f"output_result={cli_result}"],
                    device="cpu") == 0
    assert open(result).read() == open(cli_result).read()

    # the error surface
    assert lib.LGBM_DatasetCreateFromFile(
        b"/definitely/missing.csv", PARAM_STR, None,
        ctypes.byref(ctypes.c_void_p())) == -1
    assert b"missing.csv" in lib.LGBM_GetLastError()
    for h in (train, valid, dmat):
        _ok(lib, lib.LGBM_DatasetFree(h))
    _ok(lib, lib.LGBM_BoosterFree(bst))
    _ok(lib, lib.LGBM_BoosterFree(bst2))


def test_c_api_extended_surface(lib, tmp_path):
    """CSR / CSC datasets and sparse prediction, subsets, feature names,
    custom gradients, inner predictions, merge, the JSON dump and leaf
    get / set (which prediction and a valid set's replay then see)."""
    import scipy.sparse as sp

    rng = np.random.RandomState(1)
    Xd = rng.randn(400, 5)
    Xd[rng.rand(400, 5) < 0.5] = 0.0
    y = (Xd[:, 0] + Xd[:, 1] > 0).astype(np.float32)
    csr = sp.csr_matrix(Xd)
    indptr = csr.indptr.astype(np.int32)
    indices = csr.indices.astype(np.int32)
    values = csr.data.astype(np.float64)
    params = b"num_leaves=7 min_data_in_leaf=5 verbose=-1"

    ds = ctypes.c_void_p()
    _ok(lib, lib.LGBM_DatasetCreateFromCSR(
        indptr.ctypes.data_as(ctypes.c_void_p), ctypes.c_int(I32),
        indices.ctypes.data_as(ctypes.c_void_p),
        values.ctypes.data_as(ctypes.c_void_p), ctypes.c_int(F64),
        ctypes.c_int64(len(indptr)), ctypes.c_int64(len(values)),
        ctypes.c_int64(5), params, None, ctypes.byref(ds)))
    _ok(lib, lib.LGBM_DatasetSetField(
        ds, b"label", y.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int64(400), ctypes.c_int(F32)))
    csc = sp.csc_matrix(Xd)
    ds_csc = ctypes.c_void_p()
    _ok(lib, lib.LGBM_DatasetCreateFromCSC(
        csc.indptr.astype(np.int64).ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int(I64),
        csc.indices.astype(np.int32).ctypes.data_as(ctypes.c_void_p),
        csc.data.astype(np.float32).ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int(F32), ctypes.c_int64(len(csc.indptr)),
        ctypes.c_int64(csc.nnz), ctypes.c_int64(400), params, None,
        ctypes.byref(ds_csc)))
    n = ctypes.c_int64()
    _ok(lib, lib.LGBM_DatasetGetNumData(ds_csc, ctypes.byref(n)))
    assert n.value == 400
    _ok(lib, lib.LGBM_DatasetGetNumFeature(ds_csc, ctypes.byref(n)))
    assert n.value == 5

    names = [b"alpha", b"beta", b"gamma", b"delta", b"epsilon"]
    _ok(lib, lib.LGBM_DatasetSetFeatureNames(
        ds, (ctypes.c_char_p * 5)(*names), ctypes.c_int64(5)))
    bufs = [ctypes.create_string_buffer(32) for _ in range(5)]
    arr_out = (ctypes.c_char_p * 5)(*[ctypes.addressof(b) for b in bufs])
    _ok(lib, lib.LGBM_DatasetGetFeatureNames(ds, arr_out, ctypes.byref(n)))
    assert n.value == 5 and [b.value for b in bufs] == names

    idx = np.arange(0, 400, 2, dtype=np.int32)
    sub = ctypes.c_void_p()
    _ok(lib, lib.LGBM_DatasetGetSubset(
        ds, idx.ctypes.data_as(ctypes.c_void_p), ctypes.c_int32(len(idx)),
        b"", ctypes.byref(sub)))
    _ok(lib, lib.LGBM_DatasetGetNumData(sub, ctypes.byref(n)))
    assert n.value == 200

    # custom gradients (logistic) against lt's fobj on the same data
    bst = ctypes.c_void_p()
    _ok(lib, lib.LGBM_BoosterCreate(
        ds, b"objective=none num_leaves=7 min_data_in_leaf=5 verbose=-1",
        ctypes.byref(bst)))
    _ok(lib, lib.LGBM_BoosterResetParameter(bst, b"learning_rate=0.2"))
    _ok(lib, lib.LGBM_BoosterGetNumPredict(bst, 0, ctypes.byref(n)))
    assert n.value == 400
    fin = ctypes.c_int()
    inner = (ctypes.c_double * 400)()

    def logistic(s):
        p = 1.0 / (1.0 + np.exp(-2.0 * np.asarray(s, np.float64)))
        return (p - y).astype(np.float32), (2.0 * p * (1.0 - p)).astype(
            np.float32)

    for _ in range(5):
        _ok(lib, lib.LGBM_BoosterGetPredict(bst, 0, ctypes.byref(n), inner))
        grad, hess = logistic(np.frombuffer(inner))
        _ok(lib, lib.LGBM_BoosterUpdateOneIterCustom(
            bst, grad.ctypes.data_as(ctypes.c_void_p),
            hess.ctypes.data_as(ctypes.c_void_p), ctypes.byref(fin)))
    ref = lt.Booster({"objective": "none", "num_leaves": 7,
                      "min_data_in_leaf": 5, "learning_rate": 0.2,
                      "verbose": -1},
                     lt.Dataset(csr, label=y, device="cpu",
                                feature_name=[b.decode() for b in names]),
                     device="cpu")
    for _ in range(5):
        ref.update(fobj=lambda s, _ds: logistic(s))
    port = capi_impl._registry[bst.value]
    assert port.model_to_string() == ref.model_to_string()

    _ok(lib, lib.LGBM_BoosterCalcNumPredict(
        bst, ctypes.c_int64(400), ctypes.c_int(PRED_RAW), ctypes.c_int64(-1),
        ctypes.byref(n)))
    assert n.value == 400
    _ok(lib, lib.LGBM_BoosterCalcNumPredict(
        bst, ctypes.c_int64(400), ctypes.c_int(PRED_LEAF), ctypes.c_int64(3),
        ctypes.byref(n)))
    assert n.value == 1200
    pred_csr = (ctypes.c_double * 400)()
    _ok(lib, lib.LGBM_BoosterPredictForCSR(
        bst, indptr.ctypes.data_as(ctypes.c_void_p), ctypes.c_int(I32),
        indices.ctypes.data_as(ctypes.c_void_p),
        values.ctypes.data_as(ctypes.c_void_p), ctypes.c_int(F64),
        ctypes.c_int64(len(indptr)), ctypes.c_int64(len(values)),
        ctypes.c_int64(5), ctypes.c_int(PRED_RAW), ctypes.c_int64(-1),
        ctypes.byref(n), pred_csr))
    pred_csc = (ctypes.c_double * 400)()
    _ok(lib, lib.LGBM_BoosterPredictForCSC(
        bst, csc.indptr.astype(np.int32).ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int(I32),
        csc.indices.astype(np.int32).ctypes.data_as(ctypes.c_void_p),
        csc.data.ctypes.data_as(ctypes.c_void_p), ctypes.c_int(F64),
        ctypes.c_int64(len(csc.indptr)), ctypes.c_int64(csc.nnz),
        ctypes.c_int64(400), ctypes.c_int(PRED_RAW), ctypes.c_int64(-1),
        ctypes.byref(n), pred_csc))
    pred_mat = _predict_mat(lib, bst, Xd, PRED_RAW)
    assert np.frombuffer(pred_csr).tobytes() == pred_mat.tobytes() \
        == np.frombuffer(pred_csc).tobytes()
    assert pred_mat.tobytes() == ref.predict(Xd, raw_score=True).tobytes()

    out_len = ctypes.c_int64()
    _ok(lib, lib.LGBM_BoosterDumpModel(bst, ctypes.c_int(-1), ctypes.c_int(0),
                                       ctypes.byref(out_len), None))
    buf = ctypes.create_string_buffer(out_len.value)
    _ok(lib, lib.LGBM_BoosterDumpModel(bst, ctypes.c_int(-1),
                                       ctypes.c_int(out_len.value),
                                       ctypes.byref(out_len), buf))
    dump = json.loads(buf.value.decode())
    assert dump["num_class"] == 1 and len(dump["tree_info"]) == 5

    # leaf get / set: prediction (P1's packed trees) and a new valid set's
    # replay (P2's tables) see the new value
    val = ctypes.c_double()
    _ok(lib, lib.LGBM_BoosterGetLeafValue(bst, 4, 0, ctypes.byref(val)))
    leaf = ref.predict(Xd, pred_leaf=True)[:, 4]
    _ok(lib, lib.LGBM_BoosterSetLeafValue(bst, 4, 0,
                                          ctypes.c_double(val.value + 0.5)))
    val2 = ctypes.c_double()
    _ok(lib, lib.LGBM_BoosterGetLeafValue(bst, 4, 0, ctypes.byref(val2)))
    assert val2.value == float(np.float32(val.value + 0.5))
    moved = _predict_mat(lib, bst, Xd, PRED_RAW) - pred_mat
    np.testing.assert_allclose(moved[leaf == 0], 0.5, rtol=1e-5)
    assert (moved[leaf != 0] == 0).all() and (leaf == 0).any()
    dv = ctypes.c_void_p()
    _ok(lib, lib.LGBM_DatasetCreateFromMat(
        np.ascontiguousarray(Xd).ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int(F64), ctypes.c_int32(400), ctypes.c_int32(5),
        ctypes.c_int(1), params, ds, ctypes.byref(dv)))
    _ok(lib, lib.LGBM_BoosterAddValidData(bst, dv))
    replay = (ctypes.c_double * 400)()
    _ok(lib, lib.LGBM_BoosterGetPredict(bst, 1, ctypes.byref(n), replay))
    np.testing.assert_allclose(np.frombuffer(replay),
                               _predict_mat(lib, bst, Xd, PRED_RAW),
                               rtol=1e-6, atol=1e-6)

    # merge: another booster's trees append; rollback takes one away
    bst2 = ctypes.c_void_p()
    _ok(lib, lib.LGBM_BoosterCreate(
        ds, b"objective=binary num_leaves=7 min_data_in_leaf=5 verbose=-1",
        ctypes.byref(bst2)))
    _ok(lib, lib.LGBM_BoosterUpdateOneIter(bst2, ctypes.byref(fin)))
    _ok(lib, lib.LGBM_BoosterMerge(bst2, bst))
    it = ctypes.c_int64()
    _ok(lib, lib.LGBM_BoosterGetCurrentIteration(bst2, ctypes.byref(it)))
    assert it.value == 6
    _ok(lib, lib.LGBM_BoosterRollbackOneIter(bst2))
    _ok(lib, lib.LGBM_BoosterGetCurrentIteration(bst2, ctypes.byref(it)))
    assert it.value == 5
    _ok(lib, lib.LGBM_BoosterGetNumClasses(bst2, ctypes.byref(n)))
    assert n.value == 1
    _ok(lib, lib.LGBM_BoosterResetTrainingData(bst2, sub))
    _ok(lib, lib.LGBM_BoosterUpdateOneIter(bst2, ctypes.byref(fin)))
    _ok(lib, lib.LGBM_DatasetSaveBinary(ds, str(tmp_path / "d.bin").encode()))
    assert os.path.exists(tmp_path / "d.bin")

    for h in (ds, ds_csc, sub, dv):
        _ok(lib, lib.LGBM_DatasetFree(h))
    _ok(lib, lib.LGBM_BoosterFree(bst))
    _ok(lib, lib.LGBM_BoosterFree(bst2))


def test_c_api_group_field_boundaries(lib):
    """GetField('group') returns query boundaries (num_queries + 1), as the
    reference C API hands out query_boundaries_; SetField('group') takes
    per-query sizes."""
    rng = np.random.RandomState(3)
    X = np.ascontiguousarray(rng.randn(60, 4))
    y = rng.rand(60).astype(np.float32)
    ds = ctypes.c_void_p()
    _ok(lib, lib.LGBM_DatasetCreateFromMat(
        X.ctypes.data_as(ctypes.c_void_p), ctypes.c_int(F64),
        ctypes.c_int32(60), ctypes.c_int32(4), ctypes.c_int(1),
        b"min_data_in_leaf=2 verbose=-1", None, ctypes.byref(ds)))
    _ok(lib, lib.LGBM_DatasetSetField(
        ds, b"label", y.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int64(60), ctypes.c_int(F32)))
    sizes = np.array([10, 25, 5, 20], dtype=np.int32)
    _ok(lib, lib.LGBM_DatasetSetField(
        ds, b"group", sizes.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int64(4), ctypes.c_int(I32)))
    out_len, out_ptr, out_type = ctypes.c_int64(), ctypes.c_void_p(), \
        ctypes.c_int()
    _ok(lib, lib.LGBM_DatasetGetField(
        ds, b"group", ctypes.byref(out_len), ctypes.byref(out_ptr),
        ctypes.byref(out_type)))
    assert out_type.value == I32 and out_len.value == 5
    bounds = np.ctypeslib.as_array(
        ctypes.cast(out_ptr, ctypes.POINTER(ctypes.c_int32)), shape=(5,))
    np.testing.assert_array_equal(bounds, [0, 10, 35, 40, 60])
    _ok(lib, lib.LGBM_DatasetFree(ds))


def test_c_api_needs_the_card_or_cpu(lib, monkeypatch):
    """Unset or ``cuda`` means the card: without one the call fails and
    LGBM_GetLastError carries the device's message; nothing moves to the
    CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default device is usable")
    X = np.ascontiguousarray(np.random.RandomState(4).randn(50, 3))
    for value in (None, "cuda"):
        if value is None:
            monkeypatch.delenv("LGBM_CAPI_PLATFORM")
        else:
            monkeypatch.setenv("LGBM_CAPI_PLATFORM", value)
        ds = ctypes.c_void_p()
        assert lib.LGBM_DatasetCreateFromMat(
            X.ctypes.data_as(ctypes.c_void_p), ctypes.c_int(F64),
            ctypes.c_int32(50), ctypes.c_int32(3), ctypes.c_int(1), b"",
            None, ctypes.byref(ds)) == -1
        err = lib.LGBM_GetLastError().decode()
        assert "CUDA device" in err and "LGBM_CAPI_PLATFORM=cpu" in err
