"""The port's C API shim on the card: with ``LGBM_CAPI_PLATFORM`` unset the
datasets and the booster live on CUDA, training runs the card's kernels,
and the model text and ``PredictForMat`` are bitwise ``lt.train`` /
``Booster.predict`` on the card.  No JAX here (chip_smoke.py drives the
C API at the bench shape)."""

import ctypes

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import capi_impl
from lightgbm_tpu_torch.ops import launch_counts, reset_launch_counts

F64 = 1
PARAMS = {"objective": "binary", "num_leaves": 31, "min_data_in_leaf": 20,
          "verbose": -1}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the port's kernels have no CPU "
                    "interpret mode)")


def _ok(lib, rc):
    assert rc == 0, lib.LGBM_GetLastError().decode()


@pytest.mark.cuda
def test_c_api_trains_and_predicts_on_the_card(tmp_path, monkeypatch):
    _card()
    monkeypatch.delenv("LGBM_CAPI_PLATFORM", raising=False)
    lib = ctypes.CDLL(capi_impl.library_path())
    lib.LGBM_GetLastError.restype = ctypes.c_char_p
    rng = np.random.RandomState(0)
    X = rng.randn(20_000, 10)
    y = (X[:, 0] + X[:, 1] * X[:, 2] + 0.5 * rng.randn(20_000) > 0)
    path = str(tmp_path / "train.csv")
    np.savetxt(path, np.column_stack([y, X]), fmt="%.17g", delimiter=",")
    params = " ".join(f"{k}={v}" for k, v in PARAMS.items()).encode()
    ds, bst = ctypes.c_void_p(), ctypes.c_void_p()
    _ok(lib, lib.LGBM_DatasetCreateFromFile(path.encode(), params, None,
                                            ctypes.byref(ds)))
    _ok(lib, lib.LGBM_BoosterCreate(ds, params, ctypes.byref(bst)))
    fin = ctypes.c_int()
    reset_launch_counts()
    for _ in range(3):
        _ok(lib, lib.LGBM_BoosterUpdateOneIter(bst, ctypes.byref(fin)))
    counts = launch_counts()
    assert counts["K1'"] == counts["K3"] == 3 and counts["K8"] > 0
    port = capi_impl._registry[bst.value]
    assert port.device.type == "cuda"
    want = lt.train(dict(PARAMS), lt.Dataset(path), 3)
    assert port.model_to_string() == want.model_to_string()
    Xp = np.ascontiguousarray(X[:1000])
    out = (ctypes.c_double * 1000)()
    n = ctypes.c_int64()
    _ok(lib, lib.LGBM_BoosterPredictForMat(
        bst, Xp.ctypes.data_as(ctypes.c_void_p), ctypes.c_int(F64),
        ctypes.c_int32(1000), ctypes.c_int32(10), ctypes.c_int(1),
        ctypes.c_int(0), ctypes.c_int64(-1), ctypes.byref(n), out))
    assert np.frombuffer(out).tobytes() == want.predict(Xp).tobytes()
    _ok(lib, lib.LGBM_BoosterFree(bst))
    _ok(lib, lib.LGBM_DatasetFree(ds))
