"""Package contracts of the PyTorch port: it stands without JAX and
without lightgbm_tpu, runs on CUDA unless asked for the CPU, and refuses
what it has not ported instead of ignoring it."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.backend import resolve_device

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "lightgbm_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "lightgbm_tpu")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def _sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for root, _dirs, names in os.walk(PKG):
        out += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(out)


def test_no_jax_or_reference_imports():
    bad = []
    for path in _sources():
        with open(path, encoding="utf-8") as fh:
            tree = ast.parse(fh.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path}: {n}" for n in names if _forbidden(n)]
    assert not bad, bad


_BLOCKED_RUN = r"""
import sys

class Refuse:
    def find_spec(self, name, path=None, target=None):
        if any(name == f or name.startswith(f + ".")
               for f in ("jax", "jaxlib", "lightgbm_tpu")):
            raise ImportError("refused: " + name)
        return None

sys.meta_path.insert(0, Refuse())
import numpy as np
import lightgbm_tpu_torch as lt
rng = np.random.RandomState(0)
X = rng.randn(600, 4)
y = (X[:, 0] + X[:, 1] > 0).astype(np.float32)
b = lt.train({"objective": "binary", "num_leaves": 7, "verbose": -1},
             lt.Dataset(X, label=y, device="cpu"), 2, device="cpu")
assert b.num_trees() == 2
assert not any(m == "jax" or m.startswith(("jax.", "lightgbm_tpu."))
               or m == "lightgbm_tpu" for m in sys.modules)
print("OK")
"""


def test_imports_and_trains_without_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", _BLOCKED_RUN], env=env,
                         capture_output=True, text=True, timeout=300,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("OK")


def _data():
    rng = np.random.RandomState(1)
    X = rng.randn(300, 3)
    return X, (X[:, 0] > 0).astype(np.float32)


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default device is usable")
    X, y = _data()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lt.train({"objective": "binary", "verbose": -1},
                 lt.Dataset(X, label=y, device="cpu"), 1)
    with pytest.raises(RuntimeError):
        lt.Dataset(X, label=y)
    with pytest.raises(RuntimeError):
        resolve_device(None)
    assert resolve_device("cpu") == torch.device("cpu")


def test_api_modules_are_scanned():
    """The training API's modules are among the sources checked above."""
    names = {os.path.relpath(p, PKG) for p in _sources()}
    assert {"callback.py", "engine.py", "basic.py"} <= names


def test_serving_modules_are_scanned():
    """Serving, obs, resilience, analysis and the predictor are among
    the sources checked above."""
    names = {os.path.relpath(p, PKG) for p in _sources()}
    for sub, mods in (("serving", ("engine", "queue", "hotswap", "server")),
                      ("obs", ("telemetry", "tracing", "export", "flightrec",
                               "memory", "manifest", "device_time",
                               "memmodel")),
                      ("resilience", ("atomic", "faults")),
                      ("analysis", ("lockcheck", "concurrency")),
                      ("ops", ("predict", "cuda_predict"))):
        for m in mods + ("__init__",):
            assert os.path.join(sub, m + ".py") in names, (sub, m)


_BLOCKED_SERVE = _BLOCKED_RUN.replace('print("OK")', '''
import os, tempfile
from lightgbm_tpu_torch.serving import (InProcessClient, MicroBatchQueue,
                                        ServingEngine)
path = os.path.join(tempfile.mkdtemp(), "m.txt")
b.save_model(path)
eng = ServingEngine(path, buckets=(8,), device="cpu")
with MicroBatchQueue(eng, max_delay_s=0.001) as q:
    code, out = InProcessClient(eng, q).predict(X[:3].tolist())
assert code == 200 and out["n"] == 3, out
assert not any(m == "jax" or m.startswith(("jax.", "lightgbm_tpu."))
               or m == "lightgbm_tpu" for m in sys.modules)
print("OK")
''')


def test_serves_without_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", _BLOCKED_SERVE], env=env,
                         capture_output=True, text=True, timeout=300,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("OK")


def test_api_entry_points_default_to_cuda(tmp_path):
    """cv, a Booster from a model file or string and an unpickled Booster
    take the card unless asked for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default device is usable")
    X, y = _data()
    ds = lt.Dataset(X, label=y, device="cpu")
    params = {"objective": "binary", "verbose": -1}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lt.cv(params, ds, 1, nfold=2)
    text = lt.train(params, ds, 1, verbose_eval=False,
                    device="cpu").model_to_string()
    path = tmp_path / "m.txt"
    path.write_text(text)
    for kw in ({"model_str": text}, {"model_file": str(path)}):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            lt.Booster(**kw)
    assert lt.Booster(model_str=text, device="cpu").num_trees() == 1


@pytest.mark.parametrize("extra", [
    {"hist_dtype": "float64"},
    {"tree_learner": "data"},
    {"boosting_type": "dart"},
    {"objective": "none"},
    {"nonfinite_policy": "raise"},
    {"nonfinite_policy": "skip_tree"},
    {"nonfinite_policy": "clip"},
], ids=lambda d: "-".join(f"{k}={v}" for k, v in d.items()))
def test_out_of_slice_configs_raise(extra):
    """Each configuration outside the port raises, naming its ROADMAP
    item; objective=none is in it (a custom objective), and training
    without the fobj that supplies its gradients raises naming fobj.
    DART (A3), the non-finite guards (A9's first step), float64
    histograms (A5) and the parallel learners (A8) were refused here
    until they were ported: they now train (``tree_learner=data`` with
    no distributed world grows serially, as on one device)."""
    X, y = _data()
    params = {"objective": "binary", "verbose": -1, **extra}
    ds = lt.Dataset(X, label=y, device="cpu")
    if {"boosting_type", "nonfinite_policy", "hist_dtype",
            "tree_learner"} & set(extra):
        bst = lt.train(params, ds, 2, device="cpu")
        assert bst.current_iteration == 2
        assert bst.model_to_string().startswith(
            "dart\n" if "boosting_type" in extra else "gbdt\n")
        return
    err, match = ((lt.LightGBMError, "fobj") if extra == {"objective": "none"}
                  else (NotImplementedError, "ROADMAP"))
    with pytest.raises(err, match=match):
        lt.train(params, ds, 1, device="cpu")


@pytest.mark.parametrize("extra", [
    {"tree_growth": "depthwise"},
    {"tree_growth": "hybrid"},
    {"tree_growth": "depthwise", "histogram_pool_size": 1.0},
    {"tree_growth": "hybrid", "histogram_pool_size": 1.0},
    {"tree_growth": "leafwise", "histogram_pool_size": 0.03},
], ids=lambda d: "-".join(f"{k}={v}" for k, v in d.items()))
def test_level_growth_trains_on_cpu(extra, capsys):
    """Depthwise and hybrid growth are in the slice; with them the
    histogram pool is ignored with the JAX package's warning
    (gbdt.py:364-372), not refused.  Leaf-wise growth keeps the pool (a
    few slots here, against 7 leaves)."""
    X, y = _data()
    params = {"objective": "binary", "num_leaves": 7, "verbose": -1, **extra}
    bst = lt.train(params, lt.Dataset(X, label=y, device="cpu"), 2,
                   device="cpu")
    assert bst.num_trees() == 2
    assert bst._gbdt.models[0].num_leaves > 1
    warned = "histogram_pool_size is ignored" in capsys.readouterr().err
    leafwise = extra["tree_growth"] == "leafwise"
    assert warned == ("histogram_pool_size" in extra and not leafwise)
    assert (2 <= bst._gbdt._hist_pool_slots() < 7) == leafwise


def test_sparse_input_raises():
    """Sparse input is binned in O(nnz) (ROADMAP A6); what stays refused
    is training data without a label."""
    sp = pytest.importorskip("scipy.sparse")
    X, y = _data()
    X[X < 0.5] = 0.0
    ds = lt.Dataset(sp.csr_matrix(X), label=y, device="cpu").construct()
    dense = lt.Dataset(X, label=y, device="cpu").construct()
    np.testing.assert_array_equal(ds.dense_bins(), dense.X_bin)
    with pytest.raises(lt.LightGBMError, match="label"):
        lt.Dataset(sp.csr_matrix(X), device="cpu").construct()



_BLOCKED_IO = r"""
import sys

class Refuse:
    def find_spec(self, name, path=None, target=None):
        if any(name == f or name.startswith(f + ".")
               for f in ("jax", "jaxlib", "lightgbm_tpu", "pandas",
                         "sklearn")):
            raise ImportError("refused: " + name)
        return None

sys.meta_path.insert(0, Refuse())
import os, tempfile
import numpy as np
import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import cli, sklearn
from lightgbm_tpu_torch.io import dataset, parser, sparse
from lightgbm_tpu_torch.serving import batch
d = tempfile.mkdtemp()
rng = np.random.RandomState(0)
X = rng.randn(400, 4)
y = (X[:, 0] > 0).astype(float)
path = os.path.join(d, "train.csv")
np.savetxt(path, np.column_stack([y, X]), fmt="%.17g", delimiter=",")
model = os.path.join(d, "m.txt")
assert cli.main(["task=train", "data=" + path, "num_trees=2",
                 "num_leaves=7", "verbose=-1", "output_model=" + model],
                device="cpu") == 0
out = os.path.join(d, "pred.txt")
assert cli.main(["task=predict", "data=" + path, "input_model=" + model,
                 "output_result=" + out], device="cpu") == 0
assert len(open(out).read().splitlines()) == 400
est = lt.LGBMClassifier(n_estimators=2, device="cpu").fit(X, y)
assert est.predict_proba(X).shape == (400, 2)
assert not any(m.split(".")[0] in ("jax", "lightgbm_tpu", "pandas",
                                   "sklearn") for m in sys.modules)
print("OK")
"""


def test_file_modules_import_without_pandas_sklearn_or_jax():
    """The parser, dataset, CLI, batch tier and sklearn estimators import
    and run with jax, the JAX package, pandas and scikit-learn blocked
    (the card's machine has neither pandas nor scikit-learn)."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", _BLOCKED_IO], env=env,
                         capture_output=True, text=True, timeout=300,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("OK")
    names = {os.path.relpath(p, PKG) for p in _sources()}
    assert {"cli.py", "sklearn.py", "__main__.py",
            os.path.join("io", "parser.py"), os.path.join("io", "sparse.py"),
            os.path.join("serving", "batch.py"),
            os.path.join("ops", "sparse_hist.py"),
            os.path.join("ops", "cuda_sparse_hist.py")} <= names


def test_host_libraries_import_only_the_port():
    """The native reader's and the C API's Python sides are among the
    sources the AST check above scans, and the C shim imports the port's
    ``capi_impl`` and names no module of the JAX package."""
    names = {os.path.relpath(p, PKG) for p in _sources()}
    assert {"native.py", "capi_impl.py"} <= names
    with open(os.path.join(PKG, "csrc", "host", "lgbm_capi.c")) as fh:
        shim = fh.read()
    assert 'PyImport_ImportModule("lightgbm_tpu_torch.capi_impl")' in shim
    assert "lightgbm_tpu." not in shim
    assert shim.count("\nDllExport ") == 40
