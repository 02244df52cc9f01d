"""The port's batch tier (serving/batch.py) against ``Booster.predict`` and
the JAX package's batch tier.

``pipelined_predict_file`` (reader, P1 and writer threads) writes
``format_block`` of ``Booster.predict`` on the same file, byte for byte,
streamed or not, overlapped or not, for CSV and LibSVM input and for
multiclass output; the JAX package's tier writes the same bytes from the
same model file.  A reader error mid-stream aborts the run and leaves no
partial result file (an existing one untouched).
"""

import os

import numpy as np
import pytest

from lightgbm_tpu import basic as jax_basic
from lightgbm_tpu.serving import batch as jax_batch

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.io import parser
from lightgbm_tpu_torch.serving import batch

CPU = dict(device="cpu")


def _write_csv(path, X, y):
    with open(path, "w") as fh:
        for yi, row in zip(y, X):
            fh.write(",".join("%.17g" % v for v in (yi, *row)) + "\n")
    return str(path)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("batch")
    rng = np.random.RandomState(0)
    X = rng.randn(1200, 5)
    y = (X[:, 0] + X[:, 1] * X[:, 2] > 0).astype(np.float32)
    yk = np.digitize(X[:, 0], [-0.5, 0.5]).astype(np.float32)
    out = {"tmp": tmp, "X": X, "y": y}
    for name, params, label in (
            ("binary", {"objective": "binary"}, y),
            ("multiclass", {"objective": "multiclass", "num_class": 3}, yk)):
        path = str(tmp / f"{name}.txt")
        lt.train(dict(params, num_leaves=7, verbose=-1),
                 lt.Dataset(X, label=label, **CPU), 5, **CPU).save_model(path)
        out[name] = path
    out["csv"] = _write_csv(tmp / "rows.csv", X, y)
    lines = [" ".join(["%d" % y[i]] + ["%d:%.17g" % (j, X[i, j])
                                       for j in range(5) if abs(X[i, j]) > 1])
             for i in range(len(X))]
    (tmp / "rows.svm").write_text("\n".join(lines) + "\n")
    out["svm"] = str(tmp / "rows.svm")
    return out


@pytest.mark.parametrize("model", ["binary", "multiclass"])
@pytest.mark.parametrize("mode", ["one-shot", "streamed", "sequential"])
def test_pipelined_equals_booster_predict(models, model, mode):
    bst = lt.Booster(model_file=models[model], **CPU)
    want = batch.format_block(bst.predict(models["csv"]))
    result = str(models["tmp"] / f"out-{model}-{mode}.txt")
    kw = {} if mode == "one-shot" else dict(stream_threshold=0,
                                            chunk_rows=100)
    stats = batch.pipelined_predict_file(bst, models["csv"], result,
                                         overlap=mode != "sequential", **kw)
    assert open(result).read() == want
    assert stats["rows"] == 1200
    assert stats["streamed"] == (mode != "one-shot")
    if mode == "streamed":
        assert stats["chunks"] == 12
        assert stats["read_s"] >= 0 and stats["write_s"] >= 0
    # the JAX package's tier on the same model file writes the same bytes
    ref = str(models["tmp"] / f"jax-{model}-{mode}.txt")
    jax_batch.pipelined_predict_file(
        jax_basic.Booster(model_file=models[model]), models["csv"], ref,
        overlap=mode != "sequential", **kw)
    assert open(ref).read() == want


def test_libsvm_and_leaf_output(models):
    bst = lt.Booster(model_file=models["binary"], **CPU)
    result = str(models["tmp"] / "svm-out.txt")
    batch.pipelined_predict_file(bst, models["svm"], result, pred_leaf=True)
    want = bst.predict(parser.parse_file(models["svm"])[0][:, 1:],
                       pred_leaf=True)
    assert open(result).read() == batch.format_block(want)
    chunks = list(batch.predict_chunk_stream(bst, models["csv"],
                                             stream_threshold=0,
                                             chunk_rows=500,
                                             raw_score=True))
    assert [len(c) for c in chunks] == [500, 500, 200]
    np.testing.assert_array_equal(np.concatenate(chunks),
                                  bst.predict(models["X"], raw_score=True))


def test_format_block_matches_jax():
    rng = np.random.RandomState(1)
    for out in (rng.randn(7), rng.randn(4, 3),
                rng.randint(0, 9, (3, 5)).astype(np.int32)):
        assert batch.format_block(out) == jax_batch.format_block(out)


def test_reader_error_leaves_no_partial_file(models, tmp_path):
    bad = tmp_path / "bad.csv"
    lines = open(models["csv"]).read().splitlines()
    lines[700] = "1,2,x,4,5,6"
    bad.write_text("\n".join(lines) + "\n")
    bst = lt.Booster(model_file=models["binary"], **CPU)
    result = str(tmp_path / "result.txt")
    with pytest.raises(ValueError):
        batch.pipelined_predict_file(bst, str(bad), result,
                                     stream_threshold=0, chunk_rows=100)
    assert not os.path.exists(result)
    assert not [p for p in os.listdir(tmp_path) if p.startswith("result")]
    with open(result, "w") as fh:
        fh.write("previous\n")
    for overlap in (True, False):
        with pytest.raises(ValueError):
            batch.pipelined_predict_file(bst, str(bad), result,
                                         stream_threshold=0, chunk_rows=100,
                                         overlap=overlap)
        assert open(result).read() == "previous\n"
    with pytest.raises(parser.ParseError):  # one-shot: strict parse
        batch.pipelined_predict_file(bst, str(bad), result)
    assert open(result).read() == "previous\n"
