"""The port's native reader (lightgbm_tpu_torch/native.py over
csrc/host/lgbm_native.cpp) against its numpy parser and the JAX package's
native reader.

Seeded numpy data written with ``%.17g`` goes through the native reader,
the port's numpy parser (``LIGHTGBM_TPU_NO_NATIVE=1``) and
``lightgbm_tpu.native.parse_file``; all three are held bitwise to each
other and to the written floats (NaN where NaN: the readers round
correctly).  Every file on which the two port readers could differ is
refused by the native reader (``native.Refused``) and answered by the
numpy parser, counted in telemetry ``native_fallbacks``; each such case is
pinned here.  The encoder is held bitwise to ``BinMapper.value_to_bin``,
and datasets, CLI models and two-round loads bitwise with and without the
native reader.
"""

import contextlib
import os

import numpy as np
import pytest

from lightgbm_tpu.io import parser as jp

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import cli, native
from lightgbm_tpu_torch.io import parser as tp
from lightgbm_tpu_torch.io.binner import find_bin_mappers
from lightgbm_tpu_torch.io.dataset import BinnedDataset
from lightgbm_tpu_torch.io.metadata import Metadata
from lightgbm_tpu_torch.obs import telemetry
from lightgbm_tpu_torch.ops import _build
from torch_jax_reader import jax_reader  # noqa: F401  (a fixture)


@contextlib.contextmanager
def numpy_only():
    saved = os.environ.get("LIGHTGBM_TPU_NO_NATIVE")
    os.environ["LIGHTGBM_TPU_NO_NATIVE"] = "1"
    try:
        yield
    finally:
        if saved is None:
            del os.environ["LIGHTGBM_TPU_NO_NATIVE"]
        else:
            os.environ["LIGHTGBM_TPU_NO_NATIVE"] = saved


def _fallbacks():
    return telemetry.get_telemetry().counter("native_fallbacks")


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    assert np.nan_to_num(a).tobytes() == np.nan_to_num(b).tobytes()


def _matrix(n=300, f=6, seed=0, nan_frac=0.0):
    """Floats over 1e-300-1e300, with zeros, -0.0, integers and
    subnormals; the label column 0 in {0, 1}."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f) * 10.0 ** rng.randint(-300, 300, (n, f))
    X[rng.rand(n, f) < 0.05] = 0.0
    X[rng.rand(n, f) < 0.05] = -0.0
    X[rng.rand(n, f) < 0.05] = 5e-324 * rng.randint(1, 9)
    X[rng.rand(n, f) < 0.1] = rng.randint(-99, 99)
    if nan_frac:
        X[rng.rand(n, f) < nan_frac] = np.nan
    X[:, 0] = rng.randint(0, 2, n)
    return X


def _write(path, X, sep=",", header=False, blank_every=0, na="NA",
           crlf=False):
    lines = [sep.join(f"c{j}" for j in range(X.shape[1]))] if header else []
    for i, row in enumerate(X):
        lines.append(sep.join(na if np.isnan(v) else "%.17g" % v
                              for v in row))
        if blank_every and i % blank_every == blank_every - 1:
            lines.append(" \t " if i % 2 else "")
    end = "\r\n" if crlf else "\n"
    path.write_bytes((end.join(lines) + end).encode())
    return str(path)


CASES = {
    "csv": dict(sep=","),
    "tsv": dict(sep="\t"),
    "space": dict(sep=" "),
    "csv-header": dict(sep=",", header=True),
    "tsv-header": dict(sep="\t", header=True),
    "space-header": dict(sep=" ", header=True),
    "csv-blank-lines": dict(sep=",", blank_every=7),
    "csv-crlf": dict(sep=",", crlf=True),
    "csv-na": dict(sep=",", nan_frac=0.05, na="NA"),
    "csv-empty-field": dict(sep=",", nan_frac=0.05, na=""),
    "tsv-empty-field": dict(sep="\t", nan_frac=0.05, na=""),
    "csv-nan": dict(sep=",", nan_frac=0.05, na="nan"),
    "csv-minus-nan": dict(sep=",", nan_frac=0.05, na="-nan"),
    "tsv-NULL": dict(sep="\t", nan_frac=0.05, na="NULL"),
    "space-None": dict(sep=" ", nan_frac=0.05, na="None"),
    "csv-#N/A": dict(sep=",", nan_frac=0.05, na="#N/A"),
}


def _case(tmp_path, name, n=300):
    c = dict(CASES[name])
    X = _matrix(n, nan_frac=c.pop("nan_frac", 0.0))
    return X, _write(tmp_path / "d.txt", X, **c), c.get("header", False)


@pytest.mark.parametrize("name", sorted(CASES))
def test_native_matches_numpy_and_jax(tmp_path, name, jax_reader):
    """One-shot and streamed: native == numpy == the JAX native reader ==
    the written floats, and no hand-off."""
    X, path, header = _case(tmp_path, name)
    before = _fallbacks()
    fmt = tp.detect_file_format(path, header)
    assert native.detect_format(path, header) == fmt
    assert jp.detect_file_format(path, header) == fmt
    mat = native.parse_file(path, fmt, header)
    _same(mat, X)
    got, names = tp.parse_file(path, has_header=header)
    _same(got, X)
    with numpy_only():
        ref, ref_names = tp.parse_file(path, has_header=header)
        ref_chunks = list(tp.parse_file_chunks(path, header, chunk_rows=64))
    _same(ref, X)
    assert names == ref_names
    jax_mat = jax_reader.parse_file(path, fmt, header)
    if name == "csv-blank-lines":
        # the JAX reader keeps a line of blanks and refuses it in a csv
        assert jax_mat is None
    else:
        _same(jax_mat, X)
    chunks = list(tp.parse_file_chunks(path, header, chunk_rows=64))
    assert [len(c) for c in chunks] == [len(c) for c in ref_chunks] \
        == [64] * 4 + [44]
    _same(np.vstack(chunks), X)
    assert _fallbacks() == before


def test_plain_decimal_forms_bitwise(tmp_path):
    """Every form of the accepted grammar, seeded: signs, leading zeros, a
    bare point on either side, exponents with and without a sign,
    overflow to inf and underflow to 0 and the subnormals, beside
    Python's float of each token."""
    rng = np.random.RandomState(5)

    def token():
        sign = rng.choice(["", "+", "-"])
        digits = "".join(rng.choice(list("0123456789"),
                                    rng.randint(1, 25)))
        point = rng.randint(len(digits) + 1)
        body = rng.choice([digits, digits[:point] + "." + digits[point:],
                           "." + digits, digits + "."])
        exp = rng.choice(["", "e%d" % rng.randint(-330, 330),
                          "E+%03d" % rng.randint(0, 400),
                          "e-%d" % rng.randint(300, 340)])
        return sign + body + exp

    rows = [[token() for _ in range(5)] for _ in range(400)]
    path = tmp_path / "forms.csv"
    path.write_text("\n".join(",".join(r) for r in rows) + "\n")
    want = np.array([[float(t) for t in r] for r in rows])
    assert np.isinf(want).any() and (want == 0).any()
    _same(native.parse_file(str(path), "csv", False), want)
    with numpy_only():
        _same(tp.parse_file(str(path))[0], want)


# Files on which the native reader could differ from the numpy parser:
# it refuses each, and the numpy parser answers (its lenient result, or
# the same exception).
REFUSED = {
    "hex-float": "1,0x1p3,2\n0,1,2\n",
    "inf": "1,inf,2\n0,1,2\n",
    "minus-Infinity": "1,-Infinity,2\n0,1,2\n",
    "nan-payload": "1,nan(123),2\n0,1,2\n",
    "digit-underscore": "1,1_000,2\n0,1,2\n",
    "leading-blank": "1, 1.5,2\n0,1,2\n",
    "trailing-blank": "1,1.5 ,2\n0,1,2\n",
    "tab-in-csv-field": "1,\t1.5,2\n0,1,2\n",
    "stray-tab-later-row": "1,2,3\n0,1\t,2\n",
    "blank-around-NA": "1, NA,2\n0,1,2\n",
    "lone-cr-line-end": "1,2,3\r0,1,2\n4,5,6\n",
    "cr-cr-lf": "1,2,3\r\r\n0,1,2\n",
    "vertical-tab-line": "1,2,3\n\x0b\n0,1,2\n",
    "form-feed-field": "1,2\x0c,3\n0,1,2\n",
    "nbsp": "1,2\xa0,3\n0,1,2\n",
    "non-ascii-digit": "1,٣,3\n0,1,2\n",
    "longer-row": "1,2,3\n0,1,2,3\n",
    "trailing-separator": "1,2,3\n0,1,2,\n",
    "tsv-extra-tab": "1\t2\t3\n0\t1\t2\t\n",
    "space-longer": "1 2 3\n0 1 2 3\n",
    "garbage": "1,2.5abc,3\n0,1,2\n",
    "quoted": '1,"2",3\n0,1,2\n',
    "bare-point": "1,.,3\n0,1,2\n",
    "exponent-without-digits": "1,1e,3\n0,1,2\n",
    "long-token": "1,0." + "1" * 200 + ",3\n0,1,2\n",
}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_refused_files_take_the_numpy_parser(tmp_path, name):
    path = tmp_path / "r.csv"
    path.write_bytes(REFUSED[name].encode())
    path = str(path)
    fmt = tp.detect_file_format(path)
    with pytest.raises(native.Refused):
        native.parse_file(path, fmt, False)
    with pytest.raises(native.Refused):
        list(native.parse_file_chunks(path, fmt, False, 10))

    def outcome(fn):
        try:
            return fn()
        except ValueError as e:  # ParseError too
            return type(e)

    for strict in (False, True):
        with numpy_only():
            want = outcome(lambda: tp.parse_file(path, strict=strict)[0])
        before = _fallbacks()
        got = outcome(lambda: tp.parse_file(path, strict=strict)[0])
        assert _fallbacks() == before + 1
        if isinstance(want, type):
            assert got is want
        else:
            _same(got, want)
    with numpy_only():
        want = outcome(lambda: list(tp.parse_file_chunks(path)))
    got = outcome(lambda: list(tp.parse_file_chunks(path)))
    if isinstance(want, type):
        assert got is want
    else:
        _same(np.vstack(got), np.vstack(want))


@pytest.mark.parametrize("sep", [",", "\t", " "])
def test_short_rows_pad_with_nan(tmp_path, sep, jax_reader):
    """Rows shorter than the first are padded with NaN by every reader."""
    path = tmp_path / "short.txt"
    rows = [["1", "2.5", "3", "4"], ["0", "7"], ["1", "-2e-3", "5"]]
    path.write_text("".join(sep.join(r) + "\n" for r in rows))
    fmt = tp.detect_file_format(str(path))
    want = np.array([[1, 2.5, 3, 4], [0, 7, np.nan, np.nan],
                     [1, -2e-3, 5, np.nan]])
    _same(native.parse_file(str(path), fmt, False), want)
    _same(jax_reader.parse_file(str(path), fmt, False), want)
    with numpy_only():
        _same(tp.parse_file(str(path))[0], want)
    _same(np.vstack(list(tp.parse_file_chunks(str(path), chunk_rows=2))),
          want)


def test_header_with_lone_cr_is_refused(tmp_path):
    path = tmp_path / "h.csv"
    path.write_bytes(b"a,b\rc\n1,2\n3,4\n")
    with pytest.raises(native.Refused):
        native.parse_file(str(path), "csv", True)
    with numpy_only():
        want = tp.parse_file(str(path), has_header=True)
    got = tp.parse_file(str(path), has_header=True)
    _same(got[0], want[0])
    assert got[1] == want[1]


@pytest.mark.parametrize("text,header", [("", False), ("a,b\n", True),
                                         ("\n \n\t\n", False)])
def test_files_without_data_rows(tmp_path, text, header):
    path = tmp_path / "e.csv"
    path.write_text(text)
    with numpy_only():
        want = tp.parse_file(str(path), has_header=header, fmt="csv")
    before = _fallbacks()
    got = tp.parse_file(str(path), has_header=header, fmt="csv")
    assert _fallbacks() == before
    assert got[0].shape == want[0].shape and got[1] == want[1]
    assert list(tp.parse_file_chunks(str(path), header, fmt="csv")) == []


@pytest.mark.parametrize("name", ["csv", "tsv-header", "csv-blank-lines"])
def test_chunks_with_select(tmp_path, name):
    """Two-round loading's first round: the selected rows of each native
    chunk, bitwise the numpy parser's; a malformed row outside the
    selection makes the native reader refuse its chunk, and the numpy
    parser takes over from that chunk's first row."""
    X, path, header = _case(tmp_path, name)
    sel = np.sort(np.random.RandomState(1).choice(len(X), 70, replace=False))
    chunks = list(tp.parse_file_chunks(path, header, chunk_rows=64,
                                       select=sel))
    with numpy_only():
        ref = list(tp.parse_file_chunks(path, header, chunk_rows=64,
                                        select=sel))
    assert [len(c) for c in chunks] == [len(c) for c in ref]
    _same(np.vstack(chunks), X[sel])
    lines = open(path).read().splitlines()
    data = [i for i, ln in enumerate(lines) if ln.strip()][int(header):]
    skipped = next(i for i in range(130, len(X)) if i not in set(sel))
    lines[data[skipped]] = "oops"
    bad = tmp_path / "bad.txt"
    bad.write_text("\n".join(lines) + "\n")
    before = _fallbacks()
    kept = list(tp.parse_file_chunks(str(bad), header, chunk_rows=64,
                                     select=sel))
    assert _fallbacks() == before + 1
    assert [len(c) for c in kept] == [len(c) for c in ref]
    _same(np.vstack(kept), X[sel])
    with pytest.raises(ValueError):
        list(tp.parse_file_chunks(str(bad), header, chunk_rows=64,
                                  select=np.sort(np.append(sel, skipped))))


def test_refused_chunk_mid_stream(tmp_path):
    """A token only numpy reads (inf) in the fourth chunk: the native
    chunks before it stand and the numpy parser reads the rest."""
    X = _matrix(300)
    X[200, 3] = np.inf
    path = tmp_path / "inf.csv"
    path.write_text("".join(",".join("%.17g" % v if np.isfinite(v) else "inf"
                                     for v in row) + "\n" for row in X))
    before = _fallbacks()
    chunks = list(tp.parse_file_chunks(str(path), chunk_rows=64))
    assert _fallbacks() == before + 1
    assert [len(c) for c in chunks] == [64] * 4 + [44]
    _same(np.vstack(chunks), X)


def _libsvm_lines(rng, n=200):
    lines = []
    for i in range(n):
        idx = np.sort(rng.choice(30, rng.randint(0, 6), replace=False))
        toks = ["%d" % rng.randint(0, 2)] + [
            "%d:%.17g" % (j, rng.randn() * 10.0 ** rng.randint(-50, 50))
            for j in idx]
        lines.append(" ".join(toks))
        if i % 50 == 0:
            lines.append("")
    return lines


@pytest.mark.parametrize("header", [False, True])
def test_libsvm_matches_numpy_and_jax(tmp_path, header, jax_reader):
    lines = _libsvm_lines(np.random.RandomState(3))
    lines.append(lines[3] + " 7:1.5 7:2.5")  # a repeated index: the last
    path = tmp_path / "d.svm"
    path.write_text("\n".join((["label f"] if header else []) + lines) + "\n")
    mat = native.parse_file(str(path), "libsvm", header)
    with numpy_only():
        ref, _ = tp.parse_file(str(path), has_header=header)
    _same(mat, ref)
    assert mat[-1, 8] == 2.5
    before = _fallbacks()
    _same(tp.parse_file(str(path), has_header=header)[0], ref)
    assert _fallbacks() == before
    if not header:  # the JAX reader skips the first non-blank line
        _same(jax_reader.parse_file(str(path), "libsvm", False), ref)


@pytest.mark.parametrize("bad", ["2 qid:1 1:0.5", "1 -1:0.5", "1 +3:0.5",
                                 "1 3:", "1 :0.5", "1 1:2:3", "nan 1:0.5",
                                 "1 1:inf", "1 1:0x10", "1 abc"])
def test_libsvm_refused(tmp_path, bad):
    path = tmp_path / "r.svm"
    path.write_text(f"1 1:0.5 2:0.25\n{bad}\n0 2:1\n")
    with pytest.raises(native.Refused):
        native.parse_file(str(path), "libsvm", False)
    with numpy_only():
        want, _ = tp.parse_file(str(path), fmt="libsvm")
    before = _fallbacks()
    got, _ = tp.parse_file(str(path), fmt="libsvm")
    assert _fallbacks() == before + 1
    _same(got, want)


@pytest.mark.parametrize("max_bin", [63, 1000])
def test_value_to_bin_bitwise(max_bin):
    """uint8 (63 bins) and uint16 (1,000 bins) with NaN, +-inf, -0.0 and
    values on the bounds, against BinMapper.value_to_bin."""
    rng = np.random.RandomState(0)
    X = rng.randn(6000, 7) * rng.gamma(1, 1, 7)
    X[:, 3] = rng.randint(0, 40, 6000)
    X[rng.rand(6000, 7) < 0.05] = np.nan
    mappers = find_bin_mappers(X[:3000], total_sample_cnt=3000,
                               max_bin=max_bin)
    X[:40, 0] = mappers[0].bin_upper_bound[:40]
    X[40:45] = np.array([np.inf, -np.inf, -0.0, 0.0, 1e300])[:, None]
    dtype = np.uint8 if max_bin < 256 else np.uint16
    assert max(m.num_bin for m in mappers) > 255 or dtype == np.uint8
    cols = np.array([6, 0, 3, 2], np.int64)
    out = np.empty((6000, len(cols)), dtype)
    assert native.value_to_bin_numerical(
        np.ascontiguousarray(X), cols,
        [mappers[c].bin_upper_bound for c in cols], out)
    for j, c in enumerate(cols):
        np.testing.assert_array_equal(out[:, j],
                                      mappers[c].value_to_bin(X[:, c]))
    with pytest.raises(ValueError):
        native.value_to_bin_numerical(X[:, :3], cols, [], out)


def _categorical_csv(tmp_path, n=3000):
    rng = np.random.RandomState(11)
    X = rng.randn(n, 6)
    X[:, 2] = rng.randint(0, 7, n)
    X[rng.rand(n, 6) < 0.03] = np.nan
    y = (X[:, 0] + (X[:, 2] == 3) + 0.3 * rng.randn(n) > 0).astype(float)
    path = str(tmp_path / "train.csv")
    _write(tmp_path / "train.csv", np.column_stack([y, X]), na="")
    return path


@pytest.mark.parametrize("two_round", [False, True])
def test_dataset_and_cli_bitwise_without_native(tmp_path, two_round):
    """BinnedDataset.from_file (a categorical column, NaN, max_bin 300
    for uint16 bins) and the CLI's model text are bitwise with the native
    reader and under LIGHTGBM_TPU_NO_NATIVE, one-shot and two-round."""
    path = _categorical_csv(tmp_path)
    cfg = lt.Config.from_dict({"categorical_column": "2", "max_bin": 300,
                               "use_two_round_loading": two_round})
    a = BinnedDataset.from_file(path, cfg)
    with numpy_only():
        b = BinnedDataset.from_file(path, cfg)
    assert a.X_bin.dtype == np.uint16
    np.testing.assert_array_equal(a.X_bin, b.X_bin)
    assert [m.to_dict() for m in a.bin_mappers] == \
        [m.to_dict() for m in b.bin_mappers]
    np.testing.assert_array_equal(a.metadata.label, b.metadata.label)
    texts = []
    for env in (contextlib.nullcontext(), numpy_only()):
        out = str(tmp_path / f"m{len(texts)}.txt")
        with env:
            assert cli.main([
                "task=train", f"data={path}", "objective=binary",
                "num_trees=3", "num_leaves=7", "categorical_column=2",
                f"use_two_round_loading={str(two_round).lower()}",
                "verbose=-1", f"output_model={out}"], device="cpu") == 0
        texts.append(open(out).read())
    assert texts[0] == texts[1]


def test_threads_and_switch(tmp_path, monkeypatch):
    """os.cpu_count() threads; LIGHTGBM_TPU_NO_NATIVE keeps every call off
    the native library."""
    assert native.num_threads() == os.cpu_count()
    assert native.available()
    monkeypatch.setenv("LIGHTGBM_TPU_NO_NATIVE", "1")
    assert not native.available()

    def boom():
        raise AssertionError("native library used")

    monkeypatch.setattr(native, "_load", boom)
    X = np.random.RandomState(2).randn(50, 3)
    ds = BinnedDataset.from_matrix(X, Metadata(label=X[:, 0]))
    assert ds.num_data == 50
    path = tmp_path / "x.csv"
    path.write_text("1,2\n3,4\n")
    assert tp.parse_file(str(path))[0].shape == (2, 2)


def test_failed_build_raises(tmp_path, monkeypatch):
    """A source that does not compile raises with the compiler's output
    and names the switch; nothing falls back quietly."""
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "lgbm_native.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(_build, "HOST_CSRC", str(src))
    monkeypatch.setattr(_build, "HOST_DIR", str(tmp_path / "out"))
    with pytest.raises(RuntimeError, match="LIGHTGBM_TPU_NO_NATIVE") as e:
        _build.build_host("native")
    assert "lgbm_native.cpp" in str(e.value)
    assert not os.path.exists(_build.host_lib_path("native"))
