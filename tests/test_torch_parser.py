"""The port's text parser (numpy only) against the JAX package's.

The same seeded numpy data, written with ``%.17g``, goes through
``lightgbm_tpu.io.parser`` (its native reader where it built, else pandas)
and ``lightgbm_tpu_torch.io.parser``: CSV, tab-separated, space-separated
and LibSVM files, with and without a header, with blank lines and NA
tokens.  Values are held bitwise (NaN where NaN): every reader here
rounds correctly, and ``%.17g`` round-trips a float64.  The JAX
package's lenient re-read and ``parse_lines`` go through pandas, whose
float parser is not correctly rounded: those are held to ``PANDAS_RTOL``
(relative 1e-14), and the port's values to the written floats bitwise.
The lenient path drops the same rows and counts them in ``bad_rows``;
strict mode raises ``ParseError``.  The binned matrices of both packages
are held bitwise.
"""

import numpy as np
import pytest

from lightgbm_tpu.io import parser as jp
from lightgbm_tpu.io.binner import find_bin_mappers as jax_find
from lightgbm_tpu.obs import telemetry as jax_tel

from lightgbm_tpu_torch.io import parser as tp
from lightgbm_tpu_torch.io.binner import find_bin_mappers
from lightgbm_tpu_torch.obs import telemetry as port_tel

# pandas' float parser (the JAX package's lenient re-read and parse_lines)
# is not correctly rounded: up to 12 ulp from the written float64 on this
# data (measured), 3e-15 relative
PANDAS_RTOL = 1e-14


def _matrix(n=300, f=5, seed=0, nan_frac=0.0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f) * np.array([1e-3, 1.0, 1e3, 7.0, 1e8])[:f]
    X[:, 0] = rng.randint(0, 2, n)  # the label column
    if nan_frac:
        X[rng.rand(n, f) < nan_frac] = np.nan
        X[:, 0] = rng.randint(0, 2, n)
    return X


def _write(path, X, sep=",", header=None, blank_every=0, na="NA"):
    lines = []
    if header:
        lines.append(sep.join(header))
    for i, row in enumerate(X):
        lines.append(sep.join(na if np.isnan(v) else "%.17g" % v
                              for v in row))
        if blank_every and i % blank_every == blank_every - 1:
            lines.append("")
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    np.testing.assert_array_equal(np.nan_to_num(a), np.nan_to_num(b))


CASES = {
    "csv": dict(sep=","),
    "tsv": dict(sep="\t"),
    "space": dict(sep=" "),
    "csv-header": dict(sep=",", header=True),
    "tsv-header": dict(sep="\t", header=True),
    "csv-blank-lines": dict(sep=",", blank_every=7),
    "csv-na": dict(sep=",", nan_frac=0.05, na="NA"),
    "csv-empty-field": dict(sep=",", nan_frac=0.05, na=""),
    "csv-nan-token": dict(sep=",", nan_frac=0.05, na="nan"),
    "tsv-NaN-token": dict(sep="\t", nan_frac=0.05, na="NaN"),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_parse_file_matches_jax(tmp_path, name):
    c = dict(CASES[name])
    X = _matrix(nan_frac=c.pop("nan_frac", 0.0))
    header = [f"c{j}" for j in range(X.shape[1])] if c.pop("header", False) \
        else None
    path = _write(tmp_path / "d.txt", X, header=header, **c)
    has_header = header is not None
    assert tp.detect_file_format(path, has_header) == \
        jp.detect_file_format(path, has_header)
    mt, nt = tp.parse_file(path, has_header=has_header)
    mj, nj = jp.parse_file(path, has_header=has_header)
    _same(mt, mj)
    _same(mt, X)
    assert nt == nj
    chunks_t = list(tp.parse_file_chunks(path, has_header, chunk_rows=64))
    chunks_j = list(jp.parse_file_chunks(path, has_header, chunk_rows=64))
    assert [len(c) for c in chunks_t] == [len(c) for c in chunks_j]
    _same(np.vstack(chunks_t), np.vstack(chunks_j))
    assert tp.count_data_rows(path, has_header) == \
        jp.count_data_rows(path, has_header) == len(X)


@pytest.mark.parametrize("name", ["csv", "tsv-header", "csv-blank-lines"])
def test_chunks_parse_only_selected_rows(tmp_path, name):
    """``parse_file_chunks(select=...)`` (two-round loading's first round)
    yields each chunk's selected rows, bitwise the JAX package's parse of
    the whole file at those rows, and does not parse the other lines: a
    malformed row outside the selection passes, one inside raises."""
    c = dict(CASES[name])
    X = _matrix(nan_frac=c.pop("nan_frac", 0.0))
    header = [f"c{j}" for j in range(X.shape[1])] if c.pop("header", False) \
        else None
    path = _write(tmp_path / "d.txt", X, header=header, **c)
    has_header = header is not None
    sel = np.sort(np.random.RandomState(1).choice(len(X), 70, replace=False))
    chunks = list(tp.parse_file_chunks(path, has_header, chunk_rows=64,
                                       select=sel))
    assert len(chunks) == -(-len(X) // 64)
    _same(np.vstack(chunks), jp.parse_file(path, has_header)[0][sel])
    lines = open(path).read().splitlines()
    data = [i for i, ln in enumerate(lines) if ln.strip()][int(has_header):]
    skipped = next(i for i in range(2, len(X)) if i not in set(sel))
    lines[data[skipped]] = "oops"
    bad = tmp_path / "bad.txt"
    bad.write_text("\n".join(lines) + "\n")
    kept = list(tp.parse_file_chunks(str(bad), has_header, chunk_rows=64,
                                     select=sel))
    _same(np.vstack(kept), np.vstack(chunks))
    with pytest.raises(ValueError):
        list(tp.parse_file_chunks(str(bad), has_header, chunk_rows=64,
                                  select=np.sort(np.append(sel, skipped))))


def test_short_rows_pad_with_nan(tmp_path):
    path = tmp_path / "short.csv"
    path.write_text("1,2,3\n4,5\n6,7,8\n")
    mt, _ = tp.parse_file(str(path))
    mj, _ = jp.parse_file(str(path))
    _same(mt, mj)
    assert np.isnan(mt[1, 2])


@pytest.mark.parametrize("bad", ["1,abc,3", "1,2,3,4", "1,2.5x,3"])
def test_lenient_drops_the_same_rows(tmp_path, bad):
    X = _matrix(60, 3)
    lines = [",".join("%.17g" % v for v in row) for row in X]
    lines[10] = bad
    lines[40] = bad
    path = tmp_path / "bad.csv"
    path.write_text("\n".join(lines) + "\n")
    counts = []
    out = []
    for mod, tel in ((tp, port_tel), (jp, jax_tel)):
        before = tel.get_telemetry().snapshot()["counters"].get("bad_rows", 0)
        out.append(mod.parse_file(str(path))[0])
        after = tel.get_telemetry().snapshot()["counters"].get("bad_rows", 0)
        counts.append(after - before)
    # the JAX package's lenient re-read is pandas' (not correctly
    # rounded): held to PANDAS_RTOL; the port's values are the written
    # floats bitwise
    assert out[0].shape == out[1].shape
    np.testing.assert_allclose(out[0], out[1], rtol=PANDAS_RTOL, atol=0)
    assert counts == [2, 2]
    _same(out[0], np.delete(X, [10, 40], axis=0))
    with pytest.raises(tp.ParseError, match="strict_data"):
        tp.parse_file(str(path), strict=True)
    with pytest.raises(ValueError):
        list(tp.parse_file_chunks(str(path)))


def test_libsvm_matches_jax(tmp_path):
    rng = np.random.RandomState(3)
    lines = []
    for i in range(200):
        idx = np.sort(rng.choice(30, rng.randint(0, 6), replace=False))
        toks = ["%d" % rng.randint(0, 2)] + [
            "%d:%.17g" % (j, rng.randn()) for j in idx]
        lines.append(" ".join(toks))
        if i % 50 == 0:
            lines.append("")
    path = tmp_path / "d.svm"
    path.write_text("\n".join(lines) + "\n")
    assert tp.detect_file_format(str(path)) == "libsvm"
    mt, _ = tp.parse_file(str(path))
    mj, _ = jp.parse_file(str(path))
    _same(mt, mj)
    _same(tp.parse_lines(lines), mj)
    bad = lines[:5] + ["1 3:x"] + lines[5:]
    with pytest.raises(tp.ParseError):
        tp._parse_libsvm(bad, strict=True)
    _same(tp._parse_libsvm(bad), jp._parse_libsvm(bad))


def test_parse_lines_matches_jax():
    X = _matrix(40, 4)
    for sep, fmt in ((",", "csv"), (" ", "tsv"), ("\t", "tsv")):
        lines = [sep.join("%.17g" % v for v in row) for row in X]
        # the JAX package parses lines with pandas: PANDAS_RTOL
        np.testing.assert_allclose(tp.parse_lines(lines),
                                   jp.parse_lines(lines), rtol=PANDAS_RTOL,
                                   atol=0)
        _same(tp.parse_lines(lines), X)
        _same(tp.parse_lines(lines, fmt), X)
    with pytest.raises(tp.ParseError):
        tp.parse_lines(["1,2", "3,x"])


def test_binned_matrix_bitwise(tmp_path):
    X = _matrix(2000, 5, seed=9, nan_frac=0.02)
    path = _write(tmp_path / "d.csv", X)
    mt, _ = tp.parse_file(path)
    mj, _ = jp.parse_file(path)
    port = find_bin_mappers(mt[:, 1:], total_sample_cnt=len(mt), max_bin=63)
    ref = jax_find(mj[:, 1:], total_sample_cnt=len(mj), max_bin=63)
    for j, (a, b) in enumerate(zip(port, ref)):
        assert a.to_dict() == b.to_dict()
        np.testing.assert_array_equal(a.value_to_bin(mt[:, j + 1]),
                                      b.value_to_bin(mj[:, j + 1]))
