"""Text data parsers: CSV / TSV / LibSVM with format auto-detection.

Counterpart of lightgbm_tpu/io/parser.py, without pandas.  The format is
sniffed from the first data lines (the reference's parser.cpp:72-144);
LibSVM is detected by ``idx:value`` pairs.  A file goes first to the
native reader (``native.py``: OpenMP, the rows parsed in parallel), which
accepts it only where its matrix is bitwise this module's numpy parser's.
Any other file, and every file under ``LIGHTGBM_TPU_NO_NATIVE=1``, takes
the numpy parser; a hand-off is counted (telemetry ``native_fallbacks``)
and logged with the reason.  The numpy parser reads delimited text with
``np.loadtxt``'s C parser when every field is a number; a file with NA
tokens, short or long rows or other malformed fields takes the
line-by-line reader, which gives the JAX package's readers' results:

* an empty field and the tokens of ``NA_TOKENS`` are NaN;
* a row with fewer fields than the first data row is padded with NaN;
* a row with more fields, or a field that is neither a number nor an NA
  token, is malformed: ``strict`` raises :class:`ParseError`, otherwise
  the row is dropped and counted (telemetry ``bad_rows``);
* blank lines are skipped;
* a file whose first data row holds a tab splits on tabs (two tabs in a
  row are an empty field); other non-comma files split on runs of
  blanks.

Every number is converted by a correctly rounded parser (numpy's, or
Python's ``float``), so a value written with ``%.17g`` comes back
bitwise.
"""

from __future__ import annotations

import contextlib
import itertools
from typing import Iterable, Iterator, List, Optional, Tuple

import numpy as np

from .. import native
from ..log import Log
from ..obs import telemetry


class ParseError(ValueError):
    """Malformed input under strict_data=true.  The message names the
    file and the first offending content."""


# the NA spellings of the JAX package's readers (pandas' default set and
# its na_values, as src/native/lgbm_native.cpp lists them)
NA_TOKENS = frozenset((
    "", "NA", "N/A", "NaN", "nan", "NULL", "null", "None", "n/a", "<NA>",
    "#NA", "#N/A", "-NaN", "-nan", "NaT"))


def detect_format(sample_lines: List[str]) -> str:
    """Return one of 'csv', 'tsv', 'libsvm' (parser.cpp:72-144)."""
    for line in sample_lines:
        line = line.strip()
        if not line:
            continue
        tokens = line.replace("\t", " ").replace(",", " ").split()
        colon_tokens = [t for t in tokens[1:] if ":" in t]
        if colon_tokens and all(":" in t for t in tokens[1:]):
            return "libsvm"
        if "\t" in line:
            return "tsv"
        if "," in line:
            return "csv"
        return "tsv"  # space-separated treated as tsv-style whitespace
    return "csv"


def detect_file_format(path: str, has_header: bool = False) -> str:
    """Sniff a file's format from its first data lines."""
    head = _read_head(path, 3 if has_header else 2)
    return detect_format(head[1:] if has_header else head)


def _read_head(path: str, n: int = 2) -> List[str]:
    lines = []
    with open(path, "r") as fh:
        for _ in range(n):
            line = fh.readline()
            if not line:
                break
            lines.append(line)
    return lines


def _separator(fmt: str, probe: str) -> Optional[str]:
    """',' for csv, a tab when the first data row holds one, else None
    (runs of blanks)."""
    if fmt == "csv":
        return ","
    return "\t" if "\t" in probe else None


def _split(line: str, sep: Optional[str]) -> List[str]:
    return line.split() if sep is None else line.split(sep)


def _data_lines(lines: Iterable[str]) -> Iterator[str]:
    """Non-blank lines without their line end."""
    for line in lines:
        line = line.rstrip("\r\n")
        if line.strip():
            yield line


def _parse_delimited(lines: List[str], sep: Optional[str], ncols: int,
                     strict: bool, source: str) -> Tuple[np.ndarray, int]:
    """Rows of ``lines`` (non-blank, no line ends) -> (float64 [n, ncols],
    malformed rows dropped).  ``strict`` raises on the first one."""
    if not lines:
        return np.empty((0, ncols)), 0
    try:
        mat = np.loadtxt(lines, delimiter=sep, dtype=np.float64, ndmin=2,
                         comments=None)
        if mat.shape[1] == ncols:
            return mat, 0
    except ValueError:
        pass
    rows: List[List[float]] = []
    n_bad = 0
    for lineno, line in enumerate(lines, start=1):
        tokens = _split(line, sep)
        try:
            if len(tokens) > ncols:
                raise ValueError(f"expected {ncols} fields, saw "
                                 f"{len(tokens)}")
            row = [np.nan if t.strip() in NA_TOKENS else float(t)
                   for t in tokens]
        except ValueError as e:
            if strict:
                raise ParseError(
                    f"{source}: malformed row {lineno} ({line[:80]!r}): {e} "
                    "(strict_data=true)") from e
            n_bad += 1
            continue
        rows.append(row + [np.nan] * (ncols - len(row)))
    mat = np.asarray(rows, dtype=np.float64).reshape(len(rows), ncols)
    return mat, n_bad


def _hand_off(path: str, refused: "native.Refused") -> None:
    telemetry.count("native_fallbacks", 1)
    Log.warning(f"{path}: the native reader refused the file ({refused}); "
                "the numpy parser reads it")


def _count_bad(source: str, n_bad: int, what: str = "row") -> None:
    if n_bad:
        telemetry.count("bad_rows", n_bad)
        Log.warning(
            f"{source}: skipped {n_bad} malformed {what}(s) "
            "(strict_data=false; set strict_data=true to raise instead)")


def parse_file(
    path: str,
    has_header: bool = False,
    fmt: Optional[str] = None,
    strict: bool = False,
) -> Tuple[np.ndarray, Optional[List[str]]]:
    """Parse a data file into a dense float64 row-matrix.

    Returns (matrix including the label column if present, header names or
    None).  Column-role resolution is the caller's job (DatasetLoader,
    dataset_loader.cpp:23-160).  Malformed rows are a counted, logged skip
    (telemetry ``bad_rows``), or :class:`ParseError` under ``strict``."""
    head = _read_head(path, 2 if not has_header else 3)
    if fmt is None:
        fmt = detect_format(head[1:] if has_header else head)
    names = None
    if has_header and fmt != "libsvm":
        sep = "," if fmt == "csv" else None
        names = [s.strip() for s in (head[0] if head else "").strip()
                 .split(sep)]
    if native.enabled():
        try:
            mat = native.parse_file(path, fmt, has_header)
        except native.Refused as e:
            _hand_off(path, e)
        else:
            if len(mat):
                return mat, names
            return np.empty((0, 1 if fmt == "libsvm" else
                             len(names or ()))), names
    if fmt == "libsvm":
        with open(path, "r") as fh:
            if has_header:
                fh.readline()
            return _parse_libsvm(fh, strict=strict, source=path), None
    with open(path, "r") as fh:
        if has_header:
            fh.readline()
        lines = list(_data_lines(fh))
    if not lines:
        return np.empty((0, len(names or ()))), names
    sep = _separator(fmt, lines[0])
    mat, n_bad = _parse_delimited(lines, sep, len(_split(lines[0], sep)),
                                  strict, path)
    _count_bad(path, n_bad)
    return mat, names


def _parse_libsvm(lines, strict: bool = False,
                  source: str = "<lines>") -> np.ndarray:
    """LibSVM ``label idx:val ...`` lines -> dense matrix (column 0 = label).

    ``lines`` is any iterable of strings.  Malformed lines: counted,
    logged skip (``bad_rows``), or :class:`ParseError` under ``strict``."""
    labels: List[float] = []
    rows: List[Tuple[np.ndarray, np.ndarray]] = []
    max_idx = -1
    n_bad = 0
    for lineno, line in enumerate(lines, start=1):
        parts = line.split()
        if not parts:
            continue
        try:
            label = float(parts[0])
            if len(parts) > 1:
                kv = np.array([p.split(":") for p in parts[1:]])
                idx = kv[:, 0].astype(np.int64)
                val = kv[:, 1].astype(np.float64)
            else:
                idx = np.empty(0, dtype=np.int64)
                val = np.empty(0, dtype=np.float64)
        except (ValueError, IndexError) as e:
            if strict:
                raise ParseError(
                    f"{source}: malformed libsvm line {lineno} "
                    f"({line.strip()[:80]!r}) (strict_data=true)") from e
            n_bad += 1
            continue
        labels.append(label)
        if len(idx):
            max_idx = max(max_idx, int(idx.max()))
        rows.append((idx, val))
    _count_bad(source, n_bad, "libsvm line")
    n, f = len(labels), max_idx + 1
    out = np.zeros((n, f + 1), dtype=np.float64)
    out[:, 0] = labels
    for i, (idx, val) in enumerate(rows):
        out[i, idx + 1] = val
    return out


def count_data_rows(path: str, has_header: bool = False) -> int:
    """Count non-blank data lines by streaming 1MB blocks (TextReader,
    include/LightGBM/utils/text_reader.h:144-288): no parsing, no
    whole-file buffer."""
    n = 0
    carry = b""
    with open(path, "rb") as fh:
        while True:
            block = fh.read(1 << 20)
            if not block:
                break
            lines = (carry + block).split(b"\n")
            carry = lines[-1]
            n += sum(1 for ln in lines[:-1] if ln.strip())
    if carry.strip():
        n += 1  # unterminated final line
    return n - (1 if has_header else 0)


def parse_file_chunks(
    path: str,
    has_header: bool = False,
    fmt: Optional[str] = None,
    chunk_rows: int = 200_000,
    select: Optional[np.ndarray] = None,
):
    """Yield dense float64 row-matrix chunks of a CSV/TSV file.

    The streamed half of two-round loading (dataset_loader.cpp:181-209):
    peak memory is one chunk, not the file.  Every chunk has the first
    data row's width.  With ``select`` (ascending data-row indices) a
    chunk holds only its selected rows, and the other lines are not
    parsed: round one's bin sample, as the reference parses only the
    sampled lines (SampleTextDataFromFile).  A malformed row raises
    ``ValueError`` (rows cannot be dropped once earlier chunks are handed
    out); LibSVM streams through the sparse CSR path instead
    (io/sparse.py)."""
    head = _read_head(path, 2 if not has_header else 3)
    if fmt is None:
        fmt = detect_format(head[1:] if has_header else head)
    if fmt == "libsvm":
        raise ValueError("libsvm streams via the sparse CSR path")
    done = 0  # data rows yielded
    if native.enabled():
        try:
            with contextlib.closing(native.parse_file_chunks(
                    path, fmt, has_header, chunk_rows)) as chunks:
                for mat in chunks:
                    base, done = done, done + len(mat)
                    if select is not None:
                        lo, hi = np.searchsorted(select, [base, done])
                        mat = mat[select[lo:hi] - base]
                    yield mat
            return
        except native.Refused as e:
            _hand_off(path, e)
    yield from _numpy_chunks(path, has_header, fmt, chunk_rows, select, done)


def _numpy_chunks(path: str, has_header: bool, fmt: str, chunk_rows: int,
                  select: Optional[np.ndarray], start: int):
    """``parse_file_chunks`` with numpy from data row ``start`` on (the
    rows before it are skipped unparsed)."""
    with open(path, "r") as fh:
        if has_header:
            fh.readline()
        lines = _data_lines(fh)
        first = next(lines, None)
        if first is None:
            return
        sep = _separator(fmt, first)
        ncols = len(_split(first, sep))
        lines = itertools.islice(itertools.chain([first], lines), start, None)
        offset = start
        while True:
            chunk = list(itertools.islice(lines, chunk_rows))
            if not chunk:
                return
            if select is not None:
                base, offset = offset, offset + len(chunk)
                lo, hi = np.searchsorted(select, [base, offset])
                chunk = [chunk[i - base] for i in select[lo:hi]]
            try:
                mat, _ = _parse_delimited(chunk, sep, ncols, True, path)
            except ParseError as e:
                raise ValueError(str(e)) from None
            yield mat


def parse_lines(lines: List[str], fmt: Optional[str] = None) -> np.ndarray:
    """Parse in-memory text lines, strictly: prediction outputs are joined
    to inputs by row number, so a skipped line would misattribute every
    later prediction."""
    if fmt is None:
        fmt = detect_format(lines[:2])
    if fmt == "libsvm":
        return _parse_libsvm(lines, strict=True)
    rows = list(_data_lines(lines))
    if not rows:
        return np.empty((0, 0))
    sep = "," if fmt == "csv" else None
    return _parse_delimited(rows, sep, len(_split(rows[0], sep)), True,
                            "<lines>")[0]
