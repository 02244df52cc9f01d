"""Batch serving tier: overlapped parse -> predict -> write file prediction.

Counterpart of lightgbm_tpu/serving/batch.py.  The reference's serving
story is a streamed batch file predictor (predictor.hpp:24-155, streamed
at :82).  This module pipelines its three stages across threads:

* a **reader** thread prefetches the next parsed chunk
  (io/parser.parse_file_chunks) while the card predicts the current one
  (bounded queue: peak memory stays ~``prefetch`` chunks),
* the main thread **predicts** (``Booster.predict``: one launch of kernel
  P1 a chunk on the card),
* a **writer** thread formats and writes completed chunks under the
  crash-safe ``atomic_writer`` (a failure anywhere leaves the destination
  untouched).

Formatting goes through the one :func:`format_block` that the pipelined
and the sequential path share, and per-row predictions do not depend on
the chunking, so both paths write the same bytes.  ``stats`` reports the
reader's, P1's and the writer's seconds beside the wall time.
"""

from __future__ import annotations

import os
import queue as _queue
import threading
import time
from typing import Iterator, Optional

import numpy as np

from ..obs import flightrec, telemetry
from ..resilience.atomic import atomic_writer

# inputs above this size stream through parse_file_chunks (the
# reference's Predictor also streams, predictor.hpp:82); small or
# LibSVM inputs take the one-shot path
DEFAULT_STREAM_THRESHOLD = 1 << 28  # 256MB
DEFAULT_CHUNK_ROWS = 200_000
_PREFETCH = 2

_EOF = object()


class _StageError:
    """Exception carrier across stage queues."""

    __slots__ = ("exc",)

    def __init__(self, exc: BaseException) -> None:
        self.exc = exc


def format_block(out: np.ndarray) -> str:
    """One chunk's result lines, byte-identical to the reference-style
    writer (one line per row, ``%.9g``, tab-separated multi-output).
    The single formatting implementation every batch path shares."""
    out = np.asarray(out)
    if out.ndim == 1:
        return "".join(f"{v:.9g}\n" for v in out)
    return "".join(
        "\t".join(f"{v:.9g}" for v in row) + "\n" for row in out)


def _feature_chunks(booster, data_path: str, has_header: bool, fmt: str,
                    chunk_rows: int) -> Iterator[np.ndarray]:
    """Parsed feature chunks with the label column dropped — the parse
    stage, separable into a prefetch thread."""
    from ..io.parser import parse_file_chunks

    label_idx = booster._gbdt.label_idx
    max_feat = booster._gbdt.max_feature_idx
    for chunk in parse_file_chunks(data_path, has_header, fmt,
                                   chunk_rows=chunk_rows):
        if chunk.shape[1] > max_feat + 1:
            chunk = np.delete(chunk, label_idx, axis=1)
        yield chunk


def _stream_plan(data_path: str, has_header: bool,
                 stream_threshold: int):
    """(fmt, streamed?) — LibSVM and small files take the one-shot
    path, exactly the old Predictor's routing."""
    from ..io.parser import detect_file_format

    fmt = detect_file_format(data_path, has_header)
    big = os.path.getsize(data_path) > stream_threshold
    return fmt, (fmt != "libsvm" and big)


def predict_chunk_stream(booster, data_path: str, has_header: bool = False,
                         num_iteration: int = -1, raw_score: bool = False,
                         pred_leaf: bool = False,
                         stream_threshold: int = DEFAULT_STREAM_THRESHOLD,
                         chunk_rows: int = DEFAULT_CHUNK_ROWS
                         ) -> Iterator[np.ndarray]:
    """Yield prediction arrays chunk by chunk (the parity seam: the
    streamed and one-shot paths build the SAME ``kw`` once and route
    every chunk through the same ``booster.predict``)."""
    kw = dict(num_iteration=num_iteration, raw_score=raw_score,
              pred_leaf=pred_leaf)
    fmt, streamed = _stream_plan(data_path, has_header, stream_threshold)
    if not streamed:
        yield booster.predict(data_path, data_has_header=has_header, **kw)
        return
    for chunk in _feature_chunks(booster, data_path, has_header, fmt,
                                 chunk_rows):
        yield booster.predict(chunk, **kw)


def _put_unless_aborted(out_q: _queue.Queue, item,
                        abort: threading.Event) -> bool:
    """``put`` that gives up when the pipeline aborts — the bounded
    queue must never strand the reader thread (holding the input file
    and parsed chunks) behind a consumer that already failed."""
    while not abort.is_set():
        try:
            out_q.put(item, timeout=0.1)
            return True
        except _queue.Full:
            continue
    return False


def _reader(gen: Iterator[np.ndarray], out_q: _queue.Queue,
            abort: threading.Event, state: dict) -> None:
    """Parse chunks into ``out_q``; ``state["read_s"]`` is the parse
    time."""
    try:
        while True:
            t0 = time.perf_counter()
            chunk = next(gen, _EOF)
            state["read_s"] += time.perf_counter() - t0
            if not _put_unless_aborted(out_q, chunk, abort) or chunk is _EOF:
                return
    except BaseException as e:  # noqa: BLE001 — carried to the main thread
        _put_unless_aborted(out_q, _StageError(e), abort)


def _writer(fh, in_q: _queue.Queue, state: dict) -> None:
    """Format prediction chunks and write them into the (atomic) file
    handle; ``state["write_s"]`` is the time it takes.  On a failure, keep
    draining so the producer never blocks on a full queue; the exception
    re-raises in the main thread."""
    while True:
        out = in_q.get()
        if out is _EOF:
            return
        if state.get("exc") is not None:
            continue  # drain-only after a failure
        t0 = time.perf_counter()
        try:
            fh.write(format_block(out))
        except BaseException as e:  # noqa: BLE001 — re-raised by main
            state["exc"] = e
        state["write_s"] += time.perf_counter() - t0


def pipelined_predict_file(booster, data_path: str, result_path: str,
                           has_header: bool = False,
                           num_iteration: int = -1,
                           raw_score: bool = False,
                           pred_leaf: bool = False,
                           stream_threshold: int = DEFAULT_STREAM_THRESHOLD,
                           chunk_rows: int = DEFAULT_CHUNK_ROWS,
                           overlap: bool = True,
                           prefetch: int = _PREFETCH) -> dict:
    """Predict ``data_path`` into ``result_path`` (crash-safe write).

    ``overlap=True`` runs the three-stage pipeline; ``overlap=False``
    is the strictly sequential path.  Both produce byte-identical output.
    Returns ``{rows, chunks, wall_s, parse_wait_s}``, and on the
    pipelined path the reader's ``read_s``, the main thread's
    ``predict_s`` and the writer's ``write_s`` (host seconds; the P1
    launches end in the host copy of each chunk's result, so
    ``predict_s`` holds their device time)."""
    t0 = time.perf_counter()
    kw = dict(num_iteration=num_iteration, raw_score=raw_score,
              pred_leaf=pred_leaf)
    fmt, streamed = _stream_plan(data_path, has_header, stream_threshold)
    stats = {"rows": 0, "chunks": 0, "parse_wait_s": 0.0,
             "streamed": streamed, "overlap": bool(overlap and streamed)}

    if not streamed or not overlap:
        # sequential path (also the one-shot path): parse+predict via
        # the shared chunk stream, write under the same atomic protocol
        with atomic_writer(result_path) as fh:
            for out in predict_chunk_stream(
                    booster, data_path, has_header=has_header,
                    stream_threshold=stream_threshold,
                    chunk_rows=chunk_rows, **kw):
                fh.write(format_block(out))
                stats["rows"] += len(np.asarray(out))
                stats["chunks"] += 1
        stats["wall_s"] = time.perf_counter() - t0
        return stats

    stats["predict_s"] = 0.0
    q_parse: _queue.Queue = _queue.Queue(maxsize=max(1, prefetch))
    q_write: _queue.Queue = _queue.Queue(maxsize=max(1, prefetch))
    wstate: dict = {"exc": None, "write_s": 0.0}
    rstate: dict = {"read_s": 0.0}
    abort = threading.Event()
    chunks = _feature_chunks(booster, data_path, has_header, fmt,
                             chunk_rows)
    reader = threading.Thread(target=_reader,
                              args=(chunks, q_parse, abort, rstate),
                              name="lgbm-batch-reader", daemon=True)
    with telemetry.span("serving.batch.predict_file"):
        with atomic_writer(result_path) as fh:
            writer = threading.Thread(target=_writer,
                                      args=(fh, q_write, wstate),
                                      name="lgbm-batch-writer",
                                      daemon=True)
            reader.start()
            writer.start()
            try:
                while True:
                    tw = time.perf_counter()
                    item = q_parse.get()
                    stats["parse_wait_s"] += time.perf_counter() - tw
                    if item is _EOF:
                        break
                    if isinstance(item, _StageError):
                        raise item.exc
                    tp = time.perf_counter()
                    out = booster.predict(item, **kw)
                    stats["predict_s"] += time.perf_counter() - tp
                    stats["rows"] += len(np.asarray(out))
                    stats["chunks"] += 1
                    q_write.put(out)
            except BaseException:
                # unblock the reader (it may be parked on the bounded
                # q_parse) so it releases the input file + its chunks
                abort.set()
                raise
            finally:
                q_write.put(_EOF)
                writer.join()
                reader.join(5.0)
            if wstate["exc"] is not None:
                raise wstate["exc"]
        # atomic_writer commits (fsync + rename) only when no stage
        # failed; any failure above leaves the destination untouched
    stats["read_s"] = rstate["read_s"]
    stats["write_s"] = wstate["write_s"]
    stats["wall_s"] = time.perf_counter() - t0
    # files and their rows move together — one consistent add
    telemetry.count_many({"serving.batch.files": 1,
                          "serving.batch.rows": stats["rows"]})
    flightrec.record("batch_predict", rows=stats["rows"],
                     chunks=stats["chunks"], result=result_path)
    return stats
