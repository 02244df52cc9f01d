"""Crash-safe artifact writes: tmp file + fsync + rename (+ checksum).

Every result artifact this repo commits or serves from — model files,
run manifests, ``.bench/*.json``, COPYCHECK.json, prediction outputs —
used to be written with a bare ``open(path, "w")``.  A preemption
mid-write then leaves *half a file under the real name*: a truncated
model that silently loads fewer trees, half a JSON that benchdiff
chokes on.  ``atomic_write`` closes the hole:

1. write to ``<path>.tmp.<pid>`` in the SAME directory (rename must not
   cross filesystems),
2. flush + ``os.fsync`` the tmp file (a rename of un-synced data can
   still surface as an empty file after power loss),
3. ``os.replace`` onto the final name (atomic on POSIX),
4. best-effort fsync of the directory entry.

With ``checksum=True`` a ``<path>.sha256`` sidecar records the content
digest; :func:`verify_sidecar` turns "is this artifact intact?" into a
loud yes/no instead of a guess.

A copy of the JAX package's ``resilience/atomic.py``: stdlib only; its
one dependency in the package is the fault-injection hook.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
from typing import Any, Iterator, Optional

from . import faults


class ArtifactCorrupt(Exception):
    """An artifact failed its checksum/shape validation.  The message is
    actionable: it names the file, what mismatched, and what to do."""


class _DigestWriter:
    """File-handle proxy teeing every write through a running sha256
    (builtin file objects reject attribute assignment, so the tee is a
    wrapper, not a monkeypatch)."""

    def __init__(self, fh, digest) -> None:
        self._fh = fh
        self._digest = digest

    def write(self, data):
        self._digest.update(data.encode() if isinstance(data, str) else data)
        return self._fh.write(data)

    def writelines(self, lines):
        # must route through write(): proxying writelines straight to
        # the file would ship bytes the digest never saw, committing a
        # sidecar that flags the intact artifact as corrupt
        for line in lines:
            self.write(line)

    def __getattr__(self, name):
        return getattr(self._fh, name)


def sidecar_path(path: str) -> str:
    """Checksum sidecar location for an artifact: ``foo.txt`` ->
    ``foo.txt.sha256`` (self-pairing, survives renames of the pair)."""
    return path + ".sha256"


def _fsync_dir(path: str) -> None:
    """Best-effort directory-entry durability after a rename (not
    supported on some filesystems; never a reason to fail the write)."""
    dirname = os.path.dirname(os.path.abspath(path))
    try:
        fd = os.open(dirname, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
    except OSError:
        pass


@contextlib.contextmanager
def atomic_writer(path: str, mode: str = "w",
                  checksum: bool = False) -> Iterator[Any]:
    """Context manager yielding a file handle whose contents only ever
    appear under ``path`` complete: commit (fsync + rename) on clean
    exit, tmp-file cleanup on exception.  ``mode`` is ``"w"`` or
    ``"wb"``.  The streaming counterpart of :func:`atomic_write`
    (cli.py's chunked prediction writer)."""
    if mode not in ("w", "wb"):
        raise ValueError(f"atomic_writer mode must be 'w' or 'wb', got {mode!r}")
    tmp = f"{path}.tmp.{os.getpid()}"
    digest = hashlib.sha256() if checksum else None

    fh = open(tmp, mode)
    try:
        yield fh if digest is None else _DigestWriter(fh, digest)
        fh.flush()
        os.fsync(fh.fileno())
        fh.close()
        faults.maybe_fail_write(path)  # LGBM_TPU_FAULT=fail_write_once:
        # injected BEFORE the rename — the destination must stay intact
        if digest is not None:
            # drop any stale sidecar BEFORE the artifact rename: a crash
            # between the rename and the new sidecar write must leave
            # "new artifact, no sidecar" (verify_sidecar -> None, valid)
            # — never "new artifact, OLD sidecar", which would flag an
            # intact file as corrupt
            with contextlib.suppress(OSError):
                os.remove(sidecar_path(path))
        os.replace(tmp, path)
        _fsync_dir(path)
        if digest is not None:
            _write_sidecar(path, digest.hexdigest())
    except BaseException:
        with contextlib.suppress(OSError):
            fh.close()
        with contextlib.suppress(OSError):
            os.remove(tmp)
        raise


def _write_sidecar(path: str, hexdigest: str) -> None:
    """The sidecar itself is written atomically (no fault hook: a
    sidecar-less artifact is valid; a half sidecar is not)."""
    tmp = f"{sidecar_path(path)}.tmp.{os.getpid()}"
    with open(tmp, "w") as fh:
        fh.write(hexdigest + "  " + os.path.basename(path) + "\n")
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, sidecar_path(path))


def atomic_write(path: str, data, mode: str = "w",
                 checksum: bool = False) -> str:
    """Write ``data`` (str or bytes) to ``path`` atomically.  Returns
    ``path``.  See module docstring for the crash-safety contract."""
    if isinstance(data, bytes) and mode == "w":
        mode = "wb"
    with atomic_writer(path, mode, checksum=checksum) as fh:
        fh.write(data)
    return path


def atomic_write_json(path: str, obj: Any, indent: Optional[int] = 1,
                      sort_keys: bool = True, checksum: bool = False) -> str:
    """The ``json.dump`` replacement every artifact writer uses: one
    serialization, then the atomic commit."""
    return atomic_write(
        path, json.dumps(obj, indent=indent, sort_keys=sort_keys) + "\n",
        checksum=checksum)


def file_sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        for block in iter(lambda: fh.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def verify_sidecar(path: str) -> Optional[str]:
    """Check ``path`` against its ``.sha256`` sidecar.

    Returns the verified hex digest, or None when no sidecar exists
    (not an error: checksums are opt-in per artifact).  Raises
    :class:`ArtifactCorrupt` on mismatch or a missing artifact."""
    sc = sidecar_path(path)
    if not os.path.exists(sc):
        return None
    with open(sc) as fh:
        expect = fh.read().split()[0].strip()
    if not os.path.exists(path):
        raise ArtifactCorrupt(
            f"{path}: sidecar {sc} exists but the artifact is missing — "
            "the write was interrupted before commit; regenerate the "
            "artifact or delete the stale sidecar")
    got = file_sha256(path)
    if got != expect:
        raise ArtifactCorrupt(
            f"{path}: content sha256 {got[:16]}… does not match sidecar "
            f"{expect[:16]}… — the artifact was truncated or modified "
            "after it was written; regenerate it (or delete both files "
            "if it is disposable)")
    return got
