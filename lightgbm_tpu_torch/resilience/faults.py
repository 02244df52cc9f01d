"""Deterministic fault injection for the paths the port has: the training
loop and its checkpoints, the atomic write, the serving hot-swap, the
serving dispatch, the training gradients and the guarded collective.

A copy of the JAX package's ``resilience/faults.py`` (stdlib only)
without the hooks of ``obs/dist``.  ``LGBM_TPU_FAULT`` holds a
comma-separated list of fault specs:

==========================  ====================================================
spec                        injection point
==========================  ====================================================
``kill_after_tree:K``       cli train loop raises SIGTERM to the process the
                            moment iteration K completes — the real
                            preemption signal through the real handler
                            (resilience/checkpoint.py)
``hang_after_tree:K[:S]``   cli train loop stalls for S seconds (default
                            3600) the moment iteration K completes, after
                            any due checkpoint — the stand-in for a wedged
                            collective that a supervisor's heartbeat
                            deadline must notice
``corrupt_checkpoint``      every checkpoint write is followed by
                            overwriting bytes mid-file — resume must refuse
                            it loudly
``fail_collective_once``    the first guarded collective raises a fake
                            ``UNAVAILABLE`` (resilience/retry.py) —
                            exercises retry_transient
``fail_write_once``         first atomic_write fails before its rename —
                            the destination must stay intact
``corrupt_model``           every serving hot-swap candidate is corrupted
                            mid-file before verification
                            (serving/hotswap.py) — the swap must be
                            refused and the old model keeps answering
``oom_dispatch``            the next serve dispatch raises a fake
                            ``RESOURCE_EXHAUSTED`` (self-consuming) —
                            exercises the OOM classifier + flight
                            recorder post-mortem (obs/memory.py)
``nan_grads:J``             at boosting iteration J, the first gradient of
                            every class becomes NaN and its hessian +inf
                            (models/gbdt.py) — exercises the non-finite
                            guards (resilience/guards.py)
==========================  ====================================================

The JAX package's ``delay_collective`` and ``desync_step`` belong to
``obs/dist``, not ported, and raise ``NotImplementedError`` naming ROADMAP
A8 step 3.  The env var is read once at import; tests inject in-process via
:func:`set_fault` / :func:`clear_faults`.  ``*_once`` faults
self-consume.
"""

from __future__ import annotations

import os
import signal
from typing import Dict, Optional

_VALID = ("kill_after_tree", "hang_after_tree", "corrupt_checkpoint",
          "fail_collective_once", "fail_write_once", "corrupt_model",
          "oom_dispatch", "nan_grads")
# the JAX package's kinds whose injection points (obs/dist) are not ported
_NOT_PORTED = ("delay_collective", "desync_step")


class InjectedFault(Exception):
    """Base for all injected failures — distinguishable from real ones
    in test assertions, indistinguishable in the recovery paths (which
    must not special-case it)."""


class InjectedWriteError(InjectedFault, OSError):
    pass


class InjectedCollectiveError(InjectedFault, RuntimeError):
    pass


class InjectedResourceExhausted(InjectedFault, RuntimeError):
    """Fake device OOM.  The message carries the literal
    ``RESOURCE_EXHAUSTED`` marker, matching what XlaRuntimeError puts
    in-text, so the classifier (obs/memory.is_oom_error) keys on text
    as it does for an allocator failure that is not
    ``torch.cuda.OutOfMemoryError``."""


def _parse(spec: str) -> Dict[str, Optional[str]]:
    out: Dict[str, Optional[str]] = {}
    for part in (spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        kind, _, param = part.partition(":")
        if kind in _NOT_PORTED:
            raise NotImplementedError(
                f"LGBM_TPU_FAULT kind {kind!r} is not ported to "
                "lightgbm_tpu_torch yet (ROADMAP queue A8 step 3: "
                "obs/dist)")
        if kind not in _VALID:
            raise ValueError(
                f"unknown LGBM_TPU_FAULT kind {kind!r} "
                f"(valid: {', '.join(_VALID)})")
        out[kind] = param or None
    return out


_FAULTS: Dict[str, Optional[str]] = _parse(os.environ.get("LGBM_TPU_FAULT", ""))
_CONSUMED: set = set()


def set_fault(spec: str) -> None:
    """Replace the active fault set in-process (tests)."""
    global _FAULTS
    _FAULTS = _parse(spec)
    _CONSUMED.clear()


def clear_faults() -> None:
    set_fault("")


def fault_active(kind: str) -> Optional[str]:
    """The fault's param ("" when parameterless) or None when inactive
    (or already consumed, for ``*_once`` kinds)."""
    if kind not in _FAULTS or kind in _CONSUMED:
        return None
    return _FAULTS[kind] or ""


def _consume(kind: str) -> None:
    _CONSUMED.add(kind)


def _note(kind: str, **fields) -> None:
    """Record the injection in the flight recorder (lazy import — this
    module must stay importable with nothing but the stdlib; a chaos
    post-mortem that does not show its own injected faults would send
    the reader chasing a phantom)."""
    try:
        from ..obs import flightrec

        flightrec.record("fault_injected", fault=kind, **fields)
    except Exception:  # noqa: BLE001 — never let observability break injection
        pass


# ------------------------------------------------------- injection points
def kill_after_tree() -> Optional[int]:
    """Iteration count after which the training loop should receive
    SIGTERM, or None."""
    p = fault_active("kill_after_tree")
    return int(p) if p else None


def maybe_kill(completed_iterations: int) -> None:
    """cli train-loop hook: raise the REAL preemption signal to this
    process once iteration K has completed (the handler then finishes
    bookkeeping and checkpoints, exactly as under a fleet preemption)."""
    k = kill_after_tree()
    if k is not None and completed_iterations == k:
        _consume("kill_after_tree")
        _note("kill_after_tree", iteration=completed_iterations)
        os.kill(os.getpid(), signal.SIGTERM)


def maybe_hang(completed_iterations: int) -> None:
    """cli train-loop hook: stall for S seconds once iteration K has
    completed, without heartbeating: from a supervisor's seat this is a
    wedged collective, which its heartbeat deadline must notice."""
    p = fault_active("hang_after_tree")
    if p is None:
        return
    k, _, secs = p.partition(":")
    if completed_iterations != int(k or 0):
        return
    _consume("hang_after_tree")
    stall_s = float(secs) if secs else 3600.0
    _note("hang_after_tree", iteration=completed_iterations,
          stall_s=stall_s)
    import time

    time.sleep(stall_s)


def maybe_fail_write(path: str) -> None:
    """atomic_write hook, fired after the tmp file is written but BEFORE
    the rename: the crash window the atomic protocol exists to survive."""
    if fault_active("fail_write_once") is not None:
        _consume("fail_write_once")
        _note("fail_write_once", path=path)
        raise InjectedWriteError(
            f"injected write failure before committing {path}")


def _overwrite_mid_file(path: str) -> None:
    """Overwrite bytes in the middle of ``path`` with ASCII filler.
    ASCII (not bit-flips) so a text format usually stays *parseable*
    and the corruption is caught by the content CHECKSUM — the deepest
    validation layer; when the filler happens to break the structure
    instead, the shallower unreadable-file error path is exercised."""
    size = os.path.getsize(path)
    with open(path, "r+b") as fh:
        fh.seek(size // 2)
        fh.write(b"A" * min(16, max(1, size // 2)))


def maybe_fail_collective() -> None:
    """Guarded-collective hook: one fake transient failure, in the
    vocabulary real collective stacks use (retry_transient keys on it)."""
    if fault_active("fail_collective_once") is not None:
        _consume("fail_collective_once")
        _note("fail_collective_once")
        raise InjectedCollectiveError(
            "UNAVAILABLE: injected transient collective failure")


def maybe_corrupt_checkpoint(path: str) -> bool:
    """Checkpoint-writer hook: corrupt the freshly committed file —
    the resume must refuse it loudly.  Returns True when corruption was
    injected."""
    if fault_active("corrupt_checkpoint") is None:
        return False
    _overwrite_mid_file(path)
    _note("corrupt_checkpoint", path=path)
    return True


def maybe_oom_dispatch(where: str) -> None:
    """Serve dispatch hook (serving/engine.py _dispatch_rows): one fake
    RESOURCE_EXHAUSTED at the next dispatch.  Self-consuming — a real OOM kills one dispatch;
    the interesting behavior is the post-mortem, not a crash loop."""
    if fault_active("oom_dispatch") is not None:
        _consume("oom_dispatch")
        _note("oom_dispatch", where=where)
        raise InjectedResourceExhausted(
            f"RESOURCE_EXHAUSTED: injected out-of-memory at {where} "
            "dispatch (allocator reported no free device memory)")


def maybe_corrupt_model(path: str) -> bool:
    """serving/hotswap.py hook, fired BEFORE sidecar verification:
    corrupt the hot-swap candidate model file so the checksum check is
    what refuses it (the lab analog of a truncated/partial model write
    reaching a serving replica).  Returns True when injected."""
    if fault_active("corrupt_model") is None or not os.path.exists(path):
        return False
    _overwrite_mid_file(path)
    _note("corrupt_model", path=path)
    return True


def poison_grads(grad, hess, iteration: int):
    """models/gbdt.py hook: at boosting iteration J, the first entry of
    every class's gradient row becomes NaN and of its hessian row +inf,
    so both operands are exercised (the JAX package's
    ``poison_grads``).  Fires once; returns poisoned copies of the
    ``[K, n]`` tensors."""
    p = fault_active("nan_grads")
    if p is None or iteration != int(p or 0):
        return grad, hess
    _consume("nan_grads")
    _note("nan_grads", iteration=iteration)
    grad, hess = grad.clone(), hess.clone()
    grad[..., 0] = float("nan")
    hess[..., 0] = float("inf")
    return grad, hess
