"""Checksum-verified model hot-swap: adopt a new boosting round under load.

Counterpart of the JAX package's ``serving/hotswap.py``: continued
training extends a model, and this module lets a serving replica ADOPT
that new round without eviction.  The contract (pinned by the tier-1
fault-injection tests):

1. **Verify before trust.**  The candidate file's ``.sha256`` sidecar
   (written by ``Booster.save_model`` via ``resilience.atomic``) is
   checked first; a truncated or corrupted candidate — which would
   otherwise silently LOAD with fewer trees — raises
   :class:`~lightgbm_tpu_torch.resilience.atomic.ArtifactCorrupt` with
   an actionable message, and the old model keeps serving.
2. **Pack off the serving path.**  The candidate is parsed, packed into
   one node table on the engine's device, and every serving bucket is
   pre-warmed against it BEFORE the flip, so adoption puts no first
   launch of a bucket into the request path.
3. **Atomic flip.**  ``engine.swap`` replaces the active ensemble in
   one reference assignment: requests already dispatched finish on the
   old model, every later request serves the new one — there is no
   moment where a response mixes models.

Fault injection: ``LGBM_TPU_FAULT=corrupt_model`` (resilience/faults.py)
corrupts the candidate mid-file before verification — the chaos path
that proves step 1 actually refuses.
"""

from __future__ import annotations

import os
import time

from ..log import Log
from ..obs import flightrec, telemetry
from ..resilience import faults
from ..resilience.atomic import (ArtifactCorrupt, file_sha256,
                                 verify_sidecar)
from .engine import PackedModel, ServingEngine


def load_packed_model(path: str, require_checksum: bool = True,
                      device=None) -> PackedModel:
    """Load + verify + pack a model file for serving on ``device``
    (CUDA unless ``"cpu"``).

    ``require_checksum=True`` (the hot-swap default) refuses a candidate
    with no ``.sha256`` sidecar; ``False`` (cold-start convenience for
    models that predate sidecars) still verifies when a sidecar exists
    — verification is only ever skipped when there is nothing to verify
    against.  Raises :class:`ArtifactCorrupt` on any integrity failure.
    """
    # LGBM_TPU_FAULT=corrupt_model: damage the candidate BEFORE the
    # verification it exists to exercise
    faults.maybe_corrupt_model(path)
    if not os.path.exists(path):
        raise ArtifactCorrupt(
            f"{path}: candidate model file does not exist")
    digest = verify_sidecar(path)  # ArtifactCorrupt on mismatch
    if digest is None:
        if require_checksum:
            raise ArtifactCorrupt(
                f"{path}: no .sha256 sidecar — refusing to adopt an "
                "unverifiable model for serving (models saved by "
                "Booster.save_model carry the sidecar; pass "
                "require_checksum=False only for trusted legacy files)")
        digest = file_sha256(path)
    try:
        from ..basic import Booster

        booster = Booster(model_file=path, device=device)
        return PackedModel.from_gbdt(booster._gbdt, source=path,
                                     model_id=digest)
    except Exception as e:
        # checksum passed but the content is not a loadable model — a
        # bad WRITER, not bad transport; still refuse loudly
        raise ArtifactCorrupt(
            f"{path}: checksum valid but the model failed to "
            f"load/pack ({type(e).__name__}: {e}) — the artifact was "
            "written malformed; regenerate it") from e


def adopt_model(engine: ServingEngine, path: str,
                require_checksum: bool = True) -> dict:
    """The full hot-swap: verify -> pack -> prewarm -> flip.

    On ANY failure the engine is untouched and keeps serving the old
    model; the refusal is counted (``serving.swap_refused``) and the
    exception propagates to the caller (an HTTP swap endpoint turns it
    into a 409).  Returns a summary dict on success."""
    t0 = time.perf_counter()
    try:
        pm = load_packed_model(path, require_checksum=require_checksum,
                               device=engine.device)
        warm = engine.prewarm(pm)  # first launches land OFF the request path
        old_id = engine.swap(pm)
    except BaseException as e:
        telemetry.count("serving.swap_refused")
        # a refused swap is a flight-recorder incident: something
        # handed this replica a bad model — record the trigger, then
        # dump so the post-mortem tail IS the refusal
        flightrec.record("swap_refused", candidate=path,
                         serving_model_id=engine.model_id[:16],
                         error=f"{type(e).__name__}: {e}")
        flightrec.dump(reason="swap_refused")
        Log.warning(
            f"serving: hot-swap of {path} refused; old model "
            f"{engine.model_id[:12]} keeps serving")
        raise
    return {
        "old_model_id": old_id,
        "new_model_id": pm.model_id,
        "num_trees": pm.num_trees,
        "warm": warm,
        "seconds": round(time.perf_counter() - t0, 3),
    }
