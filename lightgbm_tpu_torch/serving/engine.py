"""Persistent on-device ensemble behind padded-shape bucketing.

Counterpart of the JAX package's ``serving/engine.py`` on the card.
Online traffic arrives as a stream of small, arbitrarily sized batches;
:class:`ServingEngine` serves them with these contracts:

* **Packed residency** — the model's ``PackedTrees`` (one flat node
  table, ``models/tree.py``) are built once per model on the engine's
  device (:class:`PackedModel`); a request dispatches against them with
  no host->device model traffic.
* **Padded-shape bucketing** — requests are zero-padded up to a fixed
  set of power-of-two row buckets and the pad rows are sliced off the
  result.  Kernel P1 (``ops/predict.py``) walks each row on its own, so
  a row's output does not depend on the padding (pinned by
  tests/test_torch_serving.py).
* **Pre-warmed buckets** — :meth:`ServingEngine.prewarm` runs one
  dispatch per bucket at startup (and per hot-swap candidate, off the
  serving path).  The port's steady state has two parts in place of the
  JAX engine's recompile-free contract and input donation (both XLA's):
  after prewarm no kernel is built (``ops/_build.BUILDS``), and on the
  card ``torch.cuda.memory_reserved()`` does not grow: every dispatch
  allocates its padded input and output through the caching allocator,
  which hands the same blocks back, and no per-bucket buffer is kept
  that two threads could share.
* **Output transform parity** — the engine applies the SAME host-side
  f64 sigmoid/softmax as ``GBDT.predict`` (``transform_scores``) to the
  same f32 sums (one chunk of iterations: at serving's batch sizes
  ``GBDT._iter_chunk`` covers the whole model), so a served response is
  bitwise what ``Booster.predict`` gives for the same rows.

The engine runs on CUDA unless it is given ``device="cpu"``, where P1's
plain version serves.
"""

from __future__ import annotations

import hashlib
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..analysis import lockcheck
from ..backend import resolve_device
from ..log import Log
from ..models.gbdt import raw_score_output, transform_scores
from ..models.tree import PackedTrees, pack_trees
from ..obs import flightrec, telemetry
from ..obs import memory as obs_memory
from ..ops import _build
from ..ops.predict import ensemble_sum
from ..resilience import faults

DEFAULT_MAX_BATCH_ROWS = 1024
DEFAULT_MIN_BUCKET = 8


def power_of_two_buckets(max_rows: int,
                         min_bucket: int = DEFAULT_MIN_BUCKET) -> List[int]:
    """The default bucket ladder: powers of two from ``min_bucket`` up
    to (and including) the smallest power covering ``max_rows``."""
    if max_rows < 1:
        raise ValueError(f"max_rows must be >= 1, got {max_rows}")
    buckets = []
    b = max(1, int(min_bucket))
    while b < max_rows:
        buckets.append(b)
        b *= 2
    buckets.append(b)
    return buckets


class PackedModel:
    """One model's device-resident serving tensors plus its identity.

    ``model_id`` is the sha256 content digest of the model artifact —
    for file-loaded models this is the SAME digest the ``.sha256``
    sidecar carries (hotswap.py verifies it), so a response's
    ``model_id`` is end-to-end checkable provenance.
    """

    __slots__ = ("model_id", "source", "packed", "num_trees", "num_class",
                 "num_features", "sigmoid", "objective", "warmed_buckets")

    def __init__(self, model_id: str, source: str, packed: PackedTrees,
                 num_features: int, sigmoid: float, objective: str) -> None:
        self.model_id = model_id
        self.source = source
        self.packed = packed
        self.num_trees = packed.num_trees
        self.num_class = packed.num_class
        self.num_features = num_features
        self.sigmoid = sigmoid
        self.objective = objective
        self.warmed_buckets: set = set()

    @property
    def device(self) -> torch.device:
        return self.packed.leaf_value.device

    @classmethod
    def from_gbdt(cls, gbdt, source: str = "<memory>",
                  model_id: Optional[str] = None,
                  device=None) -> "PackedModel":
        """Pack a GBDT's full ensemble on ``device`` (the GBDT's own by
        default; its cached pack when that is where it lives)."""
        n_trees = len(gbdt.models)
        if n_trees == 0:
            raise ValueError("cannot serve a model with zero trees")
        if gbdt.max_feature_idx < 0:
            raise ValueError("model carries no feature count "
                             "(max_feature_idx < 0)")
        if model_id is None:
            model_id = hashlib.sha256(
                gbdt.save_model_to_string(-1).encode()).hexdigest()
        dev = gbdt.device if device is None else resolve_device(device)
        packed = (gbdt._packed() if dev == gbdt.device
                  else pack_trees(gbdt.models, gbdt.num_class, dev))
        num_features = gbdt.max_feature_idx + 1
        if packed.num_features > num_features:
            raise ValueError(f"the model splits on column "
                             f"{packed.num_features - 1} but declares "
                             f"{num_features} features")
        return cls(model_id=model_id, source=source, packed=packed,
                   num_features=num_features, sigmoid=float(gbdt.sigmoid),
                   objective=gbdt.objective_name())

    def transform(self, raw: np.ndarray) -> np.ndarray:
        """The offline predictor's output transform, bit-for-bit
        (models/gbdt.py transform_scores): [K, n] f64 raw -> final."""
        return transform_scores(raw, self.num_class, self.sigmoid,
                                self.objective)

    def describe(self) -> dict:
        return {
            "model_id": self.model_id,
            "source": self.source,
            "num_trees": self.num_trees,
            "num_class": self.num_class,
            "num_features": self.num_features,
            "objective": self.objective,
            "device": str(self.device),
        }


class ServingEngine:
    """A resident packed ensemble behind shape-bucketed dispatch.

    ``model`` may be a :class:`PackedModel`, a ``GBDT``, a
    ``basic.Booster``, or a model-file path (routed through
    hotswap.load_packed_model, which checksum-verifies a sidecar when
    present).  ``device`` is where the model is packed and served: CUDA
    unless ``"cpu"`` (a :class:`PackedModel` serves where it was
    packed).  The engine pre-warms every bucket at construction unless
    ``warm=False``.

    Thread safety: :meth:`predict_with_meta` reads ``self._active``
    exactly once, so a whole request is served by ONE model even while
    :meth:`swap` flips the active ensemble concurrently — the hot-swap
    atomicity contract.
    """

    def __init__(self, model, buckets: Optional[Sequence[int]] = None,
                 max_batch_rows: int = DEFAULT_MAX_BATCH_ROWS,
                 warm: bool = True,
                 require_checksum: bool = True, device=None) -> None:
        pm = self._coerce_model(model, require_checksum, device)
        if buckets is None:
            buckets = power_of_two_buckets(max_batch_rows)
        buckets = sorted({int(b) for b in buckets})
        if not buckets or buckets[0] < 1:
            raise ValueError(f"invalid bucket set {buckets!r}")
        self.buckets: Tuple[int, ...] = tuple(buckets)
        self.max_batch_rows = self.buckets[-1]
        self._swap_lock = lockcheck.make_lock("engine.swap")
        self._active = pm
        # monotonic adoption timestamp: healthz reports its age so a
        # load balancer can tell "just flipped" from "steady" (set at
        # construction too — engine start IS the first adoption)
        self._swap_monotonic = time.perf_counter()
        # census owner tag: resolves the ACTIVE model's device tensors
        # at census time, so after a hot-swap the census attributes the
        # new model's buffers and shows the old model's freed (weakref
        # registry — never extends any buffer's lifetime)
        obs_memory.register_owner(
            "serving", self, lambda e: e._active.packed.tensors())
        if warm:
            self.prewarm()

    @staticmethod
    def _coerce_model(model, require_checksum: bool, device) -> PackedModel:
        if isinstance(model, PackedModel):
            return model
        dev = resolve_device(device)
        if isinstance(model, str):
            from .hotswap import load_packed_model

            return load_packed_model(model,
                                     require_checksum=require_checksum,
                                     device=dev)
        if hasattr(model, "_gbdt"):  # basic.Booster
            return PackedModel.from_gbdt(model._gbdt, device=dev)
        if hasattr(model, "models"):  # GBDT
            return PackedModel.from_gbdt(model, device=dev)
        raise TypeError(
            f"cannot build a ServingEngine from {type(model).__name__}; "
            "pass a model file path, PackedModel, GBDT, or Booster")

    # ------------------------------------------------------------ shape
    @property
    def active(self) -> PackedModel:
        return self._active

    @property
    def model_id(self) -> str:
        return self._active.model_id

    @property
    def num_features(self) -> int:
        return self._active.num_features

    @property
    def num_class(self) -> int:
        return self._active.num_class

    @property
    def last_swap_age_s(self) -> float:
        """Seconds since the active model was last (s)wapped in — the
        healthz readiness field (a freshly-flipped replica may still be
        filling caches; a balancer can ease it back in)."""
        return time.perf_counter() - self._swap_monotonic

    def bucket_for(self, n: int) -> int:
        """Smallest bucket covering ``n`` rows (callers chunk anything
        above the largest bucket)."""
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    @property
    def device(self) -> torch.device:
        return self._active.device

    # ---------------------------------------------------------- dispatch
    def _run(self, pm: PackedModel, Xp: np.ndarray) -> np.ndarray:
        """One P1 launch over the padded bucket ``Xp`` and the copy back:
        [K, bucket] f32 raw scores, one chunk of iterations (the whole
        model, as ``GBDT._iter_chunk`` gives at these row counts).  The
        input and output come from the caching allocator on every call;
        the stream is the calling thread's."""
        X = torch.from_numpy(Xp).to(pm.device)
        out = ensemble_sum(pm.packed, X, pm.num_trees,
                           max(pm.num_trees // pm.num_class, 1))
        lockcheck.note_host_sync("engine.dispatch_rows")
        return out.cpu().numpy()

    def _dispatch_rows(self, pm: PackedModel, Xc: np.ndarray,
                       clock=None) -> np.ndarray:
        """One bucketed device dispatch: pad -> run -> slice.  Returns
        [K, n] float64 raw scores (the same f32->f64 materialization
        point as GBDT._raw_scores, for bitwise transform parity).

        ``clock`` (an ``obs.tracing.StageClock``) accumulates the two
        engine-owned trace stages: ``pad_s`` (host pad/copy) and
        ``device_s`` (host->device copy, the launch and the copy back,
        which waits for the kernel)."""
        n = Xc.shape[0]
        b = self.bucket_for(n)
        t0 = time.perf_counter() if clock is not None else 0.0
        Xp = np.zeros((b, pm.num_features), np.float32)
        Xp[:n] = Xc
        if clock is not None:
            t1 = time.perf_counter()
            clock.add("pad_s", t1 - t0)
        try:
            # chaos hook (oom_dispatch) + OOM post-mortem: same
            # classifier path a real out-of-memory error takes
            faults.maybe_oom_dispatch("serve")
            res = self._run(pm, Xp).astype(np.float64)[:, :n]
        except Exception as e:
            obs_memory.classify_dispatch_error(
                e, "serve.dispatch",
                shape={"rows": int(n), "bucket": int(b),
                       "features": int(pm.num_features),
                       "num_class": int(pm.num_class),
                       "model_id": pm.model_id[:16]})
            raise
        if clock is not None:
            clock.add("device_s", time.perf_counter() - t1)
        telemetry.count("serving.dispatches")
        telemetry.record_value("serving.batch_occupancy", n / b)
        obs_memory.phase_boundary("serve")
        return res

    def predict_with_meta(self, X, raw_score: bool = False,
                          clock=None) -> Tuple[np.ndarray, str]:
        """Serve one (possibly coalesced) batch; returns
        ``(values, model_id)``.  ``values`` is [n] for single-output
        models, [n, K] for multiclass — row-sliceable either way, which
        is what the micro-batch queue's scatter relies on.  ``clock``
        is threaded into every chunk dispatch (tracing stages)."""
        pm = self._active  # ONE read: the whole request serves one model
        X = np.ascontiguousarray(np.asarray(X, dtype=np.float32))
        if X.ndim == 1:
            X = X[None, :]
        if X.ndim != 2 or X.shape[0] == 0:
            raise ValueError(f"expected [n, F] request rows, got shape "
                             f"{X.shape}")
        if X.shape[1] != pm.num_features:
            raise ValueError(
                f"request has {X.shape[1]} features, model "
                f"{pm.model_id[:12]} expects {pm.num_features}")
        parts = [self._dispatch_rows(pm, X[lo:lo + self.max_batch_rows], clock)
                 for lo in range(0, X.shape[0], self.max_batch_rows)]
        raw = parts[0] if len(parts) == 1 else np.concatenate(parts, axis=1)
        if raw_score:
            return raw_score_output(raw, pm.num_class), pm.model_id
        return pm.transform(raw), pm.model_id

    def predict(self, X, raw_score: bool = False) -> np.ndarray:
        vals, _ = self.predict_with_meta(X, raw_score=raw_score)
        return vals

    # ------------------------------------------------------------ warmup
    def prewarm(self, pm: Optional[PackedModel] = None) -> dict:
        """Dispatch one zero batch per bucket against ``pm`` (default:
        the active model), off the request path: P1's library is built
        and loaded here if it was not, and the caching allocator holds
        every bucket's blocks before the first request.  Returns
        ``{buckets, compiles, seconds}``; ``compiles`` counts kernel
        builds (``ops/_build.BUILDS``, the JAX engine's XLA compiles),
        also in the ``serving.warm_compiles`` counter."""
        pm = self._active if pm is None else pm
        builds = _build.BUILDS
        t0 = time.perf_counter()
        for b in self.buckets:
            self._run(pm, np.zeros((b, pm.num_features), np.float32))
            pm.warmed_buckets.add(b)
        compiles = _build.BUILDS - builds
        seconds = time.perf_counter() - t0
        telemetry.count("serving.warm_compiles", compiles)
        Log.info(
            f"serving: warmed {len(self.buckets)} bucket(s) "
            f"{list(self.buckets)} for model {pm.model_id[:12]} in "
            f"{seconds:.3f}s ({compiles} kernel builds)")
        return {"buckets": list(self.buckets), "compiles": compiles,
                "seconds": round(seconds, 3)}

    # -------------------------------------------------------------- swap
    def swap(self, new_pm: PackedModel) -> str:
        """Atomically flip the active ensemble; returns the OLD
        model_id.  Requests that already read ``self._active`` finish
        on the old model; every later request serves the new one.
        Callers wanting the full verified hot-swap contract (checksum,
        off-path prewarm, loud refusal) use hotswap.adopt_model."""
        if not isinstance(new_pm, PackedModel):
            raise TypeError("swap() takes a PackedModel; use "
                            "hotswap.adopt_model for a model file")
        old = self._active
        if new_pm.num_features != old.num_features:
            raise ValueError(
                f"refusing swap: candidate expects {new_pm.num_features} "
                f"features, serving model expects {old.num_features} — "
                "clients would crash mid-flight")
        if new_pm.num_class != old.num_class:
            raise ValueError(
                f"refusing swap: candidate has num_class="
                f"{new_pm.num_class}, serving model has "
                f"{old.num_class} — response shape would change")
        if new_pm.device != old.device:
            raise ValueError(
                f"refusing swap: candidate is packed on {new_pm.device}, "
                f"the engine serves on {old.device}")
        with self._swap_lock:
            self._active = new_pm
            self._swap_monotonic = time.perf_counter()
        telemetry.count("serving.swaps")
        obs_memory.phase_boundary("swap")
        flightrec.record("swap", old_model_id=old.model_id[:16],
                         new_model_id=new_pm.model_id[:16],
                         num_trees=new_pm.num_trees)
        Log.info(
            f"serving: hot-swapped {old.model_id[:12]} "
            f"({old.num_trees} trees) -> {new_pm.model_id[:12]} "
            f"({new_pm.num_trees} trees)")
        return old.model_id

    def describe(self) -> dict:
        pm = self._active
        return {
            **pm.describe(),
            "buckets": list(self.buckets),
            "max_batch_rows": self.max_batch_rows,
            "warmed_buckets": sorted(pm.warmed_buckets),
        }
