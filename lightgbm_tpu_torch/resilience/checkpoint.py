"""Training checkpoints + resume with a BITWISE-identity contract.

The port of the JAX package's ``resilience/checkpoint.py``, in its file
format.  A checkpoint captures every per-iteration mutable of a training
run — the grown trees (exact tensors, not the text round trip), the
float32 score buffers byte for byte, the bagging / feature / drop RNG
states, the bagging mask, the early-stopping bests and the non-finite
guard's state — so that ``kill at iteration k; resume`` produces a final
model file bitwise identical to the uninterrupted run's, on every
training route (the port's training is deterministic run to run: fixed-
order sums, no float atomics).

Why exact tensors and not the model string: ``threshold_real`` is the
float32 rounding of a float64 bin bound, and a tree read back from text
is rebound to bins (models/gbdt.py ``_rebind_tree``); the tensors carry
the bins the run grew.  The model string still rides along
(``model_str``) as human-readable lineage.

Format (the JAX package's schema ``lightgbm-tpu/checkpoint/v1``): one
JSON file per checkpoint (``ckpt_00000010.json`` in
``<output_model>.ckpt/`` by default, or ``snapshot_dir``), arrays as
zlib+base64 blobs, a ``sha256`` header over the canonical payload
serialization, and a lineage block (git sha, config fingerprint, the
previous checkpoint's digest).  Trees are written as the JAX package
writes its ``Tree`` NamedTuple: ``num_leaves`` stacked as int32, then
the 14 tensors, one group per run of trees of one padded width.  The
port keeps no lagged stop (its stop check is eager) and no bag count:
``pending_stop`` is ``[]`` and ``cnt`` the count the mask holds.
Writes go through :func:`~.atomic.atomic_write` — a preemption mid-
checkpoint leaves the previous checkpoint intact.  Resume validates the
checksum and the config fingerprint and refuses LOUDLY on a mismatch.

Reading the device buffers is one counted host sync
(``telemetry.host_sync``) a checkpoint, at the snapshot's cadence; with
``snapshot_freq=0`` and no signal, :class:`CheckpointManager` does no
device work.
"""

from __future__ import annotations

import base64
import dataclasses
import glob
import hashlib
import json
import os
import signal
import time
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..log import Log
from ..obs import flightrec, telemetry
from ..obs.manifest import _git_info, config_fingerprint
from . import EXIT_PREEMPTED
from . import faults
from .atomic import atomic_write

SCHEMA = "lightgbm-tpu/checkpoint/v1"
_KEEP = 2  # checkpoints retained per run (newest + one fallback)


class CheckpointError(Exception):
    """A checkpoint could not be used.  Messages are actionable — they
    name the file, the mismatch, and the operator's options."""


class TrainingPreempted(Exception):
    """Raised out of the train loop after a SIGTERM/SIGINT-triggered
    checkpoint; cli.main converts it to :data:`EXIT_PREEMPTED`."""

    exit_code = EXIT_PREEMPTED

    def __init__(self, path: str, iteration: int) -> None:
        super().__init__(
            f"training preempted at iteration {iteration}; checkpoint "
            f"saved to {path} — re-run with resume=true to continue")
        self.path = path
        self.iteration = iteration


# ------------------------------------------------------------- array codec
def _enc(arr) -> dict:
    a = np.ascontiguousarray(np.asarray(arr))
    return {
        "dtype": a.dtype.str,
        "shape": list(a.shape),
        "z64": base64.b64encode(zlib.compress(a.tobytes(), 1)).decode(),
    }


def _dec(d: dict) -> np.ndarray:
    raw = zlib.decompress(base64.b64decode(d["z64"]))
    return np.frombuffer(raw, dtype=np.dtype(d["dtype"])).reshape(d["shape"])


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _device(arr: np.ndarray, device) -> torch.Tensor:
    # a writable copy: the decoded buffer is read-only
    return torch.from_numpy(np.array(arr)).to(device)


def _enc_rng(rng: np.random.RandomState) -> dict:
    alg, keys, pos, has_gauss, cached = rng.get_state()
    return {"alg": alg, "keys": _enc(keys), "pos": int(pos),
            "has_gauss": int(has_gauss), "cached_gaussian": float(cached)}


def _dec_rng(d: dict) -> tuple:
    return (d["alg"], _dec(d["keys"]), d["pos"], d["has_gauss"],
            d["cached_gaussian"])


# ---------------------------------------------------------- fingerprinting
def training_fingerprint(cfg) -> Optional[str]:
    """Config fingerprint for checkpoint compatibility: the full config
    minus the resume switch itself (a resumed run flips ``resume`` and
    nothing else; everything else — data, trees, seeds, snapshot cadence
    — must match for the bitwise contract to hold)."""
    if cfg is None:
        return None
    d = dataclasses.asdict(cfg) if dataclasses.is_dataclass(cfg) else dict(vars(cfg))
    d.pop("resume", None)
    return config_fingerprint(d)


# ------------------------------------------------------------ state capture
def _host_models(models) -> List[Tuple[int, Dict[str, np.ndarray]]]:
    """The trees as host arrays, grouped by padded width (one group per
    run of consecutive same-width trees; more than one when an
    ``input_model`` with another ``num_leaves`` was merged), in the JAX
    package's field names, dtypes and shapes: ``num_leaves`` int32
    ``[count]``, each tensor ``[count, width]``.  Exact: no re-binning,
    no text round trip; one device-to-host copy a field a group."""
    from ..models.tree import TREE_FIELDS

    runs: List[list] = []
    for t in models:
        if runs and runs[-1][0].leaf_value.shape == t.leaf_value.shape:
            runs[-1].append(t)
        else:
            runs.append([t])
    groups = []
    for run in runs:
        fields = {"num_leaves": np.asarray([t.num_leaves for t in run],
                                           np.int32)}
        for name in TREE_FIELDS:
            fields[name] = _host(torch.stack([getattr(t, name)
                                              for t in run]))
        groups.append((len(run), fields))
    return groups


def _restore_models(groups: List[dict], device) -> List:
    """The trees of a checkpoint's groups (``_host_models``) on
    ``device``: each field uploaded once a group, tree i a row of it."""
    from ..models.tree import TREE_FIELDS, Tree

    models: List = []
    for g in groups:
        missing = {"num_leaves", *TREE_FIELDS} - set(g["fields"])
        if missing:
            raise CheckpointError(
                f"checkpoint tree group lacks the fields {sorted(missing)}")
        nl = _dec(g["fields"]["num_leaves"])
        fields = {name: _device(_dec(d), device)
                  for name, d in g["fields"].items() if name != "num_leaves"}
        for i in range(g["count"]):
            models.append(Tree(num_leaves=int(nl[i]), **{
                name: arr[i] for name, arr in fields.items()}))
    return models


def save_checkpoint(path: str, booster, cfg, *, iteration: int,
                    best_score: Optional[Dict[tuple, float]] = None,
                    best_iter: Optional[Dict[tuple, int]] = None,
                    prev_sha: Optional[str] = None) -> str:
    """Serialize the full training state of ``booster`` (a GBDT / DART)
    after ``iteration`` completed boosting iterations.  Reading the
    device buffers is a deliberate host sync (counted; its seconds are
    the span ``checkpoint.device_read``); the checkpoint cadence, not
    the tree loop, pays it."""
    telemetry.host_sync()
    with telemetry.span("checkpoint.device_read"):
        groups = _host_models(booster.models)
        scores = _host(booster._scores)
        valid = [_host(v) for v in booster._valid_scores]
        mask = _host(booster._bag_mask) != 0
    payload: Dict = {
        "schema": SCHEMA,
        "created_unix": round(time.time(), 3),
        "iteration": int(iteration),
        "config_fingerprint": training_fingerprint(cfg),
        "lineage": {
            "git": _git_info(),
            "entry": "cli.train",
            "data": getattr(cfg, "data", None),
            "output_model": getattr(cfg, "output_model", None),
            "prev_checkpoint_sha256": prev_sha,
        },
        "booster": {
            "name": booster.name,
            "iter_": int(booster.iter_),
            "num_init_iteration": int(booster.num_init_iteration),
            "num_class": int(booster.num_class),
            "objective": booster.objective_name(),
            # the port's stop check is eager: nothing is parked
            "pending_stop": [],
        },
        "models": [{"count": count,
                    "fields": {k: _enc(v) for k, v in fields.items()}}
                   for count, fields in groups],
        "model_str": base64.b64encode(zlib.compress(
            booster.save_model_to_string(-1).encode(), 1)).decode(),
        "scores": _enc(scores),
        "valid_scores": [_enc(v) for v in valid],
        "bagging": {
            "mask_bits": _enc(np.packbits(mask)),
            "n": int(mask.shape[0]),
            "cnt": int(mask.sum()),
        },
        "rng": {
            "bag": _enc_rng(booster._bag_rng),
            "feat": _enc_rng(booster._feat_rng),
        },
        "early_stop": {
            "best": [
                [int(di), str(name), float((best_score or {})[(di, name)]),
                 int((best_iter or {})[(di, name)])]
                for (di, name) in (best_score or {})
            ],
        },
        "telemetry": telemetry.get_telemetry().snapshot(),
    }
    if hasattr(booster, "_drop_rng"):  # DART extras
        payload["dart"] = {
            "drop_rng": _enc_rng(booster._drop_rng),
            "tree_weight": [float(w) for w in booster.tree_weight],
            "sum_weight": float(booster.sum_weight),
        }
    if booster._nf_guard is not None:
        payload["nonfinite"] = booster._nf_guard.state_dict()

    blob = json.dumps(payload, sort_keys=True, separators=(",", ":"))
    doc = {"schema": SCHEMA,
           "sha256": hashlib.sha256(blob.encode()).hexdigest(),
           "payload": payload}
    atomic_write(path, json.dumps(doc, sort_keys=True,
                                  separators=(",", ":")) + "\n")
    telemetry.count("checkpoints_written")
    return path


def load_checkpoint(path: str) -> dict:
    """Parse + validate one checkpoint file.  Raises
    :class:`CheckpointError` (loud, actionable) on any corruption."""
    try:
        with open(path) as fh:
            doc = json.load(fh)
    except (OSError, ValueError) as e:
        raise CheckpointError(
            f"checkpoint {path} is unreadable ({type(e).__name__}: "
            f"{str(e)[:120]}) — it was truncated or corrupted. Delete it "
            "to resume from the previous checkpoint, or restart without "
            "resume=true to train from scratch.") from e
    payload = doc.get("payload")
    if doc.get("schema") != SCHEMA or not isinstance(payload, dict):
        raise CheckpointError(
            f"checkpoint {path} has schema {doc.get('schema')!r}, "
            f"expected {SCHEMA!r} — it was written by an incompatible "
            "version; restart without resume=true.")
    blob = json.dumps(payload, sort_keys=True, separators=(",", ":"))
    got = hashlib.sha256(blob.encode()).hexdigest()
    if got != doc.get("sha256"):
        raise CheckpointError(
            f"checkpoint {path} FAILED its content checksum "
            f"(sha256 {got[:16]}… != recorded "
            f"{str(doc.get('sha256'))[:16]}…) — the file was corrupted "
            "after writing. Delete it to fall back to the previous "
            "checkpoint, or restart without resume=true.")
    return payload


def validate_against_config(payload: dict, cfg, path: str = "") -> None:
    want = training_fingerprint(cfg)
    have = payload.get("config_fingerprint")
    if want != have:
        raise CheckpointError(
            f"checkpoint {path or '<payload>'} was written under config "
            f"fingerprint {have}, but this run's is {want} — resuming "
            "under a different configuration would NOT reproduce the "
            "uninterrupted run. Re-run with the original parameters "
            "(only the resume flag may differ), or restart without "
            "resume=true.")


def restore_training_state(booster, payload: dict,
                           best_score: Optional[Dict] = None,
                           best_iter: Optional[Dict] = None) -> int:
    """Install a checkpoint payload into a freshly constructed booster
    (data loaded, valid sets attached, an ``input_model`` merged),
    field for field, from host bytes onto the booster's device.  Returns
    the number of completed boosting iterations."""
    b = payload["booster"]
    if b["num_class"] != booster.num_class:
        raise CheckpointError(
            f"checkpoint num_class={b['num_class']} != configured "
            f"{booster.num_class}")
    dev = booster.device
    valid = payload.get("valid_scores", [])
    if len(valid) != len(booster._valid_scores):
        raise CheckpointError(
            f"checkpoint carries {len(valid)} valid-set score buffers, "
            f"run has {len(booster._valid_scores)} — the valid_data list "
            "must match the original run's")
    booster.install_models(_restore_models(payload["models"], dev))
    booster.iter_ = int(b["iter_"])
    booster.num_init_iteration = int(b["num_init_iteration"])
    booster._scores = _device(_dec(payload["scores"]), dev)
    for i, v in enumerate(valid):
        booster._valid_scores[i] = _device(_dec(v), dev)
    bag = payload["bagging"]
    mask = np.unpackbits(_dec(bag["mask_bits"]))[: bag["n"]]
    booster._bag_mask = _device(mask.astype(np.float32), dev)
    booster._bag_rng.set_state(_dec_rng(payload["rng"]["bag"]))
    booster._feat_rng.set_state(_dec_rng(payload["rng"]["feat"]))
    if "dart" in payload and hasattr(booster, "_drop_rng"):
        booster._drop_rng.set_state(_dec_rng(payload["dart"]["drop_rng"]))
        booster.tree_weight = list(payload["dart"]["tree_weight"])
        booster.sum_weight = float(payload["dart"]["sum_weight"])
    if "nonfinite" in payload and booster._nf_guard is not None:
        booster._nf_guard.load_state_dict(payload["nonfinite"])
    if best_score is not None:
        for di, name, score, it in payload["early_stop"]["best"]:
            best_score[(int(di), name)] = float(score)
            if best_iter is not None:
                best_iter[(int(di), name)] = int(it)
    telemetry.count("checkpoints_resumed")
    return int(payload["iteration"])


# ----------------------------------------------------------- dir handling
def checkpoint_dir(cfg) -> str:
    d = getattr(cfg, "snapshot_dir", "") or ""
    return d or (getattr(cfg, "output_model", "model.txt") + ".ckpt")


def checkpoint_file(directory: str, iteration: int) -> str:
    return os.path.join(directory, f"ckpt_{iteration:08d}.json")


def list_checkpoints(directory: str) -> List[str]:
    """Checkpoint paths, oldest first (iteration-numbered names sort)."""
    return sorted(glob.glob(os.path.join(directory, "ckpt_*.json")))


def latest_checkpoint(directory: str) -> Optional[str]:
    cks = list_checkpoints(directory)
    return cks[-1] if cks else None


def load_latest_for(cfg) -> Optional[Tuple[str, dict]]:
    """Resolve + validate the newest checkpoint for this run.  Returns
    ``(path, payload)``, or None when the run has no checkpoints at all
    (a preemption before the first snapshot: resuming from scratch IS
    the lossless continuation).  Corruption or a config mismatch raises
    — never silently restarts."""
    path = latest_checkpoint(checkpoint_dir(cfg))
    if path is None:
        return None
    payload = load_checkpoint(path)
    validate_against_config(payload, cfg, path)
    return path, payload


def prune_checkpoints(directory: str, keep: int = _KEEP) -> None:
    for stale in list_checkpoints(directory)[:-keep]:
        try:
            os.remove(stale)
        except OSError:
            pass


# -------------------------------------------------------- train-loop hook
class CheckpointManager:
    """The cli train loop's preemption guard: periodic snapshots
    (``snapshot_freq``), SIGTERM/SIGINT capture that lets the in-flight
    iteration finish, and the checkpoint-then-exit handshake.

    Use as a context manager around the train loop; handlers are
    restored on exit.  ``after_iteration(it)`` is the single hook the
    loop calls: the ``kill_after_tree`` fault, a stop signal's
    checkpoint (raising :class:`TrainingPreempted`), a due snapshot,
    the heartbeat, then the ``hang_after_tree`` fault."""

    def __init__(self, cfg, booster, best_score: Dict, best_iter: Dict,
                 heartbeat=None):
        self.cfg = cfg
        self.booster = booster
        self.best_score = best_score
        self.best_iter = best_iter
        self.freq = int(getattr(cfg, "snapshot_freq", 0) or 0)
        self.dir = checkpoint_dir(cfg)
        self.enabled = self.freq > 0
        # a liveness beacon a supervisor's heartbeat deadline watches
        self.heartbeat = heartbeat
        self._stop_signum: Optional[int] = None
        self._old_handlers: Dict[int, object] = {}
        self._last_sha: Optional[str] = None

    # -- signals
    def _on_signal(self, signum, frame) -> None:
        # the handler only sets the flag; the train loop checkpoints at
        # the next iteration boundary (the in-flight tree finishes — a
        # half-grown tree is not a state anyone can resume from)
        if self._stop_signum is not None:
            # SECOND signal: the operator means it — restore the old
            # disposition and re-raise, aborting at once without a
            # checkpoint.  The flight recorder is then the only record
            # of how far the run got, so it dumps first.
            Log.warning(
                f"second {signal.Signals(signum).name}: aborting "
                "immediately (no checkpoint)")
            flightrec.record("signal",
                             signal=signal.Signals(signum).name,
                             second=True)
            flightrec.dump(reason="second_signal")
            signal.signal(signum,
                          self._old_handlers.get(signum, signal.SIG_DFL))
            os.kill(os.getpid(), signum)
            return
        # signals are delivered on the main thread between bytecodes and
        # one reference assignment is atomic: no lock (one could
        # self-deadlock the handler)
        self._stop_signum = signum
        flightrec.record("signal", signal=signal.Signals(signum).name,
                         second=False)
        Log.warning(
            f"received {signal.Signals(signum).name}; finishing the "
            "in-flight iteration, then checkpointing and exiting "
            f"(exit status {EXIT_PREEMPTED}); send again to abort "
            "immediately")

    def __enter__(self) -> "CheckpointManager":
        try:
            for sig in (signal.SIGTERM, signal.SIGINT):
                self._old_handlers[sig] = signal.signal(sig, self._on_signal)
        except ValueError:
            # not the main thread (embedded use): periodic snapshots
            # still work, signal capture does not
            self._old_handlers = {}
        return self

    def __exit__(self, *exc) -> None:
        for sig, old in self._old_handlers.items():
            signal.signal(sig, old)

    # -- the loop hook
    def after_iteration(self, it: int) -> None:
        completed = it + 1
        faults.maybe_kill(completed)  # chaos: may deliver SIGTERM here
        if self._stop_signum is not None:
            path = self.write(completed)
            raise TrainingPreempted(path or "<snapshots disabled>",
                                    completed)
        if self.enabled and completed % self.freq == 0:
            self.write(completed)
        if self.heartbeat is not None:
            # after any due checkpoint: a heartbeat at K implies K's
            # checkpoint is durable
            self.heartbeat(completed)
        # after the checkpoint commits: a wedged collective strikes
        # between checkpoints, not instead of one
        faults.maybe_hang(completed)  # chaos: may stall (no heartbeat)

    def write(self, completed: int) -> Optional[str]:
        if not self.enabled and self._stop_signum is None:
            return None
        os.makedirs(self.dir, exist_ok=True)
        path = checkpoint_file(self.dir, completed)
        read0 = _span_s("checkpoint.device_read")
        t0 = time.perf_counter()
        save_checkpoint(path, self.booster, self.cfg,
                        iteration=completed, best_score=self.best_score,
                        best_iter=self.best_iter, prev_sha=self._last_sha)
        secs = time.perf_counter() - t0
        read_s = _span_s("checkpoint.device_read") - read0
        size = os.path.getsize(path)
        if faults.maybe_corrupt_checkpoint(path):
            Log.warning(f"FAULT corrupt_checkpoint: corrupted {path}")
        self._last_sha = _file_payload_sha(path)
        prune_checkpoints(self.dir)
        flightrec.record("checkpoint", path=path, iteration=completed)
        Log.info(f"Checkpoint written: {path} (iteration {completed}, "
                 f"{size} bytes in {secs:.6f} seconds, device reads "
                 f"{read_s:.6f} seconds)")
        return path


def _span_s(name: str) -> float:
    return getattr(telemetry.get_telemetry().span_stat(name), "total_s",
                   0.0)


def _file_payload_sha(path: str) -> Optional[str]:
    try:
        with open(path) as fh:
            return json.load(fh).get("sha256")
    except Exception:  # noqa: BLE001 — lineage is best-effort
        return None
