"""Self-describing run manifests.

A copy of the JAX package's ``obs/manifest.py`` with the runtime facts
taken from PyTorch and ``nvidia-smi``: a ``RunManifest`` records *what
ran* (git sha, dirty flag, torch / CUDA / card, config fingerprint, env
knobs), *what it counted* (the telemetry snapshot) and *where the time
went* (host-wall spans, phases, per-tree p50/p99).  The serving tier
writes one beside the served model (``write_serving_manifest``).

Schema versioned as ``lightgbm-tpu/run-manifest/v1`` (the JAX
package's); `validate` pins the required keys.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import platform as _platform
import subprocess
import sys
import time
from typing import Any, Dict, Optional

from .telemetry import get_telemetry

SCHEMA = "lightgbm-tpu/run-manifest/v1"

# env knobs worth recording: anything that changes what runs or is
# measured
_KNOB_PREFIXES = ("LGBM_TPU_", "CUDA_VISIBLE_DEVICES")

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

REQUIRED_KEYS = ("schema", "entry", "created_unix", "git", "runtime",
                 "config_fingerprint", "knobs", "warmup", "telemetry",
                 "phases", "per_tree", "result")


def _git_info() -> dict:
    """Best-effort git sha + dirty flag (a manifest from an exported
    tarball still validates — sha is then null)."""
    out = {"sha": None, "dirty": None}
    try:
        sha = subprocess.run(
            ["git", "rev-parse", "HEAD"], cwd=_REPO_ROOT, timeout=10,
            capture_output=True, text=True)
        if sha.returncode == 0:
            out["sha"] = sha.stdout.strip()
        st = subprocess.run(
            ["git", "status", "--porcelain"], cwd=_REPO_ROOT, timeout=10,
            capture_output=True, text=True)
        if st.returncode == 0:
            out["dirty"] = bool(st.stdout.strip())
    except Exception:
        pass
    return out


def _runtime_info() -> dict:
    """torch / CUDA / card identity.  The card is read only when the
    process already initialized CUDA: collecting a manifest never
    starts a CUDA context the run did not use (a CPU run records
    none)."""
    import torch

    info: Dict[str, Any] = {
        "python": sys.version.split()[0],
        "platform": _platform.platform(),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
    }
    if not torch.cuda.is_initialized():
        info["backend"] = "cpu"
        return info
    try:
        info["backend"] = "cuda"
        info["device_kind"] = torch.cuda.get_device_name(0)
        info["device_count"] = torch.cuda.device_count()
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=10)
        if smi.returncode == 0:
            info["nvidia_smi"] = smi.stdout.strip().splitlines()
    except Exception as e:  # noqa: BLE001 — a manifest never fails a run
        info["device_error"] = f"{type(e).__name__}: {str(e)[:120]}"
    return info


def _knobs() -> dict:
    return {k: v for k, v in sorted(os.environ.items())
            if k.startswith(_KNOB_PREFIXES)}


def config_fingerprint(config: Any) -> Optional[str]:
    """Stable sha256 over the run configuration (a Config object, a
    dict, or anything with ``__dict__``).  Two runs with the same
    fingerprint ran the same configuration."""
    if config is None:
        return None
    if dataclasses.is_dataclass(config) and not isinstance(config, type):
        d = dataclasses.asdict(config)
    elif isinstance(config, dict):
        d = config
    elif hasattr(config, "__dict__"):
        d = vars(config)
    else:
        d = {"repr": repr(config)}
    blob = json.dumps(
        {str(k): repr(v) for k, v in sorted(d.items(), key=lambda kv: str(kv[0]))},
        sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


@dataclasses.dataclass
class RunManifest:
    """One run's self-description; see module docstring for the fields'
    purpose.  ``telemetry`` is a full snapshot (counters/spans/
    reservoirs); ``phases`` is phase -> seconds; ``per_tree`` is the
    p50/p99 reservoir summary of the timed trees."""

    entry: str
    created_unix: float
    git: dict
    runtime: dict
    config_fingerprint: Optional[str]
    knobs: dict
    warmup: dict
    telemetry: dict
    phases: dict
    per_tree: dict
    result: dict
    extra: dict = dataclasses.field(default_factory=dict)
    # multi-rank runs (obs/dist.py ranks_section): one entry per rank.
    # Empty on single-process runs; optional in v1.
    ranks: list = dataclasses.field(default_factory=list)
    # device-memory section beside phases{}: allocator gauges, boundary
    # watermarks, owner-tagged census summary.  Optional in v1.
    memory: dict = dataclasses.field(default_factory=dict)
    schema: str = SCHEMA

    @classmethod
    def collect(cls, entry: str, config: Any = None,
                result: Optional[dict] = None,
                phases: Optional[dict] = None,
                warmup: Optional[dict] = None,
                per_tree_reservoir: str = "tree_s",
                extra: Optional[dict] = None,
                ranks: Optional[list] = None,
                memory: Optional[dict] = None) -> "RunManifest":
        """Gather everything the process knows right now.  ``entry`` is
        the entry point name (``"serve"`` for the serving tier)."""
        tel = get_telemetry()
        snap = tel.snapshot()
        res = tel.reservoir(per_tree_reservoir)
        return cls(
            entry=entry,
            created_unix=round(time.time(), 3),
            git=_git_info(),
            runtime=_runtime_info(),
            config_fingerprint=config_fingerprint(config),
            knobs=_knobs(),
            warmup=dict(warmup or {}),
            telemetry=snap,
            phases=dict(phases or {}),
            per_tree=res.as_dict() if res is not None else {},
            result=dict(result or {}),
            extra=dict(extra or {}),
            ranks=list(ranks or []),
            memory=dict(memory or {}),
        )

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "RunManifest":
        validate(d)
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    def write(self, path: str) -> str:
        # shared crash-safe writer (resilience/atomic.py): tmp + fsync +
        # rename — a crash mid-write must not leave a half manifest
        # shadowing a real result artifact
        from ..resilience.atomic import atomic_write_json

        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        return atomic_write_json(path, self.to_dict())

    @classmethod
    def load(cls, path: str) -> "RunManifest":
        with open(path) as fh:
            return cls.from_dict(json.load(fh))


def validate(d: dict) -> None:
    """Raise ValueError when a manifest dict is not v1-shaped."""
    missing = [k for k in REQUIRED_KEYS if k not in d]
    if missing:
        raise ValueError(f"manifest missing keys: {missing}")
    if d["schema"] != SCHEMA:
        raise ValueError(f"unknown manifest schema {d['schema']!r}")


def manifest_path(artifact_path: str) -> str:
    """Canonical manifest location for a result artifact:
    ``foo.json`` -> ``foo.manifest.json`` (sibling, self-pairing)."""
    base, ext = os.path.splitext(artifact_path)
    if ext == ".json":
        return base + ".manifest.json"
    return artifact_path + ".manifest.json"
