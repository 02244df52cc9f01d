"""Fault tolerance: the parts serving and the training loop need.

Copies of the JAX package's stdlib-only modules:

* :mod:`~lightgbm_tpu_torch.resilience.atomic` — crash-safe artifact
  writes (tmp file + fsync + rename, optional sha256 sidecar); the
  hot-swap verifies a model file's sidecar before adopting it.
* :mod:`~lightgbm_tpu_torch.resilience.faults` — deterministic fault
  injection (``LGBM_TPU_FAULT``) at the atomic write, the hot-swap, the
  serve dispatch and the training gradients (``nan_grads``).
* :mod:`~lightgbm_tpu_torch.resilience.guards` — the non-finite guards
  of ``nonfinite_policy`` (raise, skip_tree, clip), in PyTorch.

Checkpoints, retry and the gang supervisor are ROADMAP A9's later steps
and not ported yet.
"""

from .atomic import (  # noqa: F401
    ArtifactCorrupt,
    atomic_write,
    atomic_write_json,
    atomic_writer,
    sidecar_path,
    verify_sidecar,
)
from .faults import (  # noqa: F401
    InjectedFault,
    clear_faults,
    fault_active,
    set_fault,
)
from .guards import NonFiniteError, NonFiniteGuard, make_guard  # noqa: F401

EXIT_PREEMPTED = 75
"""Exit status for "preempted, retry": the sysexits EX_TEMPFAIL
convention, which a serving process exits with on SIGTERM after its
drain (serving/server.py ``serve_from_config``).  Distinct from 0 (done)
and 1 (error)."""
