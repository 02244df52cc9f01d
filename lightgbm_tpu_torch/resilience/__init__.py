"""Fault tolerance: the parts serving needs.

Copies of the JAX package's stdlib-only modules:

* :mod:`~lightgbm_tpu_torch.resilience.atomic` — crash-safe artifact
  writes (tmp file + fsync + rename, optional sha256 sidecar); the
  hot-swap verifies a model file's sidecar before adopting it.
* :mod:`~lightgbm_tpu_torch.resilience.faults` — deterministic fault
  injection (``LGBM_TPU_FAULT``) at the atomic write, the hot-swap and
  the serve dispatch.

Checkpoints, the non-finite guards, retry and the gang supervisor are
ROADMAP A9 and not ported yet.
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

EXIT_PREEMPTED = 75
"""Exit status for "preempted, retry": the sysexits EX_TEMPFAIL
convention, which a serving process exits with on SIGTERM after its
drain (serving/server.py ``serve_from_config``).  Distinct from 0 (done)
and 1 (error)."""
