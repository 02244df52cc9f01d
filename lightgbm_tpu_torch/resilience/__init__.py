"""Fault tolerance: checkpoints and resume, retry, fault injection, the
non-finite guards and crash-safe writes.

Copies of the JAX package's stdlib-only modules:

* :mod:`~lightgbm_tpu_torch.resilience.atomic` — crash-safe artifact
  writes (tmp file + fsync + rename, optional sha256 sidecar); the
  hot-swap verifies a model file's sidecar before adopting it.
* :mod:`~lightgbm_tpu_torch.resilience.faults` — deterministic fault
  injection (``LGBM_TPU_FAULT``) in the training loop (``kill_after_tree``,
  ``hang_after_tree``), the checkpoint writer, the guarded collective,
  the atomic write, the hot-swap, the serve dispatch and the training
  gradients (``nan_grads``).
* :mod:`~lightgbm_tpu_torch.resilience.retry` — bounded retry of
  transient failures, deadlines, the backoff schedule the fleet's
  supervisor restarts with, the recovery ladder.

And the PyTorch ports:

* :mod:`~lightgbm_tpu_torch.resilience.checkpoint` — training
  checkpoints in the JAX package's format; kill at iteration k and
  resume gives the uninterrupted run's model file bitwise
  (``snapshot_freq``, ``snapshot_dir``, ``resume``; exit 75 on a stop
  signal).
* :mod:`~lightgbm_tpu_torch.resilience.guards` — the non-finite guards
  of ``nonfinite_policy`` (raise, skip_tree, clip).

The gang supervisor (``resilience/gang.py``, ``task=train_fleet``) is
ROADMAP A8 step 3.
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
convention, which a training run exits with after its stop-signal
checkpoint (cli.py) and a serving process on SIGTERM after its drain
(serving/server.py ``serve_from_config``).  Distinct from 0 (done) and 1
(error)."""

from .checkpoint import (  # noqa: E402,F401
    CheckpointError,
    CheckpointManager,
    TrainingPreempted,
)
from .retry import (  # noqa: E402,F401
    RecoveryEscalation,
    RecoveryExhausted,
    backoff_delay,
    retry_transient,
)
