"""Non-finite guards: graceful degradation instead of silent garbage.

Counterpart of lightgbm_tpu/resilience/guards.py, on tensors.  A single
NaN gradient (a poisoned row, an overflowing custom objective, a bad
init score) propagates through histogram sums into every split gain and
leaf value of the tree, and float32 training neither crashes nor warns.
The guard watches the two places non-finites enter the model (gradients
and hessians before growing, leaf outputs after) under
``Config.nonfinite_policy``:

* ``off`` (default): no guard, no cost.
* ``raise``: count non-finites on the device (an elementwise pass and a
  sum an iteration, no sync), read the counts once at the iteration's
  end, and on any restore the pre-iteration snapshot and raise
  :class:`NonFiniteError`.
* ``skip_tree``: read the gradient count BEFORE growing (one host sync
  an iteration, and one a tree for its leaf check) and skip the iteration
  when poisoned; after ``MAX_CONSECUTIVE_SKIPS`` skips in a row it raises.
* ``clip``: zero non-finite gradient/hessian entries (the poisoned rows
  contribute nothing this iteration) and non-finite leaf outputs; the
  counts stay on the device and drain every 64 parked counts and at
  ``finalize``.

Everything is counted in telemetry (``nonfinite_grad_events``,
``nonfinite_values_clipped``, ``nonfinite_skipped_trees``,
``nonfinite_leaf_values``) and trips are recorded in the flight recorder.
The count and the clean-up are elementwise passes: no kernel of their
own.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from ..log import Log
from ..obs import flightrec, telemetry

POLICIES = ("off", "raise", "skip_tree", "clip")

# skip_tree escalation bound: a skip changes nothing, so a deterministic
# non-finite source would silently burn every remaining iteration; after
# this many consecutive skips the guard raises instead
MAX_CONSECUTIVE_SKIPS = 10


class NonFiniteError(RuntimeError):
    """Non-finite gradients/hessians/leaf outputs under policy=raise."""


def _bad_count(*xs: torch.Tensor) -> torch.Tensor:
    """The non-finite entries of ``xs``, an int32 count on their device."""
    return sum((~torch.isfinite(x)).sum() for x in xs).to(torch.int32)


def _zeroed(x: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isfinite(x), x, torch.zeros((), dtype=x.dtype,
                                                         device=x.device))


def _read(counts: List[torch.Tensor]) -> int:
    """The parked device counts summed and read in one host sync."""
    telemetry.host_sync()
    return int(torch.stack(counts).sum())


class NonFiniteGuard:
    """Per-booster guard state; one instance per GBDT when the policy is
    not ``off`` (models/gbdt.py constructs it)."""

    def __init__(self, policy: str) -> None:
        if policy not in POLICIES:
            raise ValueError(f"Unknown nonfinite_policy: {policy!r} "
                             f"(valid: {', '.join(POLICIES)})")
        self.policy = policy
        # parked device counts, read at a sync point of the policy's own
        self._pending: List[torch.Tensor] = []
        self._consecutive_skips = 0

    # ------------------------------------------------------------- grads
    def check_gradients(self, grad: torch.Tensor, hess: torch.Tensor):
        """Returns ``(grad, hess, skip_iteration)``."""
        n = _bad_count(grad, hess)
        if self.policy == "clip":
            self._pending.append(n)
            self._drain_clip(limit=64)
            return _zeroed(grad), _zeroed(hess), False
        if self.policy == "raise":
            self._pending.append(n)  # read by raise_if_poisoned
            return grad, hess, False
        bad = _read([n])
        if not bad:
            self._consecutive_skips = 0
            return grad, hess, False
        telemetry.count("nonfinite_grad_events")
        telemetry.count("nonfinite_skipped_trees")
        self._consecutive_skips += 1
        flightrec.record("guard_trip", policy="skip_tree", nonfinite=bad,
                         consecutive=self._consecutive_skips)
        if self._consecutive_skips >= MAX_CONSECUTIVE_SKIPS:
            raise NonFiniteError(
                f"{self._consecutive_skips} consecutive boosting iterations "
                "skipped for non-finite gradients (nonfinite_policy="
                "skip_tree): the source is persistent, not transient — "
                "skipping cannot converge. Fix the objective/data, or use "
                "nonfinite_policy=clip.")
        Log.warning(f"non-finite gradients/hessians ({bad} values); "
                    "policy=skip_tree: skipping this boosting iteration")
        return grad, hess, True

    # ------------------------------------------------------------ leaves
    def check_tree(self, tree):
        """The leaf-output guard, before the tree's score update: the tree
        to use.  It never drops a tree (the models list stays
        iteration-major), so skip_tree zeroes the poisoned leaves here."""
        n = _bad_count(tree.leaf_value)
        if self.policy == "raise":
            self._pending.append(n)
            return tree
        cleaned = tree.replace(leaf_value=_zeroed(tree.leaf_value))
        if self.policy == "clip":
            self._pending.append(n)
            return cleaned
        bad = _read([n])
        if not bad:
            return tree
        telemetry.count("nonfinite_leaf_values", bad)
        telemetry.count("nonfinite_grad_events")
        Log.warning(f"zeroed {bad} non-finite leaf outputs "
                    "(nonfinite_policy=skip_tree)")
        return cleaned

    # ----------------------------------------------------------- drains
    def raise_if_poisoned(self, booster=None, snap=None) -> None:
        """policy=raise: read the parked counts (one sync).  On any,
        restore ``booster`` to the pre-iteration ``snap``
        (``GBDT.snapshot_state``) and raise: a subtracting rollback
        cannot work, since NaN - NaN = NaN stays in the scores."""
        if self.policy != "raise" or not self._pending:
            return
        bad = _read(self._pending)
        self._pending.clear()
        if not bad:
            return
        telemetry.count("nonfinite_grad_events")
        flightrec.record("guard_trip", policy="raise", nonfinite=bad)
        if booster is not None and snap is not None:
            booster.restore_state(snap)
        raise NonFiniteError(
            f"{bad} non-finite gradient/hessian/leaf values this iteration "
            "(nonfinite_policy=raise). The booster was restored to its exact "
            "pre-iteration state. Check the input data (strict_data=true "
            "surfaces bad rows at load time) or train with "
            "nonfinite_policy=skip_tree|clip to degrade gracefully instead.")

    def _drain_clip(self, limit: int = 0) -> None:
        if self.policy != "clip" or len(self._pending) <= limit:
            return
        n = _read(self._pending)
        self._pending.clear()
        if n:
            telemetry.count("nonfinite_values_clipped", n)
            telemetry.count("nonfinite_grad_events")
            Log.warning(f"clipped {n} non-finite gradient/hessian/leaf "
                        "values (nonfinite_policy=clip)")

    def finalize(self) -> None:
        """End-of-training drain for the lazy policies; under raise a
        poisoned last iteration raises without a restore."""
        self._drain_clip()
        if self.policy == "raise" and self._pending:
            self.raise_if_poisoned(None)


def make_guard(policy: str) -> Optional[NonFiniteGuard]:
    return None if policy in (None, "", "off") else NonFiniteGuard(policy)
