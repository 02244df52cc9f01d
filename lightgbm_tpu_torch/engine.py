"""Training entry point (counterpart of lightgbm_tpu/engine.py ``train``).

The boosting loop with validation sets whose scores the booster keeps
current (``Booster.eval_valid`` reads them).  A validation set that is
the training set is not added: its name becomes the booster's
``train_data_name``, under which ``Booster.eval_train`` reports.  Early
stopping, evaluation records, callbacks, ``cv`` and ``train_many`` are
not ported yet (ROADMAP queue A2).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from .basic import Booster, Dataset
from .config import key_alias_transform


def train(params: Dict[str, Any], train_set: Dataset,
          num_boost_round: int = 100,
          valid_sets: Optional[List[Dataset]] = None,
          valid_names: Optional[List[str]] = None,
          device=None) -> Booster:
    """Train a booster on ``device`` (None -> CUDA; pass ``"cpu"`` for
    the plain PyTorch path)."""
    merged = dict(train_set.params or {})
    merged.update(key_alias_transform(dict(params)))
    train_set.params = merged
    booster = Booster(params=merged, train_set=train_set, device=device)
    valid_names = valid_names or []
    for i, vs in enumerate(valid_sets or []):
        name = valid_names[i] if i < len(valid_names) else f"valid_{i}"
        if vs is train_set:  # lightgbm_tpu/engine.py:64-72
            booster.set_train_data_name(name)
            continue
        if vs.reference is None:
            vs.reference = train_set
        booster.add_valid(vs, name)
    for _ in range(num_boost_round):
        if booster.update():
            break
    return booster
