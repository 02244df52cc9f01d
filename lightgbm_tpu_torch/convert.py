"""Carry trained state across from the JAX package.

Two routes:

* the reference text model format, which both packages read and write
  (``Booster.model_to_string`` / ``Booster(model_str=...)``);
* ``trees_from_numpy``: the JAX ``Tree`` fields as numpy arrays, one dict
  per tree (``jax.tree.map(np.asarray, tree)._asdict()`` on the JAX
  side), into the port's ``Tree`` objects and a Booster that predicts
  with them.  This module imports nothing of the JAX package; the
  caller does the conversion to numpy.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .backend import resolve_device
from .basic import Booster
from .config import Config
from .models.gbdt import GBDT
from .models.tree import TREE_FIELDS, Tree, _INT_FIELDS


def tree_from_numpy(d: Dict[str, np.ndarray], device) -> Tree:
    """One tree from its numpy field dict (``num_leaves`` + the 14
    per-node/per-leaf arrays)."""
    fields = {}
    for k in TREE_FIELDS:
        dt = torch.int32 if k in _INT_FIELDS else torch.float32
        fields[k] = torch.tensor(np.asarray(d[k]), dtype=dt, device=device)
    return Tree(num_leaves=int(np.asarray(d["num_leaves"])), **fields)


def trees_from_numpy(trees: Sequence[Dict[str, np.ndarray]], device=None,
                     objective: str = "binary", sigmoid: float = 1.0,
                     max_feature_idx: Optional[int] = None,
                     feature_names: Optional[List[str]] = None,
                     num_class: int = 1) -> Tuple[List[Tree], Booster]:
    """The port's Trees and a prediction-mode Booster over them.

    ``trees`` is the JAX package's ``models`` list, iteration-major for
    ``num_class`` > 1 (tree i*K + k is class k's).  ``max_feature_idx``
    defaults to the largest real split feature."""
    dev = resolve_device(device)
    out = [tree_from_numpy(d, dev) for d in trees]
    gb = GBDT(Config(objective=objective, sigmoid=sigmoid,
                     num_class=num_class), device=dev)
    gb.models = list(out)
    gb._models_changed()
    gb.sigmoid = float(sigmoid)
    gb._loaded_objective = objective
    if max_feature_idx is None:
        max_feature_idx = max(
            [int(np.max(np.asarray(d["split_feature_real"]), initial=-1))
             for d in trees] + [0])
    gb.max_feature_idx = int(max_feature_idx)
    gb.feature_names = list(feature_names or [])
    return out, Booster.from_gbdt(gb)
