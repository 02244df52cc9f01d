"""DART: Dropouts meet Multiple Additive Regression Trees.

Counterpart of lightgbm_tpu/models/dart.py (the reference's
src/boosting/dart.hpp:17-196).  Each iteration draws a random subset of
past iterations (numpy RandomState(drop_seed), draw for draw the JAX
package's), drops their trees from the training scores before the
gradients are computed, grows the new trees with shrinkage lr/(1+k)
(lr/(lr+k) in xgboost_dart_mode), then renormalises the dropped trees to
k/(k+1) (k/(k+lr)) of their weight: the training scores get
``f32(keep) * delta`` back, each valid set (which still holds the whole
tree) ``f32(keep - 1) * delta``, and the trees are shrunk by ``keep``.

Every one of those walks is kernel P2 on the card: an iteration with
k > 0 dropped iterations is one launch that subtracts every dropped tree
from the training scores (in the JAX package's ``for i in drops: for c
in range(K)`` order), one that renormalises them and one per valid set,
each over one table of the dropped trees built on the device.  DART adds
no host sync: the draws and the tree weights are host floats.  Drop
indices run over ``range(iter_)`` and index ``models`` from 0, so with
an init model they reach its trees, as the JAX package's do.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..config import Config
from .gbdt import GBDT
from .tree import binned_table


class DART(GBDT):
    """DART boosting (dart.hpp:17)."""

    name = "dart"

    def __init__(self, config: Config, train_set=None, objective=None,
                 device=None):
        super().__init__(config, train_set, objective, device=device)
        self._drop_rng = np.random.RandomState(config.drop_seed)
        self.tree_weight: List[float] = []
        self.sum_weight = 0.0

    def _select_drops(self) -> List[int]:
        """DroppingTrees (dart.hpp:89-133): the iterations to drop."""
        cfg = self.config
        if self._drop_rng.rand() < cfg.skip_drop:
            return []
        drop_rate = cfg.drop_rate
        drops = []
        if not cfg.uniform_drop:
            if self.sum_weight <= 0:
                return []
            inv_avg = len(self.tree_weight) / self.sum_weight
            if cfg.max_drop > 0:
                drop_rate = min(drop_rate,
                                cfg.max_drop * inv_avg / self.sum_weight)
            for i in range(self.iter_):
                if (self._drop_rng.rand()
                        < drop_rate * self.tree_weight[i] * inv_avg):
                    drops.append(i)
        else:
            if cfg.max_drop > 0 and self.iter_ > 0:
                drop_rate = min(drop_rate, cfg.max_drop / float(self.iter_))
            for i in range(self.iter_):
                if self._drop_rng.rand() < drop_rate:
                    drops.append(i)
        return drops

    def train_one_iter(self, grad=None, hess=None) -> bool:
        cfg = self.config
        K = self.num_class
        drops = self._select_drops()
        k = float(len(drops))
        idx = [i * K + c for i in drops for c in range(K)]
        table = None
        if drops:  # the dropped trees out of the training scores
            table = binned_table([self.models[j] for j in idx], self.device)
            self._walk_into(table, 0, -1.0, None)

        # shrinkage for the new trees (dart.hpp:124-132)
        if not cfg.xgboost_dart_mode:
            shrinkage = cfg.learning_rate / (1.0 + k)
        else:
            shrinkage = (cfg.learning_rate if not drops
                         else cfg.learning_rate / (cfg.learning_rate + k))
        saved_lr, self.learning_rate = self.learning_rate, shrinkage
        try:
            stop = super().train_one_iter(grad, hess)
        finally:
            self.learning_rate = saved_lr

        # renormalise the dropped trees (Normalize, dart.hpp:144-183): the
        # training scores get keep * delta back; the valid scores, which
        # still hold the whole tree, (keep - 1) * delta
        keep = (k / (k + 1.0) if not cfg.xgboost_dart_mode
                else k / (k + cfg.learning_rate))
        if drops:
            self._walk_into(table, 0, keep, keep - 1.0)
            for j in idx:
                self.models[j] = self.models[j].shrink(keep)
            self._models_changed()
        if not cfg.uniform_drop and self.tree_weight:
            denom = (k + 1.0) if not cfg.xgboost_dart_mode \
                else (k + cfg.learning_rate)
            for i in drops:
                self.sum_weight -= self.tree_weight[i] * (1.0 / denom)
                self.tree_weight[i] *= keep
        if not cfg.uniform_drop:
            self.tree_weight.append(shrinkage)
            self.sum_weight += shrinkage
        return stop


def create_boosting(config: Config, train_set=None, objective=None,
                    device=None) -> GBDT:
    """Boosting factory (src/boosting/boosting.cpp:30-66)."""
    cls = DART if config.boosting_type == "dart" else GBDT
    return cls(config, train_set, objective, device=device)


def boosting_for_model(model_str: str, config: Config, device=None) -> GBDT:
    """An empty booster of the model text's type, sniffed from its first
    line (boosting.cpp:7-16; the JAX package's basic.py:346-357)."""
    first = model_str.lstrip().splitlines()[0].strip() if model_str else ""
    cls = DART if first == "dart" else GBDT
    return cls(config, device=device)
