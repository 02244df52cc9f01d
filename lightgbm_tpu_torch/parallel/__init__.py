"""Distributed training over a ``torch.distributed`` world.

Counterpart of lightgbm_tpu/parallel/, the replacement for the
reference's network layer (src/network/) and parallel tree learners
(src/treelearner/parallel_tree_learner.h): the JAX package shards over a
device mesh of one process; the port's ranks are processes, one a
device (NCCL) or several sharing one (gloo), or CPU processes (gloo).
The collectives are ``torch.distributed``'s (parallel/mesh.py); each
rank's histograms and searches run the port's kernels on its own rows
or feature block.  The machine-list bootstrap of a world across hosts
(``parallel/multihost``) is ROADMAP A8 step 3.
"""

from .mesh import data_mesh, default_device_count  # noqa: F401
from .data_parallel import make_data_parallel_grower  # noqa: F401
from .feature_parallel import make_feature_parallel_grower  # noqa: F401
from .voting_parallel import make_voting_parallel_grower  # noqa: F401
from .grid_parallel import grid_mesh, make_grid_parallel_grower  # noqa: F401

__all__ = [
    "data_mesh",
    "default_device_count",
    "make_data_parallel_grower",
    "make_feature_parallel_grower",
    "make_voting_parallel_grower",
    "grid_mesh",
    "make_grid_parallel_grower",
]
