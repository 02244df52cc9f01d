"""lightgbm_tpu_torch: the PyTorch/CUDA port of lightgbm_tpu.

A second package beside the JAX one (which stays the reference).  It
imports torch and never jax, nor anything of lightgbm_tpu.  Entry points
run on the CUDA card unless the caller passes ``device="cpu"``; on the
card the leaf-wise learner's histogram and split search run as the
hand-written kernels in ``csrc/`` (built with nvcc at first use).
"""

from .backend import resolve_device
from .basic import Booster, Dataset, LightGBMError
from .config import Config
from .engine import train

__all__ = ["Booster", "Config", "Dataset", "LightGBMError", "resolve_device",
           "train"]
