"""lightgbm_tpu_torch: the PyTorch/CUDA port of lightgbm_tpu.

A second package beside the JAX one (which stays the reference).  It
imports torch and never jax, nor anything of lightgbm_tpu.  Entry points
run on the CUDA card unless the caller passes ``device="cpu"``; on the
card the leaf-wise learner's histogram and split search run as the
hand-written kernels in ``csrc/`` (built with nvcc at first use).  Data
comes as matrices, scipy sparse matrices or text files (CSV, TSV,
LibSVM; ``python -m lightgbm_tpu_torch config=train.conf`` is the CLI);
neither pandas nor scikit-learn is needed.
"""

from . import callback, sklearn
from .backend import resolve_device
from .basic import Booster, Dataset, LightGBMError
from .callback import (EarlyStopException, early_stopping, print_evaluation,
                       record_evaluation, reset_parameter)
from .config import Config
from .engine import CVBooster, cv, train, train_many
from .sklearn import LGBMClassifier, LGBMModel, LGBMRanker, LGBMRegressor

__all__ = ["Booster", "CVBooster", "Config", "Dataset", "EarlyStopException",
           "LGBMClassifier", "LGBMModel", "LGBMRanker", "LGBMRegressor",
           "LightGBMError", "callback", "cv", "early_stopping",
           "print_evaluation", "record_evaluation", "reset_parameter",
           "resolve_device", "sklearn", "train", "train_many"]
