"""The port's ops: the CUDA kernels, their wrappers and their plain PyTorch
versions (histogram, split search and the pooled split step, the packed
record's partition and write-back, the mega route's split step, the level
histogram of depthwise growth, dense and sparse (kernel S1), ensemble
prediction (P1), the binned ensemble walk of training (P2), and the
float64 histograms and search of hist_dtype=float64 (K1-f64, K1''-f64,
K3-f64 in its root and step forms))."""

import importlib
from typing import Dict

# each ported kernel's launch count: (module under ops/, counter name)
KERNEL_COUNTERS = {
    "K1": ("cuda_histogram", "LAUNCHES"),
    "K1'": ("cuda_histogram", "RECORD_LAUNCHES"),
    "K3": ("cuda_search", "LAUNCHES"),
    "K4": ("cuda_search", "UPDATE_LAUNCHES"),
    "K5": ("cuda_search", "POOL_LAUNCHES"),
    "K6": ("cuda_record", "COMPACT_LAUNCHES"),
    "K7": ("cuda_record", "PLACE_LAUNCHES"),
    "K8": ("cuda_split_step", "LAUNCHES"),
    "K1″": ("cuda_histogram", "LEVEL_LAUNCHES"),
    "K2": ("cuda_histogram", "BSUB_LAUNCHES"),
    "K9": ("cuda_record", "WRITE_LAUNCHES"),
    "P1": ("cuda_predict", "LAUNCHES"),
    "S1": ("cuda_sparse_hist", "LAUNCHES"),
    "P2": ("cuda_predict_binned", "LAUNCHES"),
    "K1-f64": ("cuda_histogram", "F64_LAUNCHES"),
    "K1″-f64": ("cuda_histogram", "LEVEL_F64_LAUNCHES"),
    "K3-f64": ("cuda_search", "F64_LAUNCHES"),
    "K3-f64 step": ("cuda_search", "F64_STEP_LAUNCHES"),
}


def _counter(name):
    mod, attr = KERNEL_COUNTERS[name]
    return importlib.import_module(f"{__name__}.{mod}"), attr


def launch_counts() -> Dict[str, int]:
    """Launches of each kernel since the last ``reset_launch_counts``."""
    return {name: getattr(*_counter(name)) for name in KERNEL_COUNTERS}


def reset_launch_counts() -> None:
    for name in KERNEL_COUNTERS:
        setattr(*_counter(name), 0)
