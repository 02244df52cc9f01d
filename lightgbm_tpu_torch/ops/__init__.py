"""Histogram and split-search ops: the CUDA kernels and their plain PyTorch versions."""
