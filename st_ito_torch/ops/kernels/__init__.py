"""Wrappers of the hand-written CUDA kernels, each beside its plain PyTorch
version. Nothing here builds or loads a kernel at import time."""
