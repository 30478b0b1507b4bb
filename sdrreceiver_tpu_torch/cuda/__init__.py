"""Wrappers around the hand-written CUDA kernels in ``csrc/``, each beside
its plain PyTorch version, and their nvcc build."""
