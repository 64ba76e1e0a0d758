"""Kernels of the port: each hand-written CUDA kernel beside its plain
PyTorch version (``csrc/`` holds the sources, ``_build`` builds them)."""
