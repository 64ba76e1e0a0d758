"""Device operations of the port: the hand-written CUDA kernels beside
their plain PyTorch versions (``csrc/`` holds the sources, ``_build``
builds them), and the coded-computation layer over the pool (GEMM, MDS
and LT codes, gradient codes), which runs plain PyTorch products."""
