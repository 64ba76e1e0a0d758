"""Device operations of the port: the hand-written CUDA kernels beside
their plain PyTorch versions (``csrc/`` holds the sources, ``_build``
builds them), and the coded-computation layer over the pool (GEMM, MDS,
LT and rateless codes, MatDot and polynomial codes, the hierarchical
two-level code, gradient codes, GF(256) Reed-Solomon), which runs plain
PyTorch products and integer ops."""

from .coded_gemm import CodedGemm, LTCodedGemm
from .coding import MDSCode, nwait_decodable
from .gemm import DistributedGemm, gather_rows
from .gf256_device import DeviceRSGF256, gf256_matmul
from .hierarchical import HierarchicalCodedGemm
from .lt import LTCode, nwait_lt_decodable
from .matdot import MatDotCode, MatDotGemm, MatDotWeightCache
from .outer_code import (
    LTOuter,
    ParityOuter,
    hierarchical_nwait,
    make_outer,
    partition_groups,
)
from .polynomial import PolyCodedGemm, PolynomialCode
from .rateless import RatelessLTGemm

__all__ = [
    "MDSCode",
    "nwait_decodable",
    "DistributedGemm",
    "gather_rows",
    "CodedGemm",
    "LTCode",
    "LTCodedGemm",
    "nwait_lt_decodable",
    "RatelessLTGemm",
    "PolynomialCode",
    "PolyCodedGemm",
    "MatDotCode",
    "MatDotGemm",
    "MatDotWeightCache",
    "DeviceRSGF256",
    "gf256_matmul",
    "HierarchicalCodedGemm",
    "ParityOuter",
    "LTOuter",
    "make_outer",
    "partition_groups",
    "hierarchical_nwait",
]
