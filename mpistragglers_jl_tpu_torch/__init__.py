"""PyTorch/CUDA port of ``mpistragglers_jl_tpu``, slice by slice.

The JAX package beside this one is the reference; every module here
keeps the name of its counterpart there so the pair is easy to find,
and the tests run both on the same numpy inputs. This package imports
``torch`` and never ``jax`` or ``mpistragglers_jl_tpu``: what it needs
from the reference is copied, not imported.

The paper's own main path: the fastest-k pool (``pool.py``) over CUDA
streams (``backends/cuda.py``) or thread workers (``backends/local.py``),
and the workloads built on it — uncoded, MDS-coded and LT-coded GEMM
(``ops/gemm.py``, ``ops/coded_gemm.py``) and gradient-coded SGD
(``models/logreg.py``). Beside it: the int8 continuous-batching server
(``models/serving.py``), training and long-context generation over
hand-written CUDA kernels (``ops/decode_attention.py``,
``ops/flash_attention.py``), greedy or sampled (``utils/prng.py``,
bit-equal to ``jax.random``, and the fused ``ops/sampling.py``), and
the opt-in observability plane (``obs/``, ``utils/trace.py``) on the
scheduler, the coded GEMM and the coded trainer. Entry points default to the GPU and raise
when there is none unless the caller passes ``device="cpu"`` (or
``devices=[torch.device("cpu")]``), where every kernel wrapper runs its
plain PyTorch version.
"""

from .backends import CUDADeviceBackend, LocalBackend, WorkerFailure
from .models.logreg import CodedSGD
from .ops.coded_gemm import CodedGemm, LTCodedGemm
from .ops.coding import MDSCode
from .ops.gemm import DistributedGemm, gather_rows
from .pool import AsyncPool, DeadWorkerError, asyncmap, asyncmap_fused, waitall

__version__ = "0.1.0"

__all__ = [
    "AsyncPool",
    "asyncmap",
    "asyncmap_fused",
    "waitall",
    "DeadWorkerError",
    "CUDADeviceBackend",
    "LocalBackend",
    "WorkerFailure",
    "DistributedGemm",
    "gather_rows",
    "MDSCode",
    "CodedGemm",
    "LTCodedGemm",
    "CodedSGD",
]
