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
scheduler, the coded GEMM and the coded trainer; and the host backends
(``backends/process.py``, ``backends/native.py`` over the C++ transport
in ``native/``), the worker CLI (``worker.py``) and the launcher
(``launch.py``), whose worker processes may compute on the card; training
and erasure-coded checkpoints (``utils/train_checkpoint.py``,
``utils/coded_checkpoint.py``), the virtual-time pool simulator
(``sim/``) and multi-tenant QoS admission (``qos/``) on the scheduler. Entry
points default to the GPU and raise
when there is none unless the caller passes ``device="cpu"`` (or
``devices=[torch.device("cpu")]``), where every kernel wrapper runs its
plain PyTorch version.
"""

__version__ = "0.1.0"

# name -> module that defines it. Imported on first use (PEP 562), so
# ``import mpistragglers_jl_tpu_torch`` and the host-only modules a
# spawned worker loads (``worker``, ``native``, ``backends.process``,
# ``backends.native``, ``obs``) import no torch: a worker pays for
# torch only when its ``work_fn`` computes with it.
_LAZY = {
    "AsyncPool": ".pool",
    "asyncmap": ".pool",
    "asyncmap_fused": ".pool",
    "waitall": ".pool",
    "DeadWorkerError": ".backends.base",
    "WorkerFailure": ".backends.base",
    "LocalBackend": ".backends.local",
    "CUDADeviceBackend": ".backends.cuda",
    "ProcessBackend": ".backends.process",
    "RemoteWorkerError": ".backends.process",
    "WorkerProcessDied": ".backends.process",
    "NativeProcessBackend": ".backends.native",
    "DistributedGemm": ".ops.gemm",
    "gather_rows": ".ops.gemm",
    "MDSCode": ".ops.coding",
    "CodedGemm": ".ops.coded_gemm",
    "LTCodedGemm": ".ops.coded_gemm",
    "CodedSGD": ".models.logreg",
    "SimBackend": ".sim",
    "VirtualClock": ".sim",
}

__all__ = list(_LAZY)


def __getattr__(name):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}")
    import importlib

    value = getattr(importlib.import_module(mod, __name__), name)
    globals()[name] = value
    return value
