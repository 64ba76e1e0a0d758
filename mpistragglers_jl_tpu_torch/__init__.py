"""PyTorch/CUDA port of ``mpistragglers_jl_tpu``, slice by slice.

The JAX package beside this one is the reference; every module here
keeps the name of its counterpart there so the pair is easy to find,
and the tests run both on the same numpy inputs. This package imports
``torch`` and never ``jax`` or ``mpistragglers_jl_tpu``: what it needs
from the reference is copied, not imported.

Slices 1 and 2 are the int8 continuous-batching server:
``models/serving.py`` ``ServingScheduler`` over the slot-ring cache or
the paged cache (``models/paging.py``: shared prefix pages,
copy-on-write), whose decode attention runs as hand-written CUDA
kernels (``ops/decode_attention.py``, ``ops/csrc/decode_attention.cu``). Entry points default to the GPU and
raise when there is none unless the caller passes ``device="cpu"``,
where every kernel wrapper runs its plain PyTorch version.
"""

__version__ = "0.1.0"
