"""The pool over a device mesh, and attention helpers shared by the
model code (``ring_attention.py``).

The port of the JAX package's ``parallel/``: a single-controller mesh
(``mesh.py``), its collectives, the mesh and pool-fused coded GEMMs,
fused K-epoch device windows (``device_coord.py``) and the
multi-process runtime (``multihost.py``). Names load on first use.
"""

_HOME = {
    "make_mesh": "mesh",
    "shard": "mesh",
    "Mesh": "mesh",
    "PartitionSpec": "mesh",
    "ShardedTensor": "mesh",
    "MeshCodedGemm": "mesh_gemm",
    "MeshMatDotGemm": "mesh_gemm",
    "PoolMeshCodedGemm": "fused",
    "PoolMeshMatDotGemm": "fused",
    "select_coded_gemm": "fused",
    "DeviceCoordinator": "device_coord",
    "stage_delays": "device_coord",
    "distributed_mds_decode": "collectives",
    "masked_psum_scatter_combine": "collectives",
    "ring_allgather": "collectives",
    "initialize_multihost": "multihost",
    "make_multihost_mesh": "multihost",
    "local_worker_indices": "multihost",
    "host_groups": "multihost",
}

__all__ = list(_HOME)


def __getattr__(name):
    if name in _HOME:
        import importlib

        mod = importlib.import_module(f".{_HOME[name]}", __name__)
        return getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
