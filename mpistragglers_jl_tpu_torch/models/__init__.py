"""Model code of the port: transformer blocks and the mixture of experts,
KV-cache decode (dense and over a mesh), the continuous-batching server
and its page pool, speculative decoding, and gradient-coded training
over the pool (logistic regression and any parameter tree).

The names below load on first use, each from the module the JAX
package's ``models/__init__.py`` names for it.
"""

_HOME = {
    "LogisticRegression": "logreg",
    "CodedSGD": "logreg",
    "TransformerConfig": "transformer",
    "init_params": "transformer",
    "param_specs": "transformer",
    "forward_dense": "transformer",
    "make_forward": "transformer",
    "make_train_step": "transformer",
    "make_optax_train_step": "transformer",
    "shard_params": "transformer",
    "batch_axes": "transformer",
    "data_spec": "transformer",
    "init_cache": "decode",
    "cache_specs": "decode",
    "decode_batch_axes": "decode",
    "shard_cache": "decode",
    "prefill_dense": "decode",
    "decode_step_dense": "decode",
    "decode_step_ring_dense": "decode",
    "generate_dense": "decode",
    "generate_ring_dense": "decode",
    "init_ring_cache": "decode",
    "make_ring_generate": "decode",
    "CodedGradTrainer": "coded_train",
    "transformer_chunk_loss": "coded_train",
    "generate_speculative_dense": "speculative",
    "make_speculative_dense": "speculative",
    "make_speculative": "speculative",
    "ring_from_cache": "decode",
    "Request": "serving",
    "ServingScheduler": "serving",
    "make_serving_scan": "serving",
    "serving_decode_step_dense": "serving",
    "PagePool": "paging",
    "PagePoolExhausted": "paging",
    "prefix_page_digests": "paging",
    "RequestRouter": "router",
    "RoutedRequest": "router",
    "ROUTER_POLICIES": "router",
    "PrefillWorker": "disagg",
    "DecodeReplica": "disagg",
    "MigrationPlanner": "disagg",
    "MigrationTicket": "disagg",
    "MigrationRing": "disagg",
    "MigrationRingReader": "disagg",
    "make_prefill": "decode",
    "make_decode_step": "decode",
    "make_extend": "decode",
    "make_generate": "decode",
    "init_moe_layer": "moe",
    "moe_layer_specs": "moe",
    "switch_route": "moe",
    "switch_route_indices": "moe",
    "moe_ffn_dense": "moe",
    "moe_ffn_sharded": "moe",
}

__all__ = list(_HOME)


def __getattr__(name):
    if name in _HOME:
        import importlib

        mod = importlib.import_module(f".{_HOME[name]}", __name__)
        return getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
