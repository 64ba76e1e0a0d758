"""Model code of the port: transformer blocks and the mixture of experts,
KV-cache decode, the continuous-batching server and its page pool, and
gradient-coded training over the pool (logistic regression and any
parameter tree)."""
