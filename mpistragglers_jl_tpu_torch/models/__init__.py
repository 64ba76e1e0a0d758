"""Model code of the port: transformer blocks, KV-cache decode, the
continuous-batching server and its page pool."""
