"""Jax-free utilities of the port: the counter-based generator
(:mod:`.prng`) and the pool's epoch tracer (:mod:`.trace`)."""
