"""Plain float32 references of the benchmark's configurations, one module a
configuration, and what they share (``common``). They import nothing of
the port, of ``jax`` or of the JAX package."""
