"""Host modules of the port: options and config parser, cosmology,
counters, phase timer (copies of the JAX package's jax-free ones)."""
