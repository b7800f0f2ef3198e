"""Host-side utilities of the torch port (copies of the JAX package's)."""
