"""The tools of the JAX package's ``tools/``, on the port."""
