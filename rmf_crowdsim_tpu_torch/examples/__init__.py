"""The examples of the JAX package's ``examples/``, on the port."""
