"""Request synthesis inputs of the port (copies of the JAX package's
host code)."""
