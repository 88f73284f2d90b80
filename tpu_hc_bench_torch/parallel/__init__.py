"""Attention reference of the port (the single-device half of the JAX
package's ``parallel.sequence``)."""
