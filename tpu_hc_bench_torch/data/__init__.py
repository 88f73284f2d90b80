"""Inputs of the port (copies of the JAX package's host code): prompt
synthesis for serving, synthetic image and token batches for
training."""
