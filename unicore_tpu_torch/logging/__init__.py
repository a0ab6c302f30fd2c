"""Metrics and meters of the port's training loop (pure Python, copied
from the JAX package)."""
